"""Command-line entry point of the port: the ``train`` and ``infer``
commands of ``python -m stylesinger_tpu.run``.

    python -m stylesinger_torch.run train [--recipe stylesinger] \\
        [--hparams 'binary_data_dir=data/binary/style,max_updates=1000'] \\
        [--exp_name stylesinger] [--work_dir_root checkpoints] [--device cuda]
    python -m stylesinger_torch.run infer --ref_audio ref.wav --allow_random \\
        [--recipe stylesinger] [--hparams 'f0_speedup=5,dpm_steps=10'] \\
        [--out infer_out/test.wav] [--device cuda]

The config is the defaults, the recipe ``--recipe`` of ``egs/`` (``RECIPES``
in ``config.py``) and the ``--hparams`` overrides, in that order.

``train`` trains the acoustic model on the binarized corpus in
``binary_data_dir`` (its ``phone_set.json`` and the train and valid
shards) into ``<work_dir_root>/<exp_name>``, where it writes
``config.json``, ``metrics.jsonl`` and the checkpoints, and from whose
latest checkpoint it resumes.

``infer`` sings the JAX package's example phrase (``inference.py::
example_run``) in the style of the reference clip ``--ref_audio`` and writes
the wav.  It does not load a checkpoint yet, so, as the JAX command does
without one, it refuses to synthesize from random weights unless
``--allow_random`` is given; the weights are then seeded from the config's
``seed``.

Both run on ``--device`` (``cuda`` by default, which raises when there is
no GPU).  The other commands of the JAX CLI (preprocess, binarize, test)
wait for their slices.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

EXAMPLE = {
    "text": "小酒窝长睫毛AP是你最美的记号",
    "ph": "x iao j iu w o ch ang j ie m ao AP sh i n i z ui m ei d e j i h ao",
    "notes": [68, 68, 68, 68, 69, 69, 71, 71, 71, 71, 69, 69, 0, 68, 68,
              66, 66, 68, 68, 69, 69, 68, 68, 66, 66, 64, 64],
    "notes_duration": [0.23, 0.23, 0.23, 0.23, 0.68, 0.68, 0.46, 0.46,
                       0.23, 0.23, 0.81, 0.81, 0.23, 0.23, 0.23, 0.23,
                       0.23, 0.23, 0.23, 0.46, 0.46, 0.23, 0.23, 0.23,
                       0.23, 0.58, 0.58],
    "note_types": [2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 2, 2, 2, 2, 2,
                   2, 2, 2, 2, 2, 2, 2, 2, 2],
}


def example_run(cfg, ref_audio: str, out_path: str = "infer_out/test.wav",
                allow_random: bool = False, device: str = "cuda") -> str:
    """Synthesize :data:`EXAMPLE` in the style of ``ref_audio`` and write
    it to ``out_path``; refuses random weights unless ``allow_random``."""
    from stylesinger_torch.dsp.mel import save_wav
    from stylesinger_torch.inference import StyleSingerInfer

    if not allow_random:
        raise FileNotFoundError(
            "the port cannot load a checkpoint yet; refusing to synthesize "
            "the demo from random weights (pass allow_random=True / "
            "--allow_random)")
    if not os.path.isfile(ref_audio):
        raise FileNotFoundError(f"reference clip {ref_audio} not found")
    infer = StyleSingerInfer(cfg, device=device)
    infer.init_random()
    wav = infer.infer_once(dict(EXAMPLE, ref_audio=ref_audio))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    save_wav(wav, out_path, cfg["audio_sample_rate"])
    return out_path


def train(cfg, work_dir: str, device: str = "cuda"):
    """``run.py train``: the binarized corpus of ``cfg["binary_data_dir"]``
    through :meth:`Trainer.fit`; returns the final train state."""
    from stylesinger_torch.data.batching import BucketBatcher, EpochBatches
    from stylesinger_torch.data.dataset import StyleSingerDataset
    from stylesinger_torch.models.stylesinger import StyleSinger
    from stylesinger_torch.text import build_token_encoder
    from stylesinger_torch.training.trainer import Trainer

    os.makedirs(work_dir, exist_ok=True)
    with open(os.path.join(work_dir, "config.json"), "w") as f:
        json.dump(cfg, f, indent=1, sort_keys=True)
    with open(os.path.join(cfg["binary_data_dir"], "phone_set.json")) as f:
        encoder = build_token_encoder(json.load(f))
    model = StyleSinger(cfg, len(encoder))
    train_ds = StyleSingerDataset(cfg, cfg["train_set_name"])
    valid_ds = StyleSingerDataset(cfg, cfg["valid_set_name"])
    trainer = Trainer(model, cfg, work_dir, device=device)

    def valid_batches():
        return BucketBatcher(valid_ds, cfg, shuffle=False,
                             max_tokens=cfg["max_valid_tokens"],
                             max_sentences=cfg["max_valid_sentences"]
                             ).batches(0)

    return trainer.fit(EpochBatches(train_ds, cfg), valid_batches)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser("stylesinger_torch")
    ap.add_argument("command", choices=["train", "infer"])
    ap.add_argument("--recipe", default=None,
                    help="a recipe of egs/ (config.py RECIPES), e.g. "
                    "stylesinger")
    ap.add_argument("--hparams", default="",
                    help="'a=1,b=2' overrides, as the JAX CLI takes them")
    ap.add_argument("--exp_name", default="stylesinger")
    ap.add_argument("--work_dir_root", default="checkpoints")
    ap.add_argument("--ref_audio", default=None,
                    help="infer: the reference clip (WAV) whose style is "
                    "sung")
    ap.add_argument("--out", default="infer_out/test.wav")
    ap.add_argument("--allow_random", action="store_true",
                    help="synthesize from seeded random weights (the port "
                    "cannot load a checkpoint yet)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises when absent) or cpu")
    args = ap.parse_args(argv)

    from stylesinger_torch.config import load_config, parse_hparams

    cfg = load_config(args.recipe, **parse_hparams(args.hparams))
    if args.command == "train":
        work_dir = os.path.join(args.work_dir_root, args.exp_name)
        state = train(cfg, work_dir, device=args.device)
        print(f"| trained to step {state.step}; checkpoints in {work_dir}")
        return 0
    if args.ref_audio is None:
        ap.error("infer needs --ref_audio")
    try:
        out = example_run(cfg, args.ref_audio, out_path=args.out,
                          allow_random=args.allow_random, device=args.device)
    except FileNotFoundError as e:
        print(f"| ERROR: {e}", file=sys.stderr)
        return 2
    print(f"| wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
