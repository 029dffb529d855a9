"""Command-line entry point of the port: the commands of ``python -m
stylesinger_tpu.run``.

    python -m stylesinger_torch.run preprocess [--recipe stylesinger] \\
        [--hparams 'raw_data_dir=raw,processed_data_dir=data/processed/x'] \\
        [--mfa]
    python -m stylesinger_torch.run mfa-align [--hparams ...]
    python -m stylesinger_torch.run binarize [--recipe stylesinger] \\
        [--hparams 'processed_data_dir=...,binary_data_dir=...'] \\
        [--device cuda]
    python -m stylesinger_torch.run train [--config egs/stylesinger.yaml] \\
        [--hparams 'binary_data_dir=data/binary/style,max_updates=1000'] \\
        [--exp_name stylesinger] [--work_dir_root checkpoints] \\
        [--device cuda] [--supervise]
    torchrun --nproc_per_node N -m stylesinger_torch.run train \\
        --config egs/stylesinger.yaml [...]
    python -m stylesinger_torch.run infer --ref_audio ref.wav \\
        [--exp_name stylesinger] [--work_dir_root checkpoints] \\
        [--allow_random] [--recipe stylesinger] \\
        [--hparams 'f0_speedup=5,dpm_steps=10'] [--out infer_out/test.wav]
    python -m stylesinger_torch.run test [--exp_name stylesinger] \\
        [--hparams 'binary_data_dir=data/binary/style,test_ids=[0,2]']

The config is the defaults, the YAML recipe file ``--config`` with its
``base_config`` chain (``--recipe NAME`` is ``--config egs/NAME.yaml``),
and the ``--hparams`` overrides (dotted keys reach nested maps), in that
order; its ``work_dir`` is
``<work_dir_root>/<exp_name>``.

``preprocess`` turns a raw corpus into ``<processed_data_dir>/
metadata.json`` and ``phone_set.json``: its rows come from the meta adapter
``pre_align_cls`` names (``lj``, ``emotion``, ``libritts``, ``vctk``) over
``raw_data_dir``, or from ``<raw_data_dir>/metadata.json`` (default: the
processed dir's), and the text processor of ``language`` gives the phones
of rows that have none.  ``--mfa`` also lays out the Montreal Forced
Aligner corpus; ``mfa-align`` runs ``mfa train`` on it, and refuses with a
message when ``mfa`` is not installed.

``binarize`` writes the training shards of ``processed_data_dir`` into
``binary_data_dir`` with the class ``binarizer_cls`` names
(``data/binarize.py``; the JAX package's name resolves to the port's
class): the log-mel through the mel kernel, the F0 tracker and the two GE2E
encoders run on ``--device``.

``train`` trains the acoustic model on the binarized corpus in
``binary_data_dir`` (its ``phone_set.json`` and the train and valid
shards) into the work dir, where it writes ``config.yaml``,
``metrics.jsonl`` and the checkpoints, and from whose latest checkpoint it
resumes.  When the host-RSS watchdog (``max_host_rss_gb``) trips, the
trainer checkpoints and ``train`` exits with :data:`RESTART_EXIT_CODE`
(75); ``--supervise`` runs ``train`` in a child process and restarts it
while it exits so, each restart resuming from the checkpoint.  Started
by ``torchrun`` (its ``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT``), it trains data
parallel, one process per GPU (``parallel/mesh.py``): each rank takes its
share of each epoch's batches, a step is one step on the ranks' batches
together, and rank 0 writes the work dir.

``infer`` sings the JAX package's example phrase (``inference.py::
example_run``) in the style of the reference clip ``--ref_audio`` with the
work dir's latest checkpoint, and writes the wav.  Without a checkpoint it
refuses to synthesize from random weights unless ``--allow_random`` is
given; the weights are then seeded from the config's ``seed``.  The phone
set is ``<binary_data_dir>/phone_set.json``, as in training; the vocoder
and the d-vector encoders load from ``vocoder_ckpt``,
``speaker_encoder_path`` and ``emotion_encoder_path``.

``test`` synthesizes the ``test_set_name`` split (the items ``test_ids``
names, or all of them) with the work dir's latest checkpoint through
``training/test_runner.py::TestRunner`` and the ``vocoder`` wrapper, into
``<work_dir>/generated_<step>/``; ``python -m
stylesinger_torch.eval.evaluate_gen`` scores that directory.

``binarize``, ``train``, ``infer`` and ``test`` run on ``--device``
(``cuda`` by default, which raises when there is no GPU); ``preprocess``
and ``mfa-align`` are host work.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

# the exit status of "checkpointed and restartable" (EX_TEMPFAIL): the
# host-RSS watchdog's (training/trainer.py::HostMemoryExceeded)
RESTART_EXIT_CODE = 75
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


def supervise(cmd: list, max_restarts: int = 100) -> int:
    """Run ``cmd`` as a subprocess, restarting it while it exits with
    :data:`RESTART_EXIT_CODE`; returns the last exit status.  With the
    trainer's resume from the latest checkpoint this makes the watchdog's
    exit a restart with bounded host memory."""
    import subprocess

    for i in range(max_restarts):
        code = subprocess.call(cmd)
        if code != RESTART_EXIT_CODE:
            return code
        print(f"| supervise: restart {i + 1} (exit {code}: watchdog "
              "checkpointed; resuming)")
    print(f"| supervise: giving up after {max_restarts} restarts")
    return RESTART_EXIT_CODE


def example_run(cfg, ref_audio: str, out_path: str = "infer_out/test.wav",
                allow_random: bool = False, device: str = "cuda") -> str:
    """Synthesize :data:`EXAMPLE` in the style of ``ref_audio`` and write
    it to ``out_path``.  Loads the latest checkpoint of ``cfg['work_dir']``
    when it has a ``ckpt/`` directory (raising when that holds no step);
    refuses random weights unless ``allow_random``."""
    from stylesinger_torch.dsp.mel import save_wav
    from stylesinger_torch.inference import StyleSingerInfer

    work_dir = cfg.get("work_dir") or ""
    has_ckpt = os.path.isdir(os.path.join(work_dir, "ckpt"))
    if not (has_ckpt or allow_random):
        raise FileNotFoundError(
            f"no checkpoint under {work_dir or '<unset work_dir>'}/ckpt; "
            "refusing to synthesize the demo from random weights (train "
            "first, or pass allow_random=True / --allow_random)")
    if not os.path.isfile(ref_audio):
        raise FileNotFoundError(f"reference clip {ref_audio} not found")
    infer = StyleSingerInfer(cfg, device=device)
    if has_ckpt:
        infer.load_params(work_dir)
    else:
        infer.init_random()
    wav = infer.infer_once(dict(EXAMPLE, ref_audio=ref_audio))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    save_wav(wav, out_path, cfg["audio_sample_rate"])
    return out_path


def train(cfg, work_dir: str, device: str = "cuda"):
    """``run.py train``: the binarized corpus of ``cfg["binary_data_dir"]``
    through :meth:`Trainer.fit`, data parallel under torchrun; returns the
    final train state."""
    from stylesinger_torch.config import save_config
    from stylesinger_torch.data.batching import BucketBatcher, EpochBatches
    from stylesinger_torch.data.dataset import StyleSingerDataset
    from stylesinger_torch.models.stylesinger import StyleSinger
    from stylesinger_torch.parallel import mesh
    from stylesinger_torch.text import build_token_encoder
    from stylesinger_torch.training.trainer import Trainer

    mesh.init_distributed(device)
    if mesh.rank() == 0:
        save_config(cfg, work_dir)
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

    return trainer.fit(EpochBatches(train_ds, cfg, rank=mesh.data_rank(),
                                    world_size=mesh.data_size()),
                       valid_batches)


def test(cfg, work_dir: str, device: str = "cuda") -> str:
    """``run.py test``: the ``test_set_name`` split through
    :class:`TestRunner` with the work dir's latest checkpoint; returns the
    generation directory ``<work_dir>/generated_<step>``.  Raises
    ``FileNotFoundError`` when the work dir holds no checkpoint."""
    from stylesinger_torch.data.batching import BucketBatcher
    from stylesinger_torch.data.dataset import StyleSingerDataset
    from stylesinger_torch.inference import resolve_device
    from stylesinger_torch.models.stylesinger import StyleSinger
    from stylesinger_torch.text import build_token_encoder
    from stylesinger_torch.training.checkpoint import (
        latest_checkpoint, load_payload,
    )
    from stylesinger_torch.training.test_runner import TestRunner
    from stylesinger_torch.vocoder_infer import get_vocoder_cls

    latest = latest_checkpoint(work_dir)
    if latest is None:
        raise FileNotFoundError(
            f"no checkpoint under {work_dir}/ckpt; refusing to synthesize "
            "test artifacts from random weights (train first with run.py "
            "train, or point --work_dir_root / --exp_name at a trained "
            "experiment)")
    step, path = latest
    device = resolve_device(device)
    with open(os.path.join(cfg["binary_data_dir"], "phone_set.json")) as f:
        encoder = build_token_encoder(json.load(f))
    model = StyleSinger(cfg, len(encoder)).to(device)
    model.load_state_dict(load_payload(path, device)["model"])
    print(f"| restored checkpoint step {step}")
    test_ds = StyleSingerDataset(cfg, cfg["test_set_name"])
    batches = BucketBatcher(test_ds, cfg, shuffle=False,
                            max_tokens=cfg["max_valid_tokens"],
                            max_sentences=cfg["max_valid_sentences"]
                            ).batches(0)
    vocoder = get_vocoder_cls(cfg)(cfg, device=device)
    runner = TestRunner(model, cfg, vocoder, work_dir,
                        gen_dir_name=str(step))
    return runner.run(batches)


def preprocess(cfg, mfa: bool = False) -> list:
    """``run.py preprocess``: the raw rows (a meta adapter's, or
    ``metadata.json``'s) through :class:`Preprocessor` into
    ``processed_data_dir``; with ``mfa`` also the MFA corpus.  Returns the
    processed rows."""
    from stylesinger_torch.data.preprocess import Preprocessor, load_meta_data

    raw_dir = cfg.get("raw_data_dir") or cfg["processed_data_dir"]
    adapter = cfg.get("pre_align_cls", "")
    if adapter:
        items = load_meta_data(adapter, raw_dir)
    else:
        meta_fn = os.path.join(raw_dir, "metadata.json")
        if not os.path.exists(meta_fn):
            raise SystemExit(
                f"| ERROR: no meta adapter (cfg pre_align_cls) and no "
                f"{meta_fn}; nothing to preprocess")
        with open(meta_fn) as f:
            items = json.load(f)
    pre = Preprocessor(cfg, language=cfg.get("language", "zh"))
    rows = pre.process(items, out_dir=cfg["processed_data_dir"])
    if mfa:
        mfa_dir = pre.build_mfa_inputs(rows,
                                       out_dir=cfg["processed_data_dir"])
        print(f"| wrote MFA corpus at {mfa_dir}")
    return rows


def mfa_align(cfg) -> str:
    """``run.py mfa-align``: Montreal Forced Aligner's ``mfa train`` over
    the corpus ``preprocess --mfa`` laid out; returns the TextGrid
    directory.  Exits with a message when the corpus or ``mfa`` is
    missing, as the JAX CLI does."""
    import shutil
    import subprocess

    out_dir = cfg["processed_data_dir"]
    mfa_dir = os.path.join(out_dir, "mfa_inputs")
    dict_fn = os.path.join(out_dir, "mfa_dict.txt")
    tg_dir = os.path.join(out_dir, "mfa_outputs")
    if not (os.path.isdir(mfa_dir) and os.path.exists(dict_fn)):
        raise SystemExit(
            f"| ERROR: no MFA corpus at {mfa_dir} — run "
            "`run.py preprocess --mfa` first")
    mfa_bin = shutil.which("mfa")
    if mfa_bin is None:
        raise SystemExit(
            "| ERROR: Montreal Forced Aligner (`mfa`) is not installed "
            "in this environment. Install it (conda install -c "
            "conda-forge montreal-forced-aligner), then rerun; the "
            "corpus layout + dictionary are ready at "
            f"{mfa_dir} / {dict_fn}")
    n_jobs = int(os.getenv("N_PROC", os.cpu_count() or 1))
    cmd = [mfa_bin, "train", "--clean", "-j", str(n_jobs), mfa_dir, dict_fn,
           tg_dir]
    print("| running:", " ".join(cmd))
    subprocess.check_call(cmd)
    print(f"| wrote TextGrids at {tg_dir}")
    return tg_dir


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser("stylesinger_torch")
    ap.add_argument("command", choices=["train", "binarize", "infer",
                                        "test", "preprocess", "mfa-align"])
    ap.add_argument("--recipe", default=None,
                    help="NAME: --config egs/NAME.yaml, e.g. stylesinger")
    ap.add_argument("--config", default=None,
                    help="a YAML recipe file, e.g. egs/stylesinger.yaml "
                    "(its base_config chain included)")
    ap.add_argument("--hparams", default="",
                    help="'a=1,b=2' overrides, as the JAX CLI takes them")
    ap.add_argument("--exp_name", default="stylesinger")
    ap.add_argument("--work_dir_root", default="checkpoints")
    ap.add_argument("--ref_audio", default=None,
                    help="infer: the reference clip (WAV) whose style is "
                    "sung")
    ap.add_argument("--out", default="infer_out/test.wav")
    ap.add_argument("--allow_random", action="store_true",
                    help="infer only: permit the demo from seeded random "
                    "weights when the work dir has no checkpoint")
    ap.add_argument("--mfa", action="store_true",
                    help="preprocess only: also lay out the MFA alignment "
                    "corpus")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises when absent) or cpu")
    ap.add_argument("--supervise", action="store_true",
                    help="train only: restart and resume when the host-RSS "
                    "watchdog checkpoints and exits (code 75)")
    args = ap.parse_args(argv)
    if args.supervise and args.command == "train":
        argv = sys.argv[1:] if argv is None else list(argv)
        return supervise([sys.executable, "-m", "stylesinger_torch.run"] +
                         [a for a in argv if a != "--supervise"])

    from stylesinger_torch.config import load_config

    cfg = load_config(args.config, args.hparams, recipe=args.recipe)
    work_dir = os.path.join(args.work_dir_root, args.exp_name)
    cfg["work_dir"] = work_dir
    if args.command == "preprocess":
        preprocess(cfg, mfa=args.mfa)
        return 0
    if args.command == "mfa-align":
        mfa_align(cfg)
        return 0
    if args.command == "binarize":
        from stylesinger_torch.data.binarize import binarize

        binarize(cfg, device=args.device)
        print(f"| wrote {cfg['binary_data_dir']}")
        return 0
    if args.command == "train":
        from stylesinger_torch.training.trainer import HostMemoryExceeded

        try:
            state = train(cfg, work_dir, device=args.device)
        except HostMemoryExceeded as e:
            print(f"| {e}")
            print("| host-RSS watchdog checkpointed and is exiting 75 "
                  "(restartable, NOT a crash) — rerun with --supervise to "
                  "restart-and-resume automatically")
            return RESTART_EXIT_CODE
        print(f"| trained to step {state.step}; checkpoints in {work_dir}")
        return 0
    if args.command == "infer" and args.ref_audio is None:
        ap.error("infer needs --ref_audio")
    try:
        if args.command == "test":
            out = test(cfg, work_dir, device=args.device)
        else:
            out = example_run(cfg, args.ref_audio, out_path=args.out,
                              allow_random=args.allow_random,
                              device=args.device)
    except FileNotFoundError as e:
        print(f"| ERROR: {e}", file=sys.stderr)
        return 2
    print(f"| wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
