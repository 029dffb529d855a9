"""Test-split synthesis (port of ``stylesinger_tpu/training/test_runner.py``).

:meth:`TestRunner.run` runs the acoustic model in inference mode over the
test batches, vocodes each generated mel (and, with ``save_gt``, the
ground-truth mel with its own F0), and writes ``<gen_dir>/wavs/
item_XXXX{,_gt}.wav``, ``result_f0s.npy`` and ``meta.csv``, as the JAX
runner does: items that get no frames are skipped, and so are a batch's
padding rows past ``nsamples``.
"""

from __future__ import annotations

import csv
import os
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from stylesinger_torch.dsp.mel import save_wav
from stylesinger_torch.dsp.pitch import denorm_f0
from stylesinger_torch.models.diffusion import Noise
from stylesinger_torch.training.step import batch_to_device


def batch_noise(seed: int, idx: int, device: Any) -> Noise:
    """The noise source of the batch whose first item is written as item
    ``idx`` (JAX: ``fold_in(PRNGKey(seed), idx)``)."""
    return Noise(int(np.random.SeedSequence([seed, idx]).generate_state(
        1, np.uint64)[0]), device)


class TestRunner:
    __test__ = False  # not a pytest class

    def __init__(self, model: torch.nn.Module, cfg: Any, vocoder,
                 work_dir: str, gen_dir_name: str = ""):
        self.model = model
        self.cfg = cfg
        self.vocoder = vocoder
        self.gen_dir = os.path.join(
            work_dir, f"generated_{gen_dir_name}" if gen_dir_name
            else "generated")
        os.makedirs(os.path.join(self.gen_dir, "wavs"), exist_ok=True)

    @torch.no_grad()
    def run(self, batches: Iterable[Dict], seed: Optional[int] = None,
            noise: Optional[Callable[[int], Any]] = None) -> str:
        """Synthesize every test batch; returns the generation dir.  The
        model draws from ``noise(idx)``, by default :func:`batch_noise` of
        ``seed`` (the config's by default)."""
        c = self.cfg
        seed = c["seed"] if seed is None else seed
        device = next(self.model.parameters()).device
        self.model.eval()
        rows, f0s = [], []
        idx = 0
        for batch in batches:
            tb = batch_to_device(batch, device)
            src = noise(idx) if noise is not None else batch_noise(
                seed, idx, device)
            ret = self.model(
                tb["txt_tokens"], tb["spk_embed"], tb.get("emo_embed"),
                tb["mels"], tb["f0"], tb["notes"], tb["note_durs"],
                tb["note_types"], src, max_frames=tb["mels"].shape[1])
            mel = ret["mel_out"].cpu().numpy()
            f0_denorm = ret["f0_denorm"].cpu().numpy()
            n_frames = (ret["mel2ph"] > 0).sum(-1).cpu().numpy()
            for b in range(mel.shape[0]):
                if batch.get("nsamples") is not None and \
                        b >= int(batch["nsamples"]):
                    break
                t = int(n_frames[b])
                if t == 0:
                    continue
                name = f"item_{idx:04d}"
                wav = self.vocoder.spec2wav(mel[b, :t], f0=f0_denorm[b, :t])
                save_wav(wav, os.path.join(self.gen_dir, "wavs",
                                           f"{name}.wav"),
                         c["audio_sample_rate"])
                if c.get("save_gt", True):
                    gt_mel = np.asarray(batch["mels"][b])
                    gt_t = int((np.abs(gt_mel).sum(-1) > 0).sum())
                    gt_f0 = denorm_f0(
                        torch.as_tensor(np.asarray(batch["f0"][b, :gt_t])),
                        torch.as_tensor(np.asarray(batch["uv"][b, :gt_t])),
                        pitch_norm=c["pitch_norm"], f0_mean=c["f0_mean"],
                        f0_std=c["f0_std"]).numpy()
                    wav_gt = self.vocoder.spec2wav(gt_mel[:gt_t], f0=gt_f0)
                    save_wav(wav_gt, os.path.join(
                        self.gen_dir, "wavs", f"{name}_gt.wav"),
                        c["audio_sample_rate"])
                f0s.append(f0_denorm[b, :t])
                rows.append({"item_name": name, "n_frames": t,
                             "wav_fn": f"wavs/{name}.wav"})
                idx += 1
        np.save(os.path.join(self.gen_dir, "result_f0s.npy"),
                np.asarray(f0s, dtype=object), allow_pickle=True)
        with open(os.path.join(self.gen_dir, "meta.csv"), "w",
                  newline="") as f:
            w = csv.DictWriter(f, fieldnames=["item_name", "n_frames",
                                              "wav_fn"])
            w.writeheader()
            w.writerows(rows)
        return self.gen_dir
