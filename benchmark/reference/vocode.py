"""The vocoder worked out again: the frozen plain generator
(``plain/hifigan.py``, its MRF groups on the plain twin of the kernel's
mode) on the same mel, F0, weights and noise as the program, and the
lower-precision control that stands in the program's place.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from benchmark.reference.plain.hifigan import ConvTranspose, HifiGanGenerator
from benchmark.reference.plain.common import Conv

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 with one scale per tensor (its largest
    magnitude at the format's largest value), back in its own dtype."""
    scale = x.detach().abs().amax().float().clamp_min(1e-12) / FP8_MAX
    return ((x.float() / scale).to(FP8).float() * scale).to(x.dtype)


def to_fp8(gen: HifiGanGenerator) -> None:
    """The generator one precision below bf16: every conv and transposed
    conv takes its input and its kernel through float8 e4m3, and the MRF
    groups run the resblock modules (where those casts sit) in place of
    the kernel's twin."""
    with torch.no_grad():
        for m in gen.modules():
            if isinstance(m, (Conv, ConvTranspose)):
                m.weight.copy_(fp8_round(m.weight))
                m.register_forward_pre_hook(
                    lambda mod, args: (fp8_round(args[0]),) + args[1:])
    gen.mrf_route = lambda i, t, grad=False: (
        "blocks" if gen.mrf_block and t >= 2 * gen.mrf_block else "modules")


class PlainVocoder:
    """``spec2wav`` of the plain generator: mel [T, M] + f0 [T] (numpy) ->
    wav [T * hop] (numpy), drawing from ``noise`` as the program's
    ``HifiGAN_NSF.spec2wav`` does.

    ``fp8``: the control, the bf16 recipe one precision down
    (:func:`to_fp8`)."""

    def __init__(self, cfg: Dict[str, Any], state: Dict[str, torch.Tensor],
                 device: torch.device, fp8: bool = False):
        self.cfg = cfg
        self.device = torch.device(device)
        with torch.device(self.device):
            self.model = HifiGanGenerator(cfg)
        self.model.load_state_dict(state)
        self.model.eval()
        if fp8:
            to_fp8(self.model)

    @torch.no_grad()
    def spec2wav(self, mel: np.ndarray, f0: Optional[np.ndarray],
                 noise) -> np.ndarray:
        if f0 is None:
            f0 = np.zeros(mel.shape[0], np.float32)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.device)[None]
        wav = self.model(t(mel), t(np.asarray(f0)[: mel.shape[0]]), noise)[0]
        return wav.cpu().numpy()


def wav_errors(wav: np.ndarray, ref: np.ndarray) -> Dict[str, float]:
    """max |wav - ref| / max |ref| and ||wav - ref|| / ||ref||; a wav of
    another length reads inf."""
    if wav.shape != ref.shape:
        return {"wav_max": float("inf"), "wav_l2": float("inf")}
    d = wav.astype(np.float64) - ref.astype(np.float64)
    scale = max(float(np.abs(ref).max()), 1e-12)
    norm = max(float(np.linalg.norm(ref)), 1e-12)
    return {"wav_max": float(np.abs(d).max()) / scale,
            "wav_l2": float(np.linalg.norm(d)) / norm}
