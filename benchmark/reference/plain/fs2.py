"""The helpers StyleSinger shares with FastSpeech2, frozen from the port's
``models/fs2.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import DurationPredictor, length_regulator

DVEC_DIM = 256   # d-vector width of the GE2E encoders


def grad_scale(x: torch.Tensor, scale: float) -> torch.Tensor:
    if scale == 1.0:
        return x
    return x.detach() + scale * (x - x.detach())


def expand_states(h: torch.Tensor, mel2ph: torch.Tensor) -> torch.Tensor:
    """Phone-level [B, T_txt, H] -> frames [B, T_mel, H]; index 0 reads a
    zero vector."""
    h = F.pad(h, (0, 0, 1, 0))
    return torch.gather(h, 1, mel2ph[..., None].expand(-1, -1, h.shape[-1]))


def predict_mel2ph(log_dur: torch.Tensor, src_nonpadding: torch.Tensor,
                   max_frames: int) -> torch.Tensor:
    return length_regulator(DurationPredictor.out2dur(log_dur),
                            1 - src_nonpadding, max_frames)
