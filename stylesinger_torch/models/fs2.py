"""The FastSpeech2 parts that StyleSinger calls (port of
``stylesinger_tpu/models/fs2.py`` and ``dsp/align.py::expand_states``):
durations -> ``mel2ph`` with a static length, the phone-to-frame gather,
and ``grad_scale``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stylesinger_torch.models.common import DurationPredictor, length_regulator


def grad_scale(x: torch.Tensor, scale: float) -> torch.Tensor:
    """The value of ``x`` with its gradient scaled by ``scale``."""
    if scale == 1.0:
        return x
    return x.detach() + scale * (x - x.detach())


def expand_states(h: torch.Tensor, mel2ph: torch.Tensor) -> torch.Tensor:
    """Phone-level [B, T_txt, H] -> frames [B, T_mel, H]; mel2ph is
    1-based and index 0 reads a zero vector."""
    h = F.pad(h, (0, 0, 1, 0))
    return torch.gather(h, 1, mel2ph[..., None].expand(-1, -1, h.shape[-1]))


def predict_mel2ph(log_dur: torch.Tensor, src_nonpadding: torch.Tensor,
                   max_frames: int) -> torch.Tensor:
    """Predicted log-durations [B, T_txt] -> mel2ph [B, max_frames]."""
    return length_regulator(DurationPredictor.out2dur(log_dur),
                            1 - src_nonpadding, max_frames)
