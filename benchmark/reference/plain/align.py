"""``mel2ph_to_dur``, frozen from the port's ``dsp/align.py``."""

from __future__ import annotations

from typing import Optional

import torch


def mel2ph_to_dur(mel2ph: torch.Tensor, t_txt: int,
                  max_dur: Optional[int] = None) -> torch.Tensor:
    """[B, T_mel] 1-based frame map -> [B, T_txt] per-phone frame counts;
    frames mapped past ``t_txt`` are dropped."""
    idx = torch.where(mel2ph <= t_txt, mel2ph, torch.zeros_like(mel2ph))
    dur = torch.zeros((mel2ph.shape[0], t_txt + 1), dtype=mel2ph.dtype,
                      device=mel2ph.device)
    dur = dur.scatter_add(1, idx.long(), torch.ones_like(mel2ph))[:, 1:]
    if max_dur is not None:
        dur = torch.clamp_max(dur, max_dur)
    return dur
