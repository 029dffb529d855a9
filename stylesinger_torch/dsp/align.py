"""Phone/frame alignment (port of ``stylesinger_tpu/dsp/align.py``):
per-phone durations in seconds -> ``mel2ph`` (host numpy, as the
binarizer takes it), ``mel2ph`` -> per-phone frame counts, and the
segment mean of frame hiddens."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def mel2ph_from_durs_np(ph_durs: np.ndarray, n_frames: int, *,
                        hop_size: int, sample_rate: int) -> np.ndarray:
    """Cumulative-time rounding of per-phone durations (seconds) to a
    1-based frame map [n_frames] (0 = padding)."""
    ph_durs = np.asarray(ph_durs, dtype=np.float64)
    ends = np.cumsum(ph_durs)
    starts = np.concatenate([[0.0], ends[:-1]])
    start_f = np.floor(starts * sample_rate / hop_size + 0.5).astype(np.int64)
    end_f = np.floor(ends * sample_rate / hop_size + 0.5).astype(np.int64)
    mel2ph = np.zeros([n_frames], dtype=np.int64)
    for i, (s, e) in enumerate(zip(start_f, end_f)):
        mel2ph[s:min(e, n_frames)] = i + 1
    return mel2ph


def mel2ph_to_dur(mel2ph: torch.Tensor, t_txt: int,
                  max_dur: Optional[int] = None) -> torch.Tensor:
    """[B, T_mel] 1-based frame map -> [B, T_txt] per-phone frame counts;
    frames mapped past ``t_txt`` are dropped, as JAX's scatter drops them."""
    idx = torch.where(mel2ph <= t_txt, mel2ph, torch.zeros_like(mel2ph))
    dur = torch.zeros((mel2ph.shape[0], t_txt + 1), dtype=mel2ph.dtype,
                      device=mel2ph.device)
    dur = dur.scatter_add(1, idx.long(), torch.ones_like(mel2ph))[:, 1:]
    if max_dur is not None:
        dur = torch.clamp_max(dur, max_dur)
    return dur


def group_hidden_by_segs(h: torch.Tensor, seg_ids: torch.Tensor,
                         max_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment mean of frame hiddens h [B, T, H] by 1-based segment ids
    [B, T] -> ([B, max_len, H], counts [B, max_len]); ids past ``max_len``
    are dropped, as JAX's scatter drops them."""
    b, _, hid = h.shape
    idx = torch.where(seg_ids <= max_len, seg_ids,
                      torch.zeros_like(seg_ids)).long()
    sums = torch.zeros((b, max_len + 1, hid), dtype=h.dtype, device=h.device)
    sums = sums.scatter_add(1, idx[..., None].expand(-1, -1, hid), h)
    cnt = torch.zeros((b, max_len + 1), dtype=h.dtype, device=h.device)
    cnt = cnt.scatter_add(1, idx, torch.ones_like(h[..., 0]))
    sums, cnt = sums[:, 1:], cnt[:, 1:]
    return sums / torch.clamp_min(cnt[..., None], 1.0), cnt
