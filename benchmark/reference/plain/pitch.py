"""F0 tools: quantization, normalization and the autocorrelation tracker.

Frozen from the port's ``dsp/pitch.py``.  The tracker (Boersma-1993 style:
windowed autocorrelation by FFT, window-AC correction, parabolic peak
interpolation, top-K candidates plus an unvoiced one, Viterbi path with
octave-jump and voicing-transition costs) runs on the tensor's device; the
Viterbi backtrace runs on the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

F0_BIN = 256
F0_MAX = 1100.0
F0_MIN = 50.0
F0_MEL_MIN = 1127.0 * np.log(1 + F0_MIN / 700.0)
F0_MEL_MAX = 1127.0 * np.log(1 + F0_MAX / 700.0)


def f0_to_coarse(f0: torch.Tensor) -> torch.Tensor:
    """Quantize f0 (Hz) to 256 mel-spaced bins in [1, 255]; 0 Hz -> bin 1."""
    f0_mel = 1127.0 * torch.log(1 + f0 / 700.0)
    scaled = (f0_mel - F0_MEL_MIN) * (F0_BIN - 2) / (F0_MEL_MAX - F0_MEL_MIN) \
        + 1
    f0_mel = torch.where(f0_mel > 0, scaled, f0_mel)
    f0_mel = torch.clamp(f0_mel, 1.0, F0_BIN - 1)
    return torch.floor(f0_mel + 0.5).long()


def norm_f0(f0: torch.Tensor, uv: Optional[torch.Tensor] = None, *,
            pitch_norm: str = "log", use_uv: bool = True,
            f0_mean: float = 400.0, f0_std: float = 100.0) -> torch.Tensor:
    if pitch_norm == "standard":
        f0 = (f0 - f0_mean) / f0_std
    elif pitch_norm == "log":
        f0 = torch.log2(f0 + 1e-8)
    if uv is not None and use_uv:
        f0 = torch.where(uv > 0, torch.zeros_like(f0), f0)
    return f0


def denorm_f0(f0: torch.Tensor, uv: Optional[torch.Tensor] = None, *,
              pitch_norm: str = "log", use_uv: bool = True,
              f0_mean: float = 400.0, f0_std: float = 100.0,
              pitch_padding: Optional[torch.Tensor] = None,
              f0_min: Optional[float] = None,
              f0_max: Optional[float] = None) -> torch.Tensor:
    if pitch_norm == "standard":
        f0 = f0 * f0_std + f0_mean
    elif pitch_norm == "log":
        f0 = 2.0 ** f0
    if f0_min is not None:
        f0 = torch.clamp_min(f0, f0_min)
    if f0_max is not None:
        f0 = torch.clamp_max(f0, f0_max)
    if uv is not None and use_uv:
        f0 = torch.where(uv > 0, torch.zeros_like(f0), f0)
    if pitch_padding is not None:
        f0 = torch.where(pitch_padding, torch.zeros_like(f0), f0)
    return f0


def norm_interp_f0_np(f0: np.ndarray, *, pitch_norm: str = "log",
                      use_uv: bool = True, f0_mean: float = 400.0,
                      f0_std: float = 100.0) -> Tuple[np.ndarray, np.ndarray]:
    """Normalize f0 and linearly interpolate over unvoiced gaps (host)."""
    f0 = np.asarray(f0, dtype=np.float32).copy()
    uv = (f0 == 0).astype(np.float32)
    if pitch_norm == "standard":
        f0 = (f0 - f0_mean) / f0_std
    elif pitch_norm == "log":
        f0 = np.log2(f0 + 1e-8)
    if use_uv:
        f0[uv > 0] = 0
    n_uv = int(uv.sum())
    if n_uv == len(f0):
        f0[:] = 0
    elif n_uv > 0:
        f0[uv > 0] = np.interp(
            np.where(uv > 0)[0], np.where(uv == 0)[0], f0[uv == 0])
    return f0.astype(np.float32), uv


# ---------------------------------------------------------------------------
# Autocorrelation pitch tracker
# ---------------------------------------------------------------------------

_OCTAVE_COST = 0.01
_OCTAVE_JUMP_COST = 0.35
_VOICED_UNVOICED_COST = 0.14
_SILENCE_THRESHOLD = 0.03
_MAX_CANDIDATES = 15


def _hann(n: int) -> np.ndarray:
    i = np.arange(n)
    return (0.5 - 0.5 * np.cos(2 * np.pi * (i + 0.5) / n)).astype(np.float32)


def _autocorr(x: torch.Tensor, nfft: int, n_lags: int) -> torch.Tensor:
    spec = torch.fft.rfft(x, n=nfft, dim=-1)
    return torch.fft.irfft(spec * torch.conj(spec), n=nfft, dim=-1)[
        ..., :n_lags]


def autocorr_pitch(wav: torch.Tensor, *, hop_size: int = 256,
                   sample_rate: int = 48000, f0_min: float = 80.0,
                   f0_max: float = 800.0,
                   voicing_threshold: float = 0.6) -> torch.Tensor:
    """Track F0 of a mono wav [T] -> f0 [T // hop_size] (Hz; 0 = unvoiced),
    on ``wav``'s device."""
    wav = wav.to(torch.float32)
    dev = wav.device
    n_frames = wav.shape[-1] // hop_size

    wlen = int(round(3.0 * sample_rate / f0_min))
    wlen += wlen % 2
    nfft = int(2 ** np.ceil(np.log2(2 * wlen)))
    lag_min = max(2, int(np.floor(sample_rate / f0_max)))
    lag_max = min(int(np.ceil(sample_rate / f0_min)), wlen - 2)

    pad = wlen // 2
    padded = F.pad(wav, (pad, pad + hop_size))
    frames = padded[hop_size // 2:].unfold(0, wlen, hop_size)[:n_frames]

    global_peak = torch.clamp_min(wav.abs().max(), 1e-12)
    local_peak = frames.abs().amax(dim=-1)

    window = torch.as_tensor(_hann(wlen), device=dev)
    xw = (frames - frames.mean(dim=-1, keepdim=True)) * window
    ac = _autocorr(xw, nfft, lag_max + 2)
    r = ac / torch.clamp_min(ac[:, :1], 1e-12)
    wac = _autocorr(window, nfft, lag_max + 2)
    wac = wac / torch.clamp_min(wac[0], 1e-12)
    r = r / torch.clamp_min(wac[None, :], 1e-3)

    lags = torch.arange(lag_max + 2, device=dev)
    valid = (lags >= lag_min) & (lags <= lag_max)

    rm = r[:, 1:-1]
    is_peak = (rm > r[:, :-2]) & (rm >= r[:, 2:]) & valid[None, 1:-1]
    denom = r[:, :-2] - 2 * rm + r[:, 2:]
    delta = torch.where(denom.abs() > 1e-12,
                        0.5 * (r[:, :-2] - r[:, 2:]) / denom,
                        torch.zeros_like(denom))
    delta = torch.clamp(delta, -0.5, 0.5)
    peak_val = rm - 0.25 * (r[:, :-2] - r[:, 2:]) * delta
    peak_lag = lags[1:-1].to(torch.float32) + delta

    strength = torch.where(
        is_peak,
        peak_val - _OCTAVE_COST * torch.log2(f0_min * peak_lag / sample_rate),
        torch.full_like(peak_val, -float("inf")))
    top_val, top_idx = torch.topk(strength, _MAX_CANDIDATES, dim=-1)
    top_lag = torch.gather(peak_lag, -1, top_idx)
    finite = torch.isfinite(top_val)
    cand_f0 = sample_rate / torch.clamp_min(top_lag, 1.0)
    cand_f0 = torch.where(finite, cand_f0, torch.zeros_like(cand_f0))
    cand_ok = finite & (cand_f0 >= f0_min) & (cand_f0 <= f0_max)
    voiced_strength = torch.where(cand_ok, torch.clamp_max(top_val, 1.0),
                                  torch.full_like(top_val, -1e9))
    unvoiced_strength = voicing_threshold + torch.clamp_min(
        2.0 - (local_peak / global_peak)
        / (_SILENCE_THRESHOLD / (1.0 + voicing_threshold)), 0.0)

    all_strength = torch.cat([voiced_strength, unvoiced_strength[:, None]],
                             dim=-1)                           # [N, K+1]
    all_f0 = torch.cat([cand_f0, torch.zeros_like(unvoiced_strength[:, None])],
                       dim=-1)
    log_f0 = torch.where(all_f0 > 0, torch.log2(torch.clamp_min(all_f0, 1e-6)),
                         torch.zeros_like(all_f0))
    voiced = all_f0 > 0

    # transition costs of every step at once, scaled to a 10 ms step
    ts_corr = 0.01 * sample_rate / hop_size
    f_prev, f_cur = log_f0[:-1, :, None], log_f0[1:, None, :]
    v_prev, v_cur = voiced[:-1, :, None], voiced[1:, None, :]
    octave = _OCTAVE_JUMP_COST * ts_corr * (f_prev - f_cur).abs()
    switch = torch.where(v_prev ^ v_cur,
                         torch.tensor(_VOICED_UNVOICED_COST * ts_corr,
                                      device=dev),
                         torch.tensor(0.0, device=dev))
    step_add = all_strength[1:, None, :] - torch.where(v_prev & v_cur,
                                                       octave, switch)

    score = all_strength[0]
    backptr = []
    for t in range(n_frames - 1):
        score, best_prev = (score[:, None] + step_add[t]).max(dim=0)
        backptr.append(best_prev)
    last = int(torch.argmax(score))
    path = np.empty(n_frames, np.int64)
    path[-1] = last
    if backptr:
        bp = torch.stack(backptr).cpu().numpy()
        for t in range(n_frames - 2, -1, -1):
            path[t] = bp[t, path[t + 1]]
    path_t = torch.as_tensor(path, device=dev)
    return torch.gather(all_f0, -1, path_t[:, None])[:, 0]


def extract_pitch(wav: np.ndarray, *, hop_size: int, sample_rate: int,
                  device: torch.device, f0_min: float = 80.0,
                  f0_max: float = 800.0,
                  voicing_threshold: float = 0.6) -> np.ndarray:
    """numpy in, numpy out; the tracker runs on ``device``."""
    f0 = autocorr_pitch(
        torch.as_tensor(np.asarray(wav, np.float32), device=device),
        hop_size=hop_size, sample_rate=sample_rate, f0_min=f0_min,
        f0_max=f0_max, voicing_threshold=voicing_threshold)
    return f0.cpu().numpy()
