"""The plain twins of the port's two hand-written kernels, frozen: the MRF
group over overlap-save blocks (f32 and bf16 rounding) and the log-mel.

``fused_mrf_blocks`` and ``mel_spectrogram`` keep the kernels' signatures,
so that the frozen model code calls them where the port calls the kernels.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .mel import _hann_periodic, frame_signal, mel_filterbank

LRELU_SLOPE = 0.1
BF16_SLOPE = float(torch.tensor(LRELU_SLOPE, dtype=torch.bfloat16))
MAX_REACH = 64
MAX_C = 128

Weights = Sequence[Sequence[Tuple[Tuple[torch.Tensor, torch.Tensor],
                                  Tuple[torch.Tensor, torch.Tensor]]]]


def mrf_blocks_plain(xb, mask, weights: Weights, *, kernels, dilations,
                     block: int, halo: int) -> torch.Tensor:
    """xb [Nb, L, C], mask [Nb, L, 1] -> [Nb, block, C]; kernels in the
    [k, C_in, C_out] layout."""
    x = xb.transpose(1, 2)
    m = mask.transpose(1, 2)
    acc = None
    for rb, k, dils in zip(weights, kernels, dilations):
        xj = x
        for ((w1, b1), (w2, b2)), d in zip(rb, dils):
            y = F.leaky_relu(xj, LRELU_SLOPE) * m
            y = F.conv1d(y, w1.permute(2, 1, 0), b1,
                         padding=(k - 1) // 2 * d, dilation=d)
            y = F.leaky_relu(y, LRELU_SLOPE) * m
            y = F.conv1d(y, w2.permute(2, 1, 0), b2, padding=(k - 1) // 2)
            xj = xj + y
        acc = xj if acc is None else acc + xj
    out = acc / len(kernels)
    return out[:, :, halo:halo + block].transpose(1, 2)


def _bf16(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.bfloat16).float()


def _act_bf16(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return _bf16(torch.where(v > 0, v, _bf16(v * BF16_SLOPE)) * m)


def mrf_blocks_plain_bf16(xb, mask, weights: Weights, *, kernels, dilations,
                          block: int, halo: int) -> torch.Tensor:
    """The bf16 mode: f32 arithmetic on bf16 values, rounded to bf16 after
    each conv + bias, each activation and each residual sum; the resblocks
    summed in f32, the mean rounded to bf16."""
    x = xb.float().transpose(1, 2)
    m = mask.float().transpose(1, 2)
    acc = None
    for rb, k, dils in zip(weights, kernels, dilations):
        xj = x
        for ((w1, b1), (w2, b2)), d in zip(rb, dils):
            y = F.conv1d(_act_bf16(xj, m), _bf16(w1).permute(2, 1, 0),
                         padding=(k - 1) // 2 * d, dilation=d)
            y = _act_bf16(_bf16(y + b1[:, None]), m)
            y = F.conv1d(y, _bf16(w2).permute(2, 1, 0),
                         padding=(k - 1) // 2)
            xj = _bf16(xj + _bf16(y + b2[:, None]))
        acc = xj if acc is None else acc + xj
    out = acc * (1.0 / len(kernels))
    return out[:, :, halo:halo + block].transpose(1, 2).to(torch.bfloat16)


def takes_stage(c: int, kernels: Sequence[int],
                dilations: Sequence[Sequence[int]]) -> bool:
    return c <= MAX_C and all((k - 1) * d <= MAX_REACH
                              for k, ds in zip(kernels, dilations)
                              for d in ds)


def fused_mrf_blocks(xb, mask, weights: Weights, *, kernels, dilations,
                     block: int, halo: int,
                     compute_dtype=torch.float32) -> torch.Tensor:
    """The kernel's entry, computed by the plain twin of its mode."""
    fn = mrf_blocks_plain_bf16 if compute_dtype == torch.bfloat16 \
        else mrf_blocks_plain
    return fn(xb, mask, weights, kernels=kernels, dilations=dilations,
              block=block, halo=halo)


@functools.lru_cache(maxsize=8)
def _constants(sample_rate, n_fft, win_length, n_mels, fmin, fmax, device):
    n_freqs = 1 + n_fft // 2
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_freqs)[None, :]
    ang = -2.0 * np.pi * n * k / n_fft
    window = _hann_periodic(win_length)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = np.pad(window, (lpad, n_fft - win_length - lpad))
    mel_t = mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax).T
    return (torch.as_tensor(np.ascontiguousarray(window, np.float32),
                            device=device),
            torch.as_tensor(np.cos(ang), device=device),
            torch.as_tensor(np.sin(ang), device=device),
            torch.as_tensor(np.ascontiguousarray(mel_t, np.float32),
                            device=device))


def mel_spectrogram(wav: torch.Tensor, *, sample_rate=48000, n_fft=1024,
                    hop_size=256, win_length=1024, n_mels=80, fmin=20.0,
                    fmax=24000.0, eps=1e-6,
                    dft_dtype=torch.float64) -> torch.Tensor:
    """wav [T] -> [1 + T // hop, M] f32: windowed f32 frames, the DFT and
    the mel sums in ``dft_dtype`` (the kernel's f64)."""
    window, cos_t, sin_t, mel_t = _constants(
        sample_rate, n_fft, win_length, n_mels, float(fmin), float(fmax),
        wav.device)
    dt = dft_dtype
    w = (frame_signal(wav, window.shape[0], hop_size) * window).to(dt)
    re, im = w @ cos_t.to(dt), w @ sin_t.to(dt)
    mel = torch.sqrt(re * re + im * im) @ mel_t.to(dt)
    return torch.log10(torch.clamp_min(mel, eps)).to(torch.float32)
