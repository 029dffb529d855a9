"""Griffin-Lim phase reconstruction (mel / linear magnitude -> wav without
a vocoder) and the inverse STFT it and the denoiser resynthesize with;
port of ``stylesinger_tpu/dsp/griffin_lim.py``.

JAX runs a fixed number of ISTFT -> STFT projections as one ``lax.scan``
from phases drawn with ``jax.random.PRNGKey(0)``; here the same loop runs
eagerly on the tensor's device from phases the caller gives (``angles``)
or draws from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from stylesinger_torch.dsp.mel import (
    _hann_periodic, frame_signal, mel_filterbank,
)


def _window(n_fft: int, win_length: int, device) -> torch.Tensor:
    """Periodic Hann of ``win_length``, zero-padded to ``n_fft`` centred."""
    w = _hann_periodic(win_length)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        w = np.pad(w, (lpad, n_fft - win_length - lpad))
    return torch.as_tensor(np.ascontiguousarray(w, np.float32), device=device)


def istft(spec: torch.Tensor, n_fft: int, hop_size: int,
          win_length: int) -> torch.Tensor:
    """Overlap-add inverse STFT of [N, F] complex -> [T] (centred): each
    frame's inverse FFT times the window, summed, over the summed squared
    window."""
    window = _window(n_fft, win_length, spec.device)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window  # [N, n_fft]
    n = frames.shape[0]
    t = (n - 1) * hop_size + n_fft
    idx = (torch.arange(n, device=spec.device)[:, None] * hop_size +
           torch.arange(n_fft, device=spec.device)[None, :]).reshape(-1)
    wav = torch.zeros(t, device=spec.device).index_add_(
        0, idx, frames.reshape(-1))
    wsq = torch.zeros(t, device=spec.device).index_add_(
        0, idx, (window ** 2).expand(n, -1).reshape(-1))
    wav = wav / torch.clamp_min(wsq, 1e-8)
    pad = n_fft // 2
    return wav[pad: t - pad]


def griffin_lim(mag: torch.Tensor, *, n_fft: int = 1024, hop_size: int = 256,
                win_length: int = 1024, n_iters: int = 30,
                angles: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """|STFT| magnitude [N, F] -> waveform [(N - 1) * hop_size] by iterative
    phase fitting.  The initial phases are ``angles`` (complex unit
    phasors [N, F], e.g. JAX's ``exp(2j pi U)`` of ``PRNGKey(0)``
    replayed), else ``exp(2j pi U)`` with U uniform on [0, 1) drawn on the
    CPU from ``generator`` (default: seed 0)."""
    window = _window(n_fft, win_length, mag.device)
    if angles is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        u = torch.rand(mag.shape, generator=generator, dtype=torch.float64)
        angles = torch.exp(2j * np.pi * u).to(torch.complex64)
    angles = angles.to(device=mag.device, dtype=torch.complex64)

    for _ in range(n_iters):
        wav = istft(mag * angles, n_fft, hop_size, win_length)
        frames = frame_signal(wav, n_fft, hop_size)[: mag.shape[0]]
        s = torch.fft.rfft(frames * window, n=n_fft, dim=-1)
        angles = s / torch.clamp_min(s.abs(), 1e-8)
    return istft(mag * angles, n_fft, hop_size, win_length)


def mel_to_linear(mel_log10: torch.Tensor, *, sample_rate: int = 48000,
                  n_fft: int = 1024, n_mels: int = 80, fmin: float = 20.0,
                  fmax: float = 24000.0) -> torch.Tensor:
    """log10-mel [N, M] -> approximate |STFT| [N, F] through the
    filterbank's pseudo-inverse (f32)."""
    basis = mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax)  # [M, F]
    inv_t = torch.as_tensor(np.linalg.pinv(basis).T.astype(np.float32),
                            device=mel_log10.device)
    mel = 10.0 ** mel_log10.to(torch.float32)
    return torch.clamp_min(mel @ inv_t, 1e-8)
