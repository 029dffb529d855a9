"""Spectral-subtraction denoiser for vocoded audio and the inverse STFT it
resynthesizes with (port of ``stylesinger_tpu/dsp/denoise.py`` and of
``istft`` in ``stylesinger_tpu/dsp/griffin_lim.py``).

The vocoder wrapper applies :func:`denoise` when ``vocoder_denoise_c`` > 0:
a constant floor ``c`` is subtracted from the STFT magnitude and the audio
is resynthesized with the original phase.
"""

from __future__ import annotations

import numpy as np
import torch

from stylesinger_torch.dsp.mel import _hann_periodic, frame_signal


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


def denoise(wav: torch.Tensor, c: float = 0.01, *, n_fft: int = 1024,
            hop_size: int = 256, win_length: int = 1024) -> torch.Tensor:
    """Subtract a constant magnitude floor ``c`` (phase preserved):
    wav [T] -> [T]."""
    window = _window(n_fft, win_length, wav.device)
    spec = torch.fft.rfft(frame_signal(wav, n_fft, hop_size) * window,
                          n=n_fft, dim=-1)
    mag = spec.abs()
    phase = spec / torch.clamp_min(mag, 1e-8)
    out = istft(torch.clamp_min(mag - c, 0.0) * phase, n_fft, hop_size,
                win_length)
    return out[: wav.shape[-1]]
