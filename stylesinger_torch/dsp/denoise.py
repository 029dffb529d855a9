"""Spectral-subtraction denoiser for vocoded audio (port of
``stylesinger_tpu/dsp/denoise.py``); it resynthesizes with
``dsp/griffin_lim.py::istft``.

The vocoder wrapper applies :func:`denoise` when ``vocoder_denoise_c`` > 0:
a constant floor ``c`` is subtracted from the STFT magnitude and the audio
is resynthesized with the original phase.
"""

from __future__ import annotations

import torch

from stylesinger_torch.dsp.griffin_lim import _window, istft
from stylesinger_torch.dsp.mel import frame_signal


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
