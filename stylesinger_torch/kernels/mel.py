"""Log10-mel spectrogram: the CUDA kernel ``csrc/mel.cu`` and its plain twin.

Counterpart of ``stylesinger_tpu/ops/mel_pallas.py::mel_spectrogram``:
zero-center-padded frames x periodic Hann window -> real DFT -> magnitude
-> mel projection -> log10(max(., eps)).  The transform runs in f64 in both
the kernel (an FFT, two real frames per complex transform) and the twin (a
direct DFT): an f32 direct DFT leaves about 1e-6 of rounding noise in every
bin, which log10 near its 1e-6 floor turns into errors of several 1e-2 on
the nearly empty bins of a clean voice.  The kernel takes every n_fft from
2 to 4096: a power of two runs the FFT, any other size a direct f64 DFT.
On a CUDA tensor :func:`mel_spectrogram` launches the kernel; on a CPU
tensor it runs :func:`mel_spectrogram_plain`, the same arithmetic in plain
PyTorch, which is also the golden the kernel is held against on the card.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from stylesinger_torch.dsp.mel import (
    _hann_periodic, frame_signal, mel_filterbank,
)
from stylesinger_torch.kernels._build import (
    LaunchCounter, check, library, refuse_autograd,
)

counter = LaunchCounter("kernel.mel")
MAX_N_FFT = 4096  # powers of two take the FFT, other sizes the direct DFT


@functools.lru_cache(maxsize=8)
def _constants(sample_rate: int, n_fft: int, win_length: int, n_mels: int,
               fmin: float, fmax: float, device: torch.device
               ) -> Tuple[torch.Tensor, ...]:
    """(window [n_fft] f32, cos and sin [n_fft, F] f64, mel_t [F, M] f32)
    on ``device``, cached so repeated calls do not re-upload the tables."""
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


@functools.lru_cache(maxsize=8)
def _bands(sample_rate: int, n_fft: int, n_mels: int, fmin: float,
           fmax: float, device: torch.device) -> torch.Tensor:
    """[n_mels, 2] int32: the bins [first, last + 1) where each mel filter
    is nonzero (the kernel sums only those; the others add exact zeros)."""
    mel_t = mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax).T
    bands = np.zeros((n_mels, 2), np.int32)
    for m in range(n_mels):
        nz = np.flatnonzero(mel_t[:, m])
        if nz.size:
            bands[m] = nz[0], nz[-1] + 1
    return torch.as_tensor(bands, device=device)


def mel_spectrogram_plain(wav: torch.Tensor, window: torch.Tensor,
                          cos_t: torch.Tensor, sin_t: torch.Tensor,
                          mel_t: torch.Tensor, hop_size: int,
                          eps: float) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: wav [T] -> [1 + T // hop, M].
    The windowed frames are f32; the DFT and mel sums run in f64."""
    w = (frame_signal(wav, window.shape[0], hop_size) * window).double()
    re = w @ cos_t
    im = w @ sin_t
    mag = torch.sqrt(re * re + im * im)
    mel = mag @ mel_t.double()
    return torch.log10(torch.clamp_min(mel, eps)).to(torch.float32)


def mel_spectrogram(wav: torch.Tensor, *, sample_rate: int = 48000,
                    n_fft: int = 1024, hop_size: int = 256,
                    win_length: int = 1024, n_mels: int = 80,
                    fmin: float = 20.0, fmax: float = 24000.0,
                    eps: float = 1e-6) -> torch.Tensor:
    """log10-mel of wav [T] -> [1 + T // hop_size, n_mels] (f32).

    CUDA tensor: the ``csrc/mel.cu`` kernel, which has no backward: it
    raises while autograd records a ``wav`` that requires grad
    (``dsp/mel.py::wav2mel_batch`` is the differentiable form).  CPU
    tensor: the plain twin.
    """
    consts = _constants(sample_rate, n_fft, win_length, n_mels, float(fmin),
                        float(fmax), wav.device)
    if wav.device.type == "cpu":
        return mel_spectrogram_plain(wav, *consts, hop_size, eps)
    if wav.device.type != "cuda":
        raise ValueError(f"mel_spectrogram: unsupported device {wav.device}")
    refuse_autograd("mel_spectrogram", [wav])
    if wav.dtype != torch.float32 or wav.ndim != 1:
        raise ValueError("mel_spectrogram: wav must be a 1-D float32 tensor, "
                         f"got {wav.dtype} {tuple(wav.shape)}")
    if not wav.is_contiguous():
        raise ValueError("mel_spectrogram: wav must be contiguous")
    if not 2 <= n_fft <= MAX_N_FFT:
        raise ValueError(f"mel_spectrogram: n_fft {n_fft} is not in "
                         f"[2, {MAX_N_FFT}]")
    window, _, _, mel_t = consts
    bands = _bands(sample_rate, n_fft, n_mels, float(fmin), float(fmax),
                   wav.device)
    n_frames = 1 + wav.shape[0] // hop_size
    out = torch.empty((n_frames, n_mels), dtype=torch.float32,
                      device=wav.device)
    status = library().ss_mel_spectrogram(
        wav.data_ptr(), wav.shape[0], window.data_ptr(), mel_t.data_ptr(),
        bands.data_ptr(), out.data_ptr(), n_frames, n_fft, hop_size, n_mels, eps,
        torch.cuda.current_stream(wav.device).cuda_stream)
    check(status, "mel_spectrogram")
    counter.add()
    return out
