"""STFT + log-mel front-end (frozen from the port's ``dsp/mel.py``).

Centered STFT with **zero** center padding (``torch.stft`` would pad with
reflect), periodic Hann window, Slaney mel filterbank and
``log10(max(eps, mel))``.  :func:`wav2mel` goes through the mel kernel
(``kernels/mel.py``) on a CUDA tensor and its plain twin on a CPU tensor;
:func:`wav2mel_batch` is the differentiable form that training losses take.
"""

from __future__ import annotations

import functools
from typing import Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F


def _hz_to_mel(freqs: np.ndarray) -> np.ndarray:
    """Slaney mel scale (librosa htk=False)."""
    freqs = np.asarray(freqs, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = freqs / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = freqs >= min_log_hz
    return np.where(
        log_region,
        min_log_mel + np.log(np.maximum(freqs, 1e-10) / min_log_hz) / logstep,
        mels)


def _mel_to_hz(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = mels >= min_log_mel
    return np.where(log_region,
                    min_log_hz * np.exp(logstep * (mels - min_log_mel)),
                    freqs)


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int,
                   fmin: float, fmax: float) -> np.ndarray:
    """Triangular mel filterbank [n_mels, 1 + n_fft//2], Slaney-normalized."""
    n_freqs = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(_hz_to_mel(np.array(fmin)),
                          _hz_to_mel(np.array(fmax)), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def _hann_periodic(win_length: int) -> np.ndarray:
    """Periodic Hann window (scipy get_window('hann', N, fftbins=True))."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(
        np.float32)


def frame_signal(wav: torch.Tensor, n_fft: int, hop_size: int
                 ) -> torch.Tensor:
    """Center-pad with zeros and frame [..., T] -> [..., 1 + T//hop, n_fft]."""
    pad = n_fft // 2
    return F.pad(wav, (pad, pad)).unfold(-1, n_fft, hop_size)


def wav2mel(wav: torch.Tensor, *, sample_rate: int = 48000,
            n_fft: int = 1024, hop_size: int = 256, win_length: int = 1024,
            n_mels: int = 80, fmin: float = 20.0, fmax: float = 24000.0,
            eps: float = 1e-6,
            dft_dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """log10-mel of wav [T] -> [1 + T//hop_size, n_mels] (mel kernel on a
    CUDA tensor, its plain twin on a CPU tensor)."""
    from .kernels_plain import mel_spectrogram

    return mel_spectrogram(wav, sample_rate=sample_rate, n_fft=n_fft,
                           hop_size=hop_size, win_length=win_length,
                           n_mels=n_mels, fmin=fmin, fmax=fmax, eps=eps,
                           dft_dtype=dft_dtype)


@functools.lru_cache(maxsize=8)
def _mel_tables(sample_rate: int, n_fft: int, win_length: int, n_mels: int,
                fmin: float, fmax: float, device: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(window [n_fft], filterbank transposed [1 + n_fft // 2, n_mels]) on
    ``device``, both f32, the window centred in the frame."""
    window = _hann_periodic(win_length)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = np.pad(window, (lpad, n_fft - win_length - lpad))
    basis = mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax)
    return (torch.as_tensor(window, device=device),
            torch.as_tensor(np.ascontiguousarray(basis.T), device=device))


def wav2mel_batch(wav: torch.Tensor, *, sample_rate: int = 48000,
                  n_fft: int = 1024, hop_size: int = 256,
                  win_length: int = 1024, n_mels: int = 80,
                  fmin: float = 20.0, fmax: float = 24000.0,
                  eps: float = 1e-6) -> torch.Tensor:
    """Differentiable log10-mel of wav [..., T] -> [..., 1 + T // hop_size,
    n_mels], from autograd ops in f32 (framing, ``torch.fft.rfft``, |.|,
    the filterbank, log10): the counterpart of the JAX package's
    ``dsp/mel.py::wav2mel``, which vocoder training differentiates.  The mel
    kernel has no backward, so losses take this and not :func:`wav2mel`."""
    window, basis_t = _mel_tables(sample_rate, n_fft, win_length, n_mels,
                                  float(fmin), float(fmax), wav.device)
    frames = frame_signal(wav, n_fft, hop_size)
    mag = torch.fft.rfft(frames * window, n=n_fft, dim=-1).abs()
    return torch.log10(torch.clamp_min(mag @ basis_t, eps))


def pad_wav_to_frames(wav: np.ndarray, hop_size: int) -> np.ndarray:
    """Right-pad wav so len == n_frames * hop."""
    n_frames = len(wav) // hop_size + 1
    return np.pad(wav, (0, n_frames * hop_size - len(wav)), mode="constant")


def wav2spec(wav: Union[np.ndarray, torch.Tensor], device: torch.device, *,
             sample_rate: int = 48000, n_fft: int = 1024,
             hop_size: int = 256, win_length: int = 1024, n_mels: int = 80,
             fmin: float = 20.0, fmax: float = 24000.0,
             eps: float = 1e-6, loud_norm: bool = False,
             dft_dtype: torch.dtype = torch.float64) -> dict:
    """Counterpart of ``wav2spec_np``: {'wav': numpy wav padded to
    n_frames*hop, 'mel': [N, n_mels] tensor on ``device``}.  ``loud_norm``
    first gains the wav to -23 LUFS (BS.1770, ``dsp/loudness.py``, on the
    host), as ``wav2spec_np`` does."""
    wav_np = np.asarray(torch.as_tensor(wav).cpu().numpy(), np.float32)
    if loud_norm:
        raise NotImplementedError("loud_norm is not part of the reference")
    mel = wav2mel(torch.as_tensor(wav_np, device=device),
                  sample_rate=sample_rate, n_fft=n_fft, hop_size=hop_size,
                  win_length=win_length, n_mels=n_mels, fmin=fmin,
                  fmax=fmax, eps=eps, dft_dtype=dft_dtype)
    out_wav = pad_wav_to_frames(wav_np, hop_size)[: mel.shape[0] * hop_size]
    return {"wav": out_wav, "mel": mel}
