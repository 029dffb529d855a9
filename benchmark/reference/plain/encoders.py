"""GE2E utterance encoders: emotion + speaker d-vectors (frozen from
the port's ``models/encoders.py``).

The front-end (resampling, volume normalization, VAD trim, the **power**
mel and the partial slicing) is host-side numpy, as in the JAX package;
the 3-layer LSTM runs on the module's device as ``nn.LSTM``.
"""

from __future__ import annotations

from math import gcd
from typing import List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .mel import _hann_periodic, mel_filterbank
from .vad import trim_long_silences

# GE2E front-end constants (params_data.py)
GE2E_SR = 16000
GE2E_N_FFT = 400          # 25 ms at 16 kHz
GE2E_HOP = 160            # 10 ms
GE2E_N_MELS = 40
PARTIAL_FRAMES = 160
INFERENCE_FRAMES = 80
AUDIO_NORM_TARGET_DBFS = -30.0


# ---------------------------------------------------------------------------
# resampling + preprocessing (host-side numpy)
# ---------------------------------------------------------------------------

def resample_wav(wav: np.ndarray, orig_sr: int, target_sr: int
                 ) -> np.ndarray:
    """Polyphase windowed-sinc resampler (Kaiser β=5, 20·max_rate+1 taps —
    the ``scipy.signal.resample_poly`` default design), replacing the
    round-1 ``np.interp`` (which aliased >8 kHz energy into the d-vector
    mels). Output length = ceil(len·up/down), zero-phase."""
    g = gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    if up == down:
        return np.asarray(wav, np.float32)
    max_rate = max(up, down)
    half = 10 * max_rate
    n = np.arange(-half, half + 1)
    cutoff = 1.0 / max_rate                      # Nyquist-normalized
    h = np.sinc(cutoff * n) * np.kaiser(2 * half + 1, 5.0)
    h *= up / h.sum()                            # unit DC gain (firwin)
    x_up = np.zeros(len(wav) * up, np.float64)
    x_up[::up] = np.asarray(wav, np.float64)
    y = np.convolve(x_up, h)[half: half + len(x_up)]
    n_out = -(-len(wav) * up // down)            # ceil
    out = np.zeros(n_out, np.float64)
    dec = y[::down]
    out[: len(dec)] = dec
    return out.astype(np.float32)


def normalize_volume(wav: np.ndarray, target_dbfs: float,
                     increase_only: bool = False,
                     decrease_only: bool = False) -> np.ndarray:
    """RMS dBFS normalization (reference audio.py:103-109)."""
    rms = np.sqrt(np.mean(np.square(wav)) + 1e-12)
    change = target_dbfs - 20.0 * np.log10(max(rms, 1e-12))
    if (change < 0 and increase_only) or (change > 0 and decrease_only):
        return wav
    return (wav * (10.0 ** (change / 20.0))).astype(np.float32)


def preprocess_wav(wav: np.ndarray, source_sr: int = GE2E_SR
                   ) -> np.ndarray:
    """Emotion-path preprocessing (reference ``audio.py::preprocess_wav``):
    resample -> 16 kHz, volume-normalize to -30 dBFS (increase only), trim
    long silences (energy-VAD analogue of webrtcvad)."""
    wav = np.asarray(wav, np.float32)
    if source_sr != GE2E_SR:
        wav = resample_wav(wav, source_sr, GE2E_SR)
    wav = normalize_volume(wav, AUDIO_NORM_TARGET_DBFS, increase_only=True)
    wav, _ = trim_long_silences(wav, GE2E_SR)
    return wav


# ---------------------------------------------------------------------------
# mel front-end
# ---------------------------------------------------------------------------

def ge2e_mel_np(wav: np.ndarray) -> np.ndarray:
    """wav (interpreted at 16 kHz) -> [T, 40] **power** mel — librosa 0.8
    ``melspectrogram`` semantics as used by resemblyzer and the emotion
    encoder (reference audio.py:43-57: "this is not a log-mel"): centered
    reflect-pad STFT, hann(400)/hop 160, |.|^2 @ Slaney mel."""
    wav = np.asarray(wav, np.float32)
    pad = GE2E_N_FFT // 2
    if len(wav) < pad + 1:      # too short to reflect: zero-extend first
        wav = np.pad(wav, (0, pad + 1 - len(wav)))
    wav = np.pad(wav, (pad, pad), mode="reflect")
    n_frames = 1 + (len(wav) - GE2E_N_FFT) // GE2E_HOP
    idx = (np.arange(n_frames)[:, None] * GE2E_HOP +
           np.arange(GE2E_N_FFT)[None, :])
    frames = wav[idx] * _hann_periodic(GE2E_N_FFT)
    mag = np.abs(np.fft.rfft(frames, axis=-1)).astype(np.float32)
    basis = mel_filterbank(GE2E_SR, GE2E_N_FFT, GE2E_N_MELS, 0.0,
                           GE2E_SR / 2)
    return ((mag ** 2) @ basis.T).astype(np.float32)


def compute_partial_slices(n_samples: int,
                           partial_frames: int = PARTIAL_FRAMES,
                           min_pad_coverage: float = 0.75,
                           overlap: float = 0.5
                           ) -> Tuple[List[slice], List[slice]]:
    """(wav_slices, mel_slices) of sliding 160-frame partials — the
    reference's sample-domain slicing (inference.py:59-110): mel frame i
    starts at sample i·160; the last partial is dropped when < 75 % of it
    is real audio (and more than one partial exists)."""
    spf = GE2E_HOP                                  # samples per frame
    n_frames = int(np.ceil((n_samples + 1) / spf))
    step = max(int(np.round(partial_frames * (1 - overlap))), 1)
    wav_slices, mel_slices = [], []
    for i in range(0, max(1, n_frames - partial_frames + step + 1), step):
        mel_slices.append(slice(i, i + partial_frames))
        wav_slices.append(slice(i * spf, (i + partial_frames) * spf))
    last = wav_slices[-1]
    coverage = (n_samples - last.start) / (last.stop - last.start)
    if coverage < min_pad_coverage and len(mel_slices) > 1:
        wav_slices, mel_slices = wav_slices[:-1], mel_slices[:-1]
    return wav_slices, mel_slices


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

class UtteranceEncoder(nn.Module):
    """3-layer LSTM(40 -> 256) + projection head.

    ``project=True`` is the speaker path (linear + ReLU + L2-norm);
    ``project=False`` is the emotion path (raw last hidden state)."""

    def __init__(self, hidden_size: int = 256, embed_size: int = 256,
                 num_layers: int = 3, n_mels: int = GE2E_N_MELS):
        super().__init__()
        self.lstm = nn.LSTM(n_mels, hidden_size, num_layers,
                            batch_first=True)
        self.proj = nn.Linear(hidden_size, embed_size)

    def forward(self, mels: torch.Tensor, project: bool = True
                ) -> torch.Tensor:
        """mels [B, T, 40] -> [B, embed_size]."""
        out, _ = self.lstm(mels)
        last = out[:, -1, :]
        if not project:
            return last
        e = F.relu(self.proj(last))
        return e / torch.clamp_min(torch.linalg.norm(e, dim=-1,
                                                     keepdim=True), 1e-8)

    @torch.no_grad()
    def embed_utterance(self, wav: np.ndarray,
                        project: bool = True) -> np.ndarray:
        """Utterance wav (16 kHz semantics) -> one unit-norm embedding:
        partial slices -> batched LSTM -> mean -> L2-norm."""
        wav = np.asarray(wav, np.float32)
        wav_slices, mel_slices = compute_partial_slices(len(wav))
        max_len = wav_slices[-1].stop
        if max_len >= len(wav):
            wav = np.pad(wav, (0, max_len - len(wav)))
        frames = ge2e_mel_np(wav)
        partials = np.stack([frames[s] for s in mel_slices])
        dev = self.proj.weight.device
        embeds = self(torch.as_tensor(partials, device=dev), project=project)
        raw = embeds.mean(dim=0).cpu().numpy()
        return (raw / max(np.linalg.norm(raw), 1e-8)).astype(np.float32)
