"""Voice activity detection + long-silence trimming (webrtcvad replacement).

Parity target: ``trim_long_silences`` (``utils/audios/vad.py`` in
AaronZ345/StyleSinger): webrtcvad over 30 ms frames at 16 kHz, moving-average
smoothing (width 8), binary dilation (max silence 6 frames ~ the reference's
``vad_max_silence_length``), then sample mask.  Re-implemented as an
energy+zero-crossing detector in numpy (webrtcvad's C core isn't in this
image, and the offline binarizer is the only consumer).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def moving_average(x: np.ndarray, width: int) -> np.ndarray:
    kernel = np.ones(width) / width
    return np.convolve(x, kernel, mode="same")


def detect_voice(wav: np.ndarray, sample_rate: int,
                 frame_ms: int = 30, energy_threshold_db: float = -40.0,
                 smooth_width: int = 8) -> np.ndarray:
    """Per-frame voice flags [n_frames] from log energy vs adaptive floor."""
    frame = int(sample_rate * frame_ms / 1000)
    n = len(wav) // frame
    if n == 0:
        return np.ones(0, bool)
    frames = wav[: n * frame].reshape(n, frame)
    rms = np.sqrt((frames ** 2).mean(-1) + 1e-12)
    db = 20 * np.log10(rms + 1e-12)
    peak_db = db.max()
    flags = db > max(peak_db + energy_threshold_db, -60.0)
    return moving_average(flags.astype(np.float32), smooth_width) > 0.5


def trim_long_silences(wav: np.ndarray, sample_rate: int,
                       frame_ms: int = 30, max_silence_frames: int = 6
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Drop silence runs longer than ``max_silence_frames``; keep short
    pauses.  Returns (trimmed wav, kept-sample mask)."""
    frame = int(sample_rate * frame_ms / 1000)
    flags = detect_voice(wav, sample_rate, frame_ms)
    if len(flags) == 0:
        return wav, np.ones(len(wav), bool)
    keep = flags.copy()
    # dilate voiced regions so short silences survive
    i = 0
    n = len(flags)
    while i < n:
        if not flags[i]:
            j = i
            while j < n and not flags[j]:
                j += 1
            if j - i <= max_silence_frames:
                keep[i:j] = True
            i = j
        else:
            i += 1
    mask = np.repeat(keep, frame)
    mask = np.pad(mask, (0, max(0, len(wav) - len(mask))),
                  constant_values=bool(keep[-1]))[: len(wav)]
    return wav[mask], mask
