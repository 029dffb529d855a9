"""ITU-R BS.1770 integrated loudness measurement + normalization (a copy of
``stylesinger_tpu/dsp/loudness.py``: numpy and scipy on the host).

Parity target: the reference's optional pyloudnorm pass in
``librosa_wav2spec`` (``utils/audios/__init__.py:44-52``, gated on
``loud_norm``).  Self-contained: K-weighting (pre-filter shelf + RLB
high-pass) as biquads, 400 ms blocks with 75% overlap, -70 LUFS absolute
and -10 LU relative gating.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _k_weighting_coeffs(fs: float) -> Tuple[np.ndarray, np.ndarray]:
    """(stage1 shelf b/a, stage2 highpass b/a) per BS.1770-4 Annex 1."""
    # stage 1: spherical-head shelf
    db = 3.999843853973347
    f0 = 1681.974450955533
    q = 0.7071752369554196
    k = np.tan(np.pi * f0 / fs)
    vh = 10 ** (db / 20.0)
    vb = vh ** 0.4996667741545416
    a0 = 1.0 + k / q + k * k
    b_shelf = np.array([(vh + vb * k / q + k * k) / a0,
                        2.0 * (k * k - vh) / a0,
                        (vh - vb * k / q + k * k) / a0])
    a_shelf = np.array([1.0, 2.0 * (k * k - 1.0) / a0,
                        (1.0 - k / q + k * k) / a0])
    # stage 2: RLB high-pass
    f0 = 38.13547087602444
    q = 0.5003270373238773
    k = np.tan(np.pi * f0 / fs)
    a0 = 1.0 + k / q + k * k
    b_hp = np.array([1.0, -2.0, 1.0]) / a0
    a_hp = np.array([1.0, 2.0 * (k * k - 1.0) / a0,
                     (1.0 - k / q + k * k) / a0])
    return (b_shelf, a_shelf), (b_hp, a_hp)


def _biquad(x: np.ndarray, b: np.ndarray, a: np.ndarray) -> np.ndarray:
    from scipy.signal import lfilter
    return lfilter(b, a, x)


def integrated_loudness(wav: np.ndarray, fs: int) -> float:
    """Gated integrated loudness (LUFS) of a mono signal."""
    (bs, as_), (bh, ah) = _k_weighting_coeffs(fs)
    y = _biquad(_biquad(np.asarray(wav, np.float64), bs, as_), bh, ah)
    block = int(0.4 * fs)
    hop = block // 4
    if len(y) < block:
        y = np.pad(y, (0, block - len(y)))
    n_blocks = 1 + (len(y) - block) // hop
    idx = np.arange(n_blocks)[:, None] * hop + np.arange(block)[None, :]
    z = (y[idx] ** 2).mean(axis=1)
    lk = -0.691 + 10 * np.log10(np.maximum(z, 1e-12))
    gated = z[lk > -70.0]
    if len(gated) == 0:
        return -70.0
    rel_thresh = -0.691 + 10 * np.log10(gated.mean()) - 10.0
    keep = z[(lk > -70.0) & (lk > rel_thresh)]
    if len(keep) == 0:
        keep = gated
    return float(-0.691 + 10 * np.log10(keep.mean()))


def normalize_loudness(wav: np.ndarray, fs: int,
                       target_lufs: float = -23.0) -> np.ndarray:
    """Gain the signal to the target integrated loudness (clip-protected)."""
    lufs = integrated_loudness(wav, fs)
    gain = 10 ** ((target_lufs - lufs) / 20.0)
    out = np.asarray(wav) * gain
    peak = np.abs(out).max()
    if peak > 0.99:
        out = out * (0.99 / peak)
    return out.astype(np.float32)
