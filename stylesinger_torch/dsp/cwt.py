"""Continuous wavelet transform of log-F0 (Mexican-hat / DOG(2) mother);
port of ``stylesinger_tpu/dsp/cwt.py``.

The reference (``utils/cwt.py``) uses ``pycwt.wavelet.MexicanHat`` with
dt=0.005, dj=1, s0=0.01, J=9 (10 dyadic scales) and a heuristic
``inverse_cwt``.  As in the JAX package, the forward transform is the
Torrence & Compo (1998) FFT formulation: one batched rfft / irfft over
every scale at once, on the tensor's device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from scipy.special import gamma as _gamma

_DT = 0.005
_DJ = 1.0
_S0 = 2 * _DT
_J = 9
_M = 2  # DOG order (Mexican hat)


def cwt_scales(dt: float = _DT, dj: float = _DJ, s0: float = _S0,
               n_scales: int = _J + 1) -> np.ndarray:
    return s0 * 2.0 ** (dj * np.arange(n_scales))


def cont_lf0_np(f0: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Continuous log-F0: unvoiced gaps filled by interpolation (the ends
    by the nearest voiced value), then log; returns (uv, lf0)."""
    f0 = np.asarray(f0, dtype=np.float64).copy()
    uv = (f0 == 0).astype(np.float32)
    if (f0 == 0).all():
        return uv, f0
    nz = np.where(f0 != 0)[0]
    f0[: nz[0]] = f0[nz[0]]
    f0[nz[-1]:] = f0[nz[-1]]
    nz = np.where(f0 != 0)[0]
    f0 = np.interp(np.arange(len(f0)), nz, f0[nz])
    return uv, np.log(f0)


def cwt_mexican_hat(x: torch.Tensor, dt: float = _DT, dj: float = _DJ,
                    s0: float = _S0, n_scales: int = _J + 1) -> torch.Tensor:
    """CWT of [..., T] -> [..., T, n_scales] (real part, DOG m=2 mother):
    W_n(s) = irfft(rfft(x) * psi_hat(s * w)), psi_hat normalized to unit
    energy, sqrt(2 pi s / dt) * w^2 exp(-w^2 / 2) / sqrt(gamma(5 / 2)),
    in ``x``'s dtype."""
    n = x.shape[-1]
    dtype, dev = x.dtype, x.device
    scales = torch.as_tensor(cwt_scales(dt, dj, s0, n_scales), dtype=dtype,
                             device=dev)
    k = torch.arange(n // 2 + 1, device=dev).to(dtype)
    omega = 2.0 * np.pi * k / (n * dt)
    sw = scales[:, None] * omega[None, :]                      # [S, F]
    norm = torch.sqrt(2.0 * np.pi * scales / dt)
    psi_hat = norm[:, None] * (sw ** _M) * torch.exp(-0.5 * sw ** 2) \
        / float(np.sqrt(_gamma(_M + 0.5)))
    xh = torch.fft.rfft(x, dim=-1)
    w = torch.fft.irfft(xh[..., None, :] * psi_hat, n=n, dim=-1)
    return w.transpose(-1, -2)


def inverse_cwt(wavelet_lf0: torch.Tensor, n_scales: int = _J + 1
                ) -> torch.Tensor:
    """The reference's heuristic reconstruction (``utils/cwt.py:118-133``):
    a scale-weighted sum, then per-sequence standardization (population
    std).  [..., T, S] -> [..., T]."""
    b = (torch.arange(n_scales, dtype=wavelet_lf0.dtype,
                      device=wavelet_lf0.device) + 1.0 + 2.5) ** (-2.5)
    rec = (wavelet_lf0 * b).sum(-1)
    mean = rec.mean(-1, keepdim=True)
    std = rec.std(-1, correction=0, keepdim=True)
    return (rec - mean) / torch.clamp_min(std, 1e-8)


def cwt2f0(cwt_spec: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
           n_scales: int = _J + 1) -> torch.Tensor:
    """[B, T, S] CWT spectrogram + per-utterance (mean, std) -> f0 Hz
    [B, T]."""
    lf0 = inverse_cwt(cwt_spec, n_scales)
    return torch.exp(lf0 * std[:, None] + mean[:, None])
