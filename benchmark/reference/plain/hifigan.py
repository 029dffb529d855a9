"""NSF HiFi-GAN generator (frozen from the port's ``models/hifigan.py``).

conv_pre -> per stage [leaky_relu -> ConvTranspose upsample (torch padding
(k-u)//2, cropped to exactly T*u) -> + NSF harmonic source through a strided
noise conv -> MRF group] -> leaky_relu(0.01) -> conv_post -> tanh.

MRF groups run over overlap-save blocks when the stage is at least two
blocks long.  A blocked group goes through the MRF kernel
(``kernels/mrf.py``, its plain twin on CPU tensors) when the kernel takes
its shape: ``ResBlock1``, C <= 128 and every (k - 1) * d <= 64
(:meth:`HifiGanGenerator.mrf_route`, a function of the config and the
stage's length, as JAX routes by shape at ``models/hifigan.py:317``); every
other group runs the resblock modules.  ``resblock: "2"`` always runs the
modules.  ``vocoder_compute_dtype: bfloat16`` runs every conv in bf16 (the
MRF kernel in its bf16 mode), with the harmonic source and the final tanh
in f32, as the JAX generator does.  Batch-first [B, T, C].

The generator trains: under autograd every blocked stage runs the resblock
modules, since the MRF kernel has no backward.  The discriminators of
vocoder GAN training (``MultiPeriodDiscriminator``,
``MultiScaleDiscriminator``) and the LSGAN and feature-matching losses
follow; they are channel-first inside ([B, C, T] and [B, C, H, p]), with
flax's SAME padding written out where a stride makes it asymmetric.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .kernels_plain import fused_mrf_blocks, takes_stage
from . import precision
from .common import Conv

LRELU_SLOPE = 0.1
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LRELU_SLOPE)


def blocked_phase_cumsum(rad: torch.Tensor, block: int) -> torch.Tensor:
    """Phase integration [B, T, D] -> fractional phase: exact cumsum inside
    each block of ``block`` samples, mod-1 running offsets across blocks."""
    b, t, d = rad.shape
    r = rad.reshape(b, t // block, block, d)
    within = torch.cumsum(r, dim=2)
    block_sum = torch.remainder(within[:, :, -1, :], 1.0)
    offsets = torch.remainder(torch.cumsum(block_sum, dim=1) - block_sum, 1.0)
    return (within + offsets[:, :, None, :]).reshape(b, t, d)


class SourceModuleHnNSF(nn.Module):
    """Harmonic sine bank -> tanh(linear) single-channel excitation."""

    def __init__(self, sampling_rate: int, harmonic_num: int = 8,
                 sine_amp: float = 0.1, noise_std: float = 0.003,
                 voiced_threshold: float = 0.0, hop_size: int = 256):
        super().__init__()
        self.sampling_rate = sampling_rate
        self.dim = harmonic_num + 1
        self.sine_amp = sine_amp
        self.noise_std = noise_std
        self.voiced_threshold = voiced_threshold
        self.hop_size = hop_size
        self.merge = nn.Linear(self.dim, 1)

    def forward(self, f0_up: torch.Tensor, noise) -> torch.Tensor:
        """f0_up [B, T_samples] (Hz, 0 = unvoiced) -> excitation [B, T, 1].
        Draws: uniform [B, D] (initial phases), normal [B, T, D]."""
        harmonics = torch.arange(1, self.dim + 1, dtype=torch.float32,
                                 device=f0_up.device)
        rad = torch.remainder(f0_up[..., None] * harmonics /
                              self.sampling_rate, 1.0)
        rand_ini = noise.uniform((f0_up.shape[0], self.dim))
        # the fundamental starts at phase 0 (not in place: a draw may be a
        # caller's tensor, TensorNoise)
        rand_ini = torch.cat([torch.zeros_like(rand_ini[:, :1]),
                              rand_ini[:, 1:]], dim=1)
        rad[:, 0, :] = rad[:, 0, :] + rand_ini
        phase = blocked_phase_cumsum(rad, self.hop_size)
        sines = torch.sin(2 * math.pi * phase) * self.sine_amp
        uv = (f0_up > self.voiced_threshold).to(torch.float32)[..., None]
        noise_amp = uv * self.noise_std + (1 - uv) * self.sine_amp / 3
        sines = sines * uv + noise_amp * noise.normal(sines.shape)
        return torch.tanh(self.merge(sines))


class ResBlock1(nn.Module):
    """3 x [lrelu -> dilated conv -> lrelu -> conv]; ``mask`` zeroes conv
    inputs outside the true signal (overlap-save blocks)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Tuple[int, ...] = (1, 3, 5)):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilations = tuple(dilations)
        for i, d in enumerate(self.dilations):
            setattr(self, f"conv1_{i}",
                    Conv(channels, channels, kernel_size, dilation=d,
                         compute=True))
            setattr(self, f"conv2_{i}", Conv(channels, channels, kernel_size,
                                             compute=True))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for i in range(len(self.dilations)):
            y = _lrelu(x)
            y = getattr(self, f"conv1_{i}")(y if mask is None else y * mask)
            y = _lrelu(y)
            y = getattr(self, f"conv2_{i}")(y if mask is None else y * mask)
            x = x + y
        return x

    def kernel_weights(self):
        """((kernel1, bias1), (kernel2, bias2)) per dilation, kernels in the
        MRF kernel's [k, C_in, C_out] layout."""
        def kb(conv):
            return conv.weight.permute(2, 1, 0).contiguous(), conv.bias
        return [(kb(getattr(self, f"conv1_{i}")),
                 kb(getattr(self, f"conv2_{i}")))
                for i in range(len(self.dilations))]

    @staticmethod
    def halo(kernel_size: int, dilations: Sequence[int]) -> int:
        return (kernel_size - 1) // 2 * sum(d + 1 for d in dilations)


class ResBlock2(nn.Module):
    """2 x [lrelu -> dilated conv] (JAX ``models/hifigan.py:157``)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Tuple[int, ...] = (1, 3)):
        super().__init__()
        self.dilations = tuple(dilations)
        for i, d in enumerate(self.dilations):
            setattr(self, f"conv_{i}",
                    Conv(channels, channels, kernel_size, dilation=d,
                         compute=True))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for i in range(len(self.dilations)):
            y = _lrelu(x)
            x = x + getattr(self, f"conv_{i}")(y if mask is None else y * mask)
        return x

    @staticmethod
    def halo(kernel_size: int, dilations: Sequence[int]) -> int:
        return (kernel_size - 1) // 2 * sum(dilations)


def _blockify(x: torch.Tensor, block: int, halo: int
              ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """[B, T, C] -> ([B*nb, block+2*halo, C], validity mask, T)."""
    b, t, c = x.shape
    nb = -(-t // block)
    length = block + 2 * halo
    xp = F.pad(x, (0, 0, halo, nb * block - t + halo))
    xb = xp.unfold(1, length, block).permute(0, 1, 3, 2).reshape(
        b * nb, length, c).contiguous()
    idx = (torch.arange(nb, device=x.device)[:, None] * block +
           torch.arange(length, device=x.device)[None, :])
    valid = ((idx >= halo) & (idx < halo + t)).to(x.dtype)
    return xb, valid.repeat(b, 1)[..., None].contiguous(), t


def _unblockify(yb: torch.Tensor, b: int, block: int, halo: int,
                t: int) -> torch.Tensor:
    """Crop halos and restore [B, T, C]."""
    bn, _, c = yb.shape
    return yb[:, halo:halo + block].reshape(b, (bn // b) * block, c)[:, :t]


class ConvTranspose(nn.Module):
    """torch ConvTranspose1d(k, stride=u, padding, output_padding) on
    [B, T, C]; the padding defaults to (k-u)//2."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, stride: int,
                 padding: Optional[int] = None, output_padding: int = 0):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_in, c_out, kernel_size))
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.stride = stride
        self.padding = (kernel_size - stride) // 2 if padding is None \
            else padding
        self.output_padding = output_padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose1d(
            x.transpose(1, 2), self.weight.to(x.dtype),
            self.bias.to(x.dtype), self.stride, self.padding,
            self.output_padding).transpose(1, 2)


class HifiGanGenerator(nn.Module):
    """mel [B, T, M] + f0 [B, T] -> wav [B, T * prod(upsample_rates)].

    Raises on a ``vocoder_compute_dtype`` other than float32 or bfloat16.
    The MRF kernel raises on C > 128 or a reach (k - 1) * d > 64, so
    :meth:`mrf_route` sends such stages to the resblock modules."""

    def __init__(self, cfg: Any, c_out: int = 1):
        super().__init__()
        c = self.cfg = cfg
        name = c.get("vocoder_compute_dtype", "float32")
        if name not in COMPUTE_DTYPES:
            raise NotImplementedError(f"vocoder_compute_dtype {name!r}: "
                                      "only float32 and bfloat16 run")
        self.dtype = COMPUTE_DTYPES[name]
        self.resblock_cls = ResBlock1 if str(c.get("resblock", "1")) == "1" \
            else ResBlock2
        self.use_nsf = bool(c.get("use_nsf", True))
        self.rates = tuple(c["upsample_rates"])
        self.rk = tuple(c["resblock_kernel_sizes"])
        self.rd = tuple(tuple(d) for d in c["resblock_dilation_sizes"])
        ch0 = c["upsample_initial_channel"]
        total_up = int(np.prod(self.rates))
        if self.use_nsf:
            self.m_source = SourceModuleHnNSF(
                sampling_rate=c["audio_sample_rate"],
                harmonic_num=c.get("harmonic_num", 8), hop_size=total_up)
        self.conv_pre = Conv(c["audio_num_mel_bins"], ch0, 7, compute=True)
        for i, (u, k) in enumerate(zip(self.rates,
                                       c["upsample_kernel_sizes"])):
            c_prev, c_cur = ch0 // (2 ** i), ch0 // (2 ** (i + 1))
            setattr(self, f"up_{i}", ConvTranspose(c_prev, c_cur, k, u))
            if self.use_nsf:
                s = int(np.prod(self.rates[i + 1:]))
                setattr(self, f"noise_conv_{i}", Conv(
                    1, c_cur, 2 * s, stride=s, padding=(s // 2, s // 2),
                    compute=True) if i + 1 < len(self.rates)
                    else Conv(1, c_cur, 1, compute=True))
            for j, (rk, rd) in enumerate(zip(self.rk, self.rd)):
                setattr(self, f"resblock_{i}_{j}",
                        self.resblock_cls(c_cur, rk, rd))
        self.conv_post = Conv(ch0 // (2 ** len(self.rates)), c_out, 7,
                              compute=True)
        self.mrf_block = int(c.get("mrf_block", 2048))
        self.mrf_halo = max(self.resblock_cls.halo(k, d)
                            for k, d in zip(self.rk, self.rd))

    def mrf_route(self, i: int, t_stage: int, grad: bool = False) -> str:
        """Where stage i's MRF group runs for a stage of ``t_stage``
        samples: "kernel" (the MRF kernel over overlap-save blocks),
        "blocks" (the resblock modules over the same blocks) or "modules"
        (the resblock modules over the whole stage, shorter than two
        blocks).  ``grad``: autograd records the stage (the kernel has no
        backward, so such a stage runs "blocks", as JAX's trainer runs XLA
        convs where the Pallas kernel would have no VJP)."""
        if not (self.mrf_block and t_stage >= 2 * self.mrf_block):
            return "modules"
        c = self.cfg["upsample_initial_channel"] // (2 ** (i + 1))
        if not grad and self.resblock_cls is ResBlock1 and takes_stage(
                c, self.rk, self.rd):
            return "kernel"
        return "blocks"

    def mrf_routes(self, n_frames: int, grad: bool = False):
        """:meth:`mrf_route` of every stage for a mel of ``n_frames``."""
        return [self.mrf_route(i, n_frames * int(np.prod(self.rates[:i + 1])),
                               grad) for i in range(len(self.rates))]

    def _mrf(self, i: int, x: torch.Tensor) -> torch.Tensor:
        blocks = [getattr(self, f"resblock_{i}_{j}")
                  for j in range(len(self.rk))]
        block, halo = self.mrf_block, self.mrf_halo
        grad = torch.is_grad_enabled() and (x.requires_grad or any(
            p.requires_grad for blk in blocks for p in blk.parameters()))
        route = self.mrf_route(i, x.shape[1], grad)
        if route == "modules":
            return sum(blk(x) for blk in blocks) / len(blocks)
        xb, mask, t = _blockify(x, block, halo)
        if route == "kernel":
            yb = fused_mrf_blocks(
                xb, mask, [blk.kernel_weights() for blk in blocks],
                kernels=self.rk, dilations=self.rd, block=block, halo=halo,
                compute_dtype=x.dtype)
            return _unblockify(yb, x.shape[0], block, 0, t)
        acc = None
        for blk in blocks:
            y = blk(xb, mask)
            acc = y if acc is None else acc + y
        return _unblockify(acc / len(blocks), x.shape[0], block, halo, t)

    def forward(self, mel: torch.Tensor, f0: Optional[torch.Tensor],
                noise) -> torch.Tensor:
        """Draws (with NSF): the harmonic source's uniform, then normal.
        Differentiable: under autograd every MRF group runs the resblock
        modules (:meth:`mrf_route`); inference callers run it under
        ``torch.no_grad()``.  The convs run in ``vocoder_compute_dtype``
        (``precision.activation_dtype``)."""
        total_up = int(np.prod(self.rates))
        har = None
        if self.use_nsf and f0 is not None:
            har = self.m_source(torch.repeat_interleave(f0, total_up, dim=-1),
                                noise).to(self.dtype)
        with precision.activation_dtype(self.dtype):
            x = self.conv_pre(mel.to(self.dtype))
            for i, u in enumerate(self.rates):
                x = getattr(self, f"up_{i}")(_lrelu(x))
                tgt = mel.shape[1] * int(np.prod(self.rates[: i + 1]))
                if x.shape[1] != tgt:
                    x = x[:, :tgt] if x.shape[1] > tgt else F.pad(
                        x, (0, 0, 0, tgt - x.shape[1]))
                if har is not None:
                    x = x + getattr(self, f"noise_conv_{i}")(har)[
                        :, : x.shape[1]]
                x = self._mrf(i, x)
            x = self.conv_post(F.leaky_relu(x, 0.01))
        return torch.tanh(x.float())[..., 0]
