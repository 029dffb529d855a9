"""The alternative vocoders (port of
``stylesinger_tpu/models/legacy_vocoders.py``): the Parallel WaveGAN and
MelGAN generators and the PQMF sub-band filter bank, batch-first [B, T, C]
with the flax names of the JAX modules.

- ``ParallelWaveGANGenerator``: a non-causal WaveNet driven by Gaussian
  noise [B, T * hop, 1] and conditioned on the upsampled mel.  JAX draws
  the noise inside the module (``make_rng("noise")``); the port takes it
  as ``noise``: a tensor, or a source whose ``normal(shape)`` gives it
  (``models/diffusion.py::Noise``).  Each ``upsample_net.up_conv_<i>`` is a
  raw parameter of flax shape (2s+1, 1, 1): one smoothing kernel shared by
  every mel bin, which ``from_jax_params`` carries over as it is.
- ``MelGANGenerator``: reflection-padded convs, per-scale transposed convs
  (torch ``ConvTranspose1d(2r, r, r//2 + r%2, output_padding=r%2)``, flax's
  ``ConvTranspose(transpose_kernel=True)`` with kernel [k, out, in]), three
  residual stacks per scale, tanh.
- ``PQMF``: analysis and synthesis as 1-D convolutions over fixed numpy
  filters (a Kaiser-windowed sinc prototype).
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from stylesinger_torch.models.common import Conv, Dense
from stylesinger_torch.models.hifigan import ConvTranspose

MELGAN_LRELU = 0.2


# ---------------------------------------------------------------------------
# PQMF
# ---------------------------------------------------------------------------

def design_prototype_filter(taps: int = 62, cutoff: float = 0.142,
                            beta: float = 9.0) -> np.ndarray:
    """Kaiser-windowed sinc lowpass prototype, [taps + 1] (f64)."""
    assert taps % 2 == 0
    n = np.arange(taps + 1) - taps / 2
    with np.errstate(invalid="ignore", divide="ignore"):
        h_i = np.sin(np.pi * cutoff * n) / (np.pi * cutoff * n)
    h_i[taps // 2] = 1.0
    w = np.i0(beta * np.sqrt(1 - (2 * np.arange(taps + 1) / taps - 1) ** 2)) \
        / np.i0(beta)
    return (h_i * cutoff * w).astype(np.float64)


class PQMF(nn.Module):
    """Analysis / synthesis filter bank over ``subbands`` channels."""

    def __init__(self, subbands: int = 4, taps: int = 62,
                 cutoff: float = 0.142, beta: float = 9.0):
        super().__init__()
        h_proto = design_prototype_filter(taps, cutoff, beta)
        n = np.arange(taps + 1) - taps / 2
        h_analysis = np.zeros((subbands, taps + 1))
        h_synthesis = np.zeros((subbands, taps + 1))
        for k in range(subbands):
            arg = (2 * k + 1) * (np.pi / (2 * subbands)) * n
            phi = (-1) ** k * np.pi / 4
            h_analysis[k] = 2 * h_proto * np.cos(arg + phi)
            h_synthesis[k] = 2 * h_proto * np.cos(arg - phi)
        self.subbands = subbands
        self.taps = taps
        self.register_buffer("h_analysis", torch.tensor(
            h_analysis, dtype=torch.float32)[:, None, :], persistent=False)
        self.register_buffer("h_synthesis", torch.tensor(
            h_synthesis, dtype=torch.float32)[None], persistent=False)

    def analysis(self, wav: torch.Tensor) -> torch.Tensor:
        """[B, T] -> [B, T // subbands, subbands]."""
        y = F.conv1d(wav[:, None, :], self.h_analysis, stride=self.subbands,
                     padding=self.taps // 2)
        return y.transpose(1, 2)

    def synthesis(self, subband: torch.Tensor) -> torch.Tensor:
        """[B, T', subbands] -> [B, T' * subbands]: each band zero-stuffed
        to the full rate (times ``subbands``), filtered and summed."""
        b, t, s = subband.shape
        up = subband.new_zeros(b, s, t * s)
        up[:, :, ::s] = subband.transpose(1, 2) * s
        return F.conv1d(up, self.h_synthesis, padding=self.taps // 2)[:, 0]


# ---------------------------------------------------------------------------
# Parallel WaveGAN generator
# ---------------------------------------------------------------------------

def pwg_upsample_scales(cfg: Any) -> Tuple[int, ...]:
    """The conditioning upsample factors: ``pwg_upsample_scales``, else the
    hop size in factors of 4 (at most three) and the rest (4, 4, 4, 4 for
    hop 256)."""
    scales = cfg.get("pwg_upsample_scales")
    if scales:
        return tuple(int(s) for s in scales)
    n, out = int(cfg["hop_size"]), []
    for _ in range(3):
        if n % 4 == 0:
            out.append(4)
            n //= 4
    if n > 1:
        out.append(n)
    return tuple(out)


class PWGUpsampleNetwork(nn.Module):
    """A VALID conv over 2 * aux_context_window + 1 frames (it consumes the
    edge pad), then per scale a nearest-neighbour stretch in time and one
    (2s+1)-tap smoothing kernel shared by every mel bin."""

    def __init__(self, scales: Sequence[int], aux_channels: int,
                 aux_context_window: int = 2):
        super().__init__()
        self.scales = tuple(scales)
        w = aux_context_window
        self.conv_in = Conv(aux_channels, aux_channels, 2 * w + 1,
                            padding=(0, 0), bias=False)
        for i, s in enumerate(self.scales):
            setattr(self, f"up_conv_{i}", nn.Parameter(
                torch.full((2 * s + 1, 1, 1), 1.0 / (2 * s + 1))))

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        """c [B, T_mel + 2w, M] (edge-padded) -> [B, T_mel * hop, M]."""
        c = self.conv_in(c)
        for i, s in enumerate(self.scales):
            b, t, m = c.shape
            c = c.repeat_interleave(s, dim=1)
            k = getattr(self, f"up_conv_{i}").reshape(1, 1, 2 * s + 1)
            y = F.conv1d(c.transpose(1, 2).reshape(b * m, 1, t * s),
                         k.to(c.dtype), padding=s)
            c = y.reshape(b, m, t * s).transpose(1, 2)
        return c


class PWGResidualBlock(nn.Module):
    """Gated dilated conv + the aux conv of the conditioning, split into a
    residual (scaled by sqrt(1/2)) and a skip."""

    def __init__(self, residual_channels: int = 64, gate_channels: int = 128,
                 skip_channels: int = 64, aux_channels: int = 80,
                 kernel_size: int = 3, dilation: int = 1):
        super().__init__()
        half = gate_channels // 2
        self.conv = Conv(residual_channels, gate_channels, kernel_size,
                         dilation=dilation)
        self.aux = Conv(aux_channels, gate_channels, 1, bias=False)
        self.res = Conv(half, residual_channels, 1)
        self.skip = Conv(half, skip_channels, 1)

    def forward(self, x: torch.Tensor, c: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.conv(x) + self.aux(c)
        a, b = h.chunk(2, dim=-1)
        z = torch.tanh(a) * torch.sigmoid(b)
        return (x + self.res(z)) * math.sqrt(0.5), self.skip(z)


class ParallelWaveGANGenerator(nn.Module):
    """Noise + upsampled mel -> wav [B, T_mel * hop]; the last 1x1 conv's
    output as it is (no tanh)."""

    def __init__(self, cfg: Any, layers: int = 30, stacks: int = 3,
                 residual_channels: int = 64, gate_channels: int = 128,
                 skip_channels: int = 64, aux_context_window: int = 2,
                 use_pitch_embed: bool = False):
        super().__init__()
        self.cfg = cfg
        self.layers = layers
        self.use_pitch_embed = use_pitch_embed
        self.aux_context_window = aux_context_window
        self.scales = pwg_upsample_scales(cfg)
        m = cfg["audio_num_mel_bins"]
        if use_pitch_embed:
            self.pitch_embed = nn.Embedding(300, m)
            self.c_proj = Dense(2 * m, m)
        self.upsample_net = PWGUpsampleNetwork(self.scales, m,
                                               aux_context_window)
        self.first = Conv(1, residual_channels, 1)
        per_stack = layers // stacks
        for i in range(layers):
            setattr(self, f"block_{i}", PWGResidualBlock(
                residual_channels, gate_channels, skip_channels, m, 3,
                2 ** (i % per_stack)))
        self.post1 = Conv(skip_channels, skip_channels, 1)
        self.post2 = Conv(skip_channels, 1, 1)

    @property
    def hop(self) -> int:
        return int(np.prod(self.scales))

    def forward(self, mel: torch.Tensor, noise: Union[torch.Tensor, Any],
                pitch: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mel [B, T_mel, M] (feature-stats normalized by the wrapper for an
        official checkpoint), ``noise`` [B, T_mel * hop, 1] or its source,
        coarse pitch [B, T_mel] ints -> wav [B, T_mel * hop]."""
        b, t_mel, _ = mel.shape
        if not isinstance(noise, torch.Tensor):
            noise = noise.normal((b, t_mel * self.hop, 1))
        c = mel
        if self.use_pitch_embed and pitch is not None:
            c = self.c_proj(torch.cat([c, self.pitch_embed(pitch)], -1))
        w = self.aux_context_window
        c = F.pad(c.transpose(1, 2), (w, w), mode="replicate").transpose(1, 2)
        c = self.upsample_net(c)
        x = self.first(noise.to(mel.dtype))
        skips = 0.0
        for i in range(self.layers):
            x, s = getattr(self, f"block_{i}")(x, c)
            skips = skips + s
        y = F.relu(skips * math.sqrt(1.0 / self.layers))
        y = self.post2(F.relu(self.post1(y)))
        return y[..., 0]


# ---------------------------------------------------------------------------
# MelGAN generator
# ---------------------------------------------------------------------------

def _reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """ReflectionPad1d over the time axis of [B, T, C]."""
    if not p:
        return x
    return F.pad(x.transpose(1, 2), (p, p), mode="reflect").transpose(1, 2)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, MELGAN_LRELU)


class MelGANResidualStack(nn.Module):
    """leaky -> reflection-padded dilated conv -> leaky -> 1x1 conv, plus a
    learned 1x1 skip projection."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: int = 1):
        super().__init__()
        self.pad = (kernel_size - 1) // 2 * dilation
        self.conv1 = Conv(channels, channels, kernel_size, dilation=dilation,
                          padding=(0, 0))
        self.conv2 = Conv(channels, channels, 1)
        self.skip = Conv(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(_reflect_pad(_lrelu(x), self.pad))
        return self.conv2(_lrelu(y)) + self.skip(x)


class MelGANGenerator(nn.Module):
    """mel [B, T, M] -> wav [B, T * prod(rates)] in (-1, 1); the rates are
    ``melgan_upsample_scales``, else ``upsample_rates``."""

    def __init__(self, cfg: Any, base_channels: int = 512, stacks: int = 3,
                 kernel_size: int = 7, stack_kernel_size: int = 3):
        super().__init__()
        self.rates = tuple(cfg.get("melgan_upsample_scales")
                           or cfg["upsample_rates"])
        self.stacks = stacks
        self.pad = (kernel_size - 1) // 2
        self.conv_pre = Conv(cfg["audio_num_mel_bins"], base_channels,
                             kernel_size, padding=(0, 0))
        ch = base_channels
        for i, r in enumerate(self.rates):
            setattr(self, f"up_{i}", ConvTranspose(
                ch, ch // 2, 2 * r, r, padding=r // 2 + r % 2,
                output_padding=r % 2))
            ch //= 2
            for j in range(stacks):
                setattr(self, f"res_{i}_{j}", MelGANResidualStack(
                    ch, stack_kernel_size, stack_kernel_size ** j))
        self.conv_post = Conv(ch, 1, kernel_size, padding=(0, 0))

    @property
    def hop(self) -> int:
        return int(np.prod(self.rates))

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.conv_pre(_reflect_pad(mel, self.pad))
        for i in range(len(self.rates)):
            x = getattr(self, f"up_{i}")(_lrelu(x))
            for j in range(self.stacks):
                x = getattr(self, f"res_{i}_{j}")(x)
        x = self.conv_post(_reflect_pad(_lrelu(x), self.pad))
        return torch.tanh(x)[..., 0]
