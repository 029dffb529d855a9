"""Denoisers (port of ``stylesinger_tpu/models/diffnet.py``), batch-first:
the DiffWave-style ``DiffNet`` (mel), ``DDiffNet`` (joint f0 + uv),
``F0DiffNet`` (f0 alone) and ``MDiffNet`` (uv alone), and the transformer
``FFTDenoiser`` (mel, ``diff_decoder_type: fft``).  Under
``compute_dtype: bfloat16`` the layers take the compute dtype where the JAX
layers do (``models/precision.py``); the output heads stay f32.

For inference a residual layer goes to the CUDA kernel of
``kernels/diffnet.py`` when the layer's shape and its tensors allow
(``ResidualBlock.takes_kernel``); a sampler's caller enters
:func:`cond_cache` around its chain, so that each layer projects the
unchanging conditioner once per chain."""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from stylesinger_torch.kernels import diffnet as layer_kernel
from stylesinger_torch.models import precision
from stylesinger_torch.models.common import Conv, Dense, FastspeechDecoder
from stylesinger_torch.models.precision import const

_COND_CACHE: Optional[dict] = None  # inside cond_cache(): layer -> (cond, cp)


@contextlib.contextmanager
def cond_cache():
    """Inside, a residual layer on the kernel keeps its conditioner
    projection (``kernels/diffnet.py::cond_projection``) for the ``cond``
    tensor it was computed from and reuses it while it is called with that
    same tensor: the sampler's chain calls every layer with one ``cond``
    at every step.  Entered around a chain by its caller."""
    global _COND_CACHE
    old, _COND_CACHE = _COND_CACHE, {}
    try:
        yield
    finally:
        _COND_CACHE = old


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal diffusion-step embedding: t [B] -> [B, dim]."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000) * torch.arange(
        half, device=t.device, dtype=torch.float32) / (half - 1))
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


class DiffusionStepMLP(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.fc1 = Dense(dim, 4 * dim, compute=True)
        self.fc2 = Dense(4 * dim, dim, compute=True)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.fc2(mish(self.fc1(timestep_embedding(t, self.dim))))


class ResidualBlock(nn.Module):
    """Gated dilated-conv residual block."""

    def __init__(self, channels: int, cond_dim: int, dilation: int):
        super().__init__()
        self.channels = channels
        self.diffusion_projection = Dense(channels, channels, compute=True)
        self.dilated_conv = Conv(channels, 2 * channels, 3, dilation=dilation,
                                 compute=True)
        self.conditioner_projection = Conv(cond_dim, 2 * channels, 1,
                                           compute=True)
        self.output_projection = Conv(channels, 2 * channels, 1,
                                      compute=True)

    def forward(self, x, cond, step_emb):
        c = self.channels
        x = precision.cast(x)
        y = x + self.diffusion_projection(step_emb)[:, None, :]
        y = self.dilated_conv(y) + self.conditioner_projection(cond)
        y = torch.sigmoid(y[..., :c]) * torch.tanh(y[..., c:])
        y = self.output_projection(y)
        return (x + y[..., :c]) / const(math.sqrt(2.0), y.dtype), y[..., c:]

    def takes_kernel(self, x, cond, step_emb) -> bool:
        """Whether this call goes to the kernel: its shape
        (``layer_kernel.takes_layer``) and its tensors
        (``layer_kernel.engages``) allow."""
        conv = self.dilated_conv
        return (layer_kernel.takes_layer(self.channels, conv.weight.shape[-1],
                                         conv.dilation) and
                layer_kernel.engages([x, cond, step_emb,
                                      *self.parameters()]))

    def fused(self, x, cond, step_emb, skips):
        """The layer on the kernel: returns its output, and the skip sum
        with this layer's skip added (in place; ``skips`` a float starts
        the sum)."""
        x = x.contiguous()
        first = not isinstance(skips, torch.Tensor)
        if first:
            skips = torch.empty_like(x)
        cache = _COND_CACHE
        hit = None if cache is None else cache.get(id(self))
        if hit is not None and hit[0] is cond:
            cp = hit[1]
        else:
            cp = layer_kernel.cond_projection(
                cond, self.conditioner_projection.weight,
                self.conditioner_projection.bias, self.dilated_conv.bias)
            if cache is not None:
                cache[id(self)] = (cond, cp)
        x = layer_kernel.diffnet_layer(
            x, self.diffusion_projection(step_emb), cp,
            self.dilated_conv.weight, self.output_projection.weight,
            self.output_projection.bias, skips,
            dilation=self.dilated_conv.dilation, first=first)
        return x, skips


class _Stack(nn.Module):
    """The residual stack shared by both denoisers."""

    def __init__(self, channels: int, cond_dim: int, out_dims: int,
                 residual_layers: int, dilation_cycle_length: int):
        super().__init__()
        self.residual_layers = residual_layers
        self.mlp = DiffusionStepMLP(channels)
        for i in range(residual_layers):
            setattr(self, f"residual_{i}", ResidualBlock(
                channels, cond_dim, 2 ** (i % dilation_cycle_length)))
        self.skip_projection = Conv(channels, channels, 1, compute=True)
        self.output_projection = Conv(channels, out_dims, 1, compute=False)

    def run(self, x, t, cond):
        step_emb = self.mlp(t)
        skips = 0.0
        for i in range(self.residual_layers):
            layer = getattr(self, f"residual_{i}")
            if layer.takes_kernel(x, cond, step_emb):
                x, skips = layer.fused(x, cond, step_emb, skips)
                continue
            x, skip = layer(x, cond, step_emb)
            skips = skips + skip
        x = F.relu(self.skip_projection(
            skips / const(math.sqrt(self.residual_layers), skips.dtype)))
        return self.output_projection(x)


class DiffNet(_Stack):
    """Mel denoiser: spec [B, T, M], t [B], cond [B, T, H] -> eps."""

    def __init__(self, in_dims: int = 80, cond_dim: int = 256,
                 residual_layers: int = 20, residual_channels: int = 256,
                 dilation_cycle_length: int = 4):
        super().__init__(residual_channels, cond_dim, in_dims,
                         residual_layers, dilation_cycle_length)
        self.input_projection = Conv(in_dims, residual_channels, 1,
                                     compute=True)

    def forward(self, spec, t, cond):
        return self.run(F.relu(self.input_projection(spec)), t, cond)


class DDiffNet(_Stack):
    """Joint f0 + uv denoiser: f0 [B, T, 1], uv int [B, T], t [B], cond,
    nonpadding [B, T] -> [B, T, 1 + num_classes]."""

    def __init__(self, in_dims: int = 1, num_classes: int = 2,
                 cond_dim: int = 256, residual_layers: int = 10,
                 residual_channels: int = 192,
                 dilation_cycle_length: int = 4):
        super().__init__(residual_channels, cond_dim, in_dims + num_classes,
                         residual_layers, dilation_cycle_length)
        self.input_projection = Conv(in_dims, residual_channels // 2, 1,
                                     compute=True)
        self.uv_embed = nn.Embedding(num_classes, residual_channels // 2)

    def forward(self, f0, uv, t, cond, nonpadding):
        mask = precision.cast(nonpadding[..., None])
        x = torch.cat([self.input_projection(f0),
                       precision.cast(self.uv_embed(uv))], dim=-1) * mask
        return self.run(x, t, cond) * nonpadding[..., None]


class F0DiffNet(_Stack):
    """Gaussian F0 denoiser without uv: f0 [B, T, in_dims], t [B], cond,
    nonpadding [B, T] -> [B, T, in_dims].  Its input and skip projections
    take no compute dtype (flax ``Conv()``)."""

    def __init__(self, in_dims: int = 1, cond_dim: int = 256,
                 residual_layers: int = 10, residual_channels: int = 192,
                 dilation_cycle_length: int = 4):
        super().__init__(residual_channels, cond_dim, in_dims,
                         residual_layers, dilation_cycle_length)
        self.input_projection = Conv(in_dims, residual_channels, 1)
        self.skip_projection.compute = False

    def forward(self, f0, t, cond, nonpadding):
        mask = nonpadding[..., None]
        x = F.relu(self.input_projection(f0) * mask)
        return self.run(x, t, cond) * mask


class MDiffNet(_Stack):
    """Categorical uv denoiser: uv int [B, T], t [B], cond, nonpadding
    [B, T] -> class logits [B, T, num_classes]; the uv embedding is a flax
    ``nn.Embed`` (no padding row)."""

    def __init__(self, num_classes: int = 2, cond_dim: int = 256,
                 residual_layers: int = 10, residual_channels: int = 192,
                 dilation_cycle_length: int = 4):
        super().__init__(residual_channels, cond_dim, num_classes,
                         residual_layers, dilation_cycle_length)
        self.uv_embed = nn.Embedding(num_classes, residual_channels)
        self.skip_projection.compute = False

    def forward(self, uv, t, cond, nonpadding):
        mask = nonpadding[..., None]
        return self.run(self.uv_embed(uv) * mask, t, cond) * mask


class FFTDenoiser(nn.Module):
    """Transformer mel denoiser: spec [B, T, M] + t [B] + cond [B, T, H] ->
    [B, T, M].  A 1x1 input projection, the diffusion-step MLP, one dense
    over [x | cond | step], a FastSpeech decoder stack whose padding is
    read off the (masked) conditioner, and a mel head."""

    def __init__(self, in_dims: int = 80, hidden_size: int = 256,
                 residual_channels: int = 256, num_layers: int = 4,
                 kernel_size: int = 9, num_heads: int = 2,
                 dropout: float = 0.1):
        super().__init__()
        dim = residual_channels
        self.input_projection = Conv(in_dims, dim, 1, compute=False)
        self.mlp = DiffusionStepMLP(dim)
        self.get_decode_inp = Dense(2 * dim + hidden_size, hidden_size)
        self.decoder = FastspeechDecoder(hidden_size, num_layers,
                                         kernel_size, num_heads=num_heads,
                                         dropout=dropout)
        self.get_mel_out = Dense(hidden_size, in_dims)

    def forward(self, spec, t, cond, drop=None):
        x = self.input_projection(spec)
        step = self.mlp(t)[:, None, :].expand(-1, x.shape[1], -1)
        h = self.get_decode_inp(torch.cat([x, cond, step], dim=-1))
        nonpadding = (cond.abs().sum(-1) > 1e-8).to(torch.float32)
        return self.get_mel_out(self.decoder(h, nonpadding, drop))
