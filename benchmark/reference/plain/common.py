"""Shared building blocks (frozen from the port's ``models/common.py``).

Batch-first [B, T, C] like the JAX package.  Submodules and parameters
carry the flax names of the JAX modules (``layer_0``, ``LayerNorm_0``,
``Conv_0``, ...), so ``convert.from_jax_params`` is a plain walk over the
flax tree.  LayerNorms use flax's eps of 1e-6; GELU is the tanh
approximation, as ``jax.nn.gelu`` is by default.

Under ``compute_dtype: bfloat16`` (``models/precision.py``) the layers
follow flax's dtype rules: :class:`Dense`, :class:`Conv` and
:class:`LayerNorm` take ``compute=True`` where the JAX module passes
``dtype=precision.compute_dtype()``, and the blocks cast their inputs and
masks where the JAX blocks call ``precision.cast``.

Dropout sits where the JAX modules have ``nn.Dropout``.  Each ``forward``
takes ``drop``, the step's dropout noise source (``bernoulli(p, shape)``,
``models/diffusion.py::Noise``), or None for the deterministic pass
(inference, validation, or training with dropout off).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from . import precision
from .precision import at_least_f32, const

LN_EPS = 1e-6


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class LayerNorm(nn.LayerNorm):
    """flax ``LayerNorm``: statistics in f32; the result in the compute
    dtype with ``compute=True`` (``LayerNorm(dtype=dt)``), else f32."""

    def __init__(self, dim: int, compute: bool = False):
        super().__init__(dim, eps=LN_EPS)
        self.compute = compute

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(at_least_f32(x), self.normalized_shape, self.weight,
                         self.bias, self.eps)
        dt = precision.compute_dtype() if self.compute else None
        return y if dt is None else y.to(dt)


class Dense(nn.Linear):
    """``nn.Linear`` under flax ``Dense``'s dtype rule: ``compute=True`` is
    ``Dense(dtype=precision.compute_dtype())``, else ``Dense()``, which
    computes in the promotion of its input and its f32 parameters."""

    def __init__(self, c_in: int, c_out: int, bias: bool = True,
                 compute: bool = False):
        super().__init__(c_in, c_out, bias=bias)
        self.compute = compute

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = precision.module_dtype(x, self.weight, self.compute)
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


def dropout(x: torch.Tensor, rate: float, drop) -> torch.Tensor:
    """flax ``nn.Dropout``: keep mask ``bernoulli(1 - rate)`` drawn from
    ``drop``, kept values divided by the keep probability; the identity when
    ``drop`` is None or ``rate`` is 0."""
    if drop is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    return torch.where(drop.bernoulli(keep, x.shape), x / keep,
                       torch.zeros_like(x))


class Conv(nn.Module):
    """1-D conv on [B, T, C] with flax padding semantics: ``"SAME"`` pads
    (k-1)*d split floor-left, or an explicit (left, right) pair.

    ``compute`` is :class:`Dense`'s dtype rule: True is flax
    ``Conv(dtype=precision.compute_dtype())``, False ``Conv()``."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int, *,
                 dilation: int = 1, stride: int = 1,
                 padding: Union[str, Tuple[int, int]] = "SAME",
                 bias: bool = True, compute: bool = False):
        super().__init__()
        self.compute = compute
        self.weight = nn.Parameter(torch.zeros(c_out, c_in, kernel_size))
        self.bias = nn.Parameter(torch.zeros(c_out)) if bias else None
        self.dilation = dilation
        self.stride = stride
        if padding == "SAME":
            total = (kernel_size - 1) * dilation
            padding = (total // 2, total - total // 2)
        self.pad = tuple(padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = precision.module_dtype(x, self.weight, self.compute)
        y = x.to(dt).transpose(1, 2)
        w = self.weight.to(dt)
        b = None if self.bias is None else self.bias.to(dt)
        left, right = self.pad
        if left == right:
            y = F.conv1d(y, w, b, self.stride, left, self.dilation)
        else:
            y = F.conv1d(F.pad(y, (left, right)), w, b, self.stride, 0,
                         self.dilation)
        return y.transpose(1, 2)


def sinusoidal_table(n_positions: int, dim: int,
                     padding_idx: Optional[int] = 0) -> np.ndarray:
    """fairseq sinusoidal table: [sin | cos] concatenated."""
    half = dim // 2
    emb = math.log(10000) / (half - 1)
    emb = np.exp(np.arange(half, dtype=np.float64) * -emb)
    emb = np.arange(n_positions, dtype=np.float64)[:, None] * emb[None, :]
    table = np.concatenate([np.sin(emb), np.cos(emb)], axis=1)
    if dim % 2 == 1:
        table = np.concatenate([table, np.zeros((n_positions, 1))], axis=1)
    if padding_idx is not None:
        table[padding_idx] = 0
    return table.astype(np.float32)


def positions_from_mask(nonpadding: torch.Tensor,
                        padding_idx: int = 0) -> torch.Tensor:
    """fairseq ``make_positions``: pad steps get padding_idx."""
    m = nonpadding.long()
    return torch.cumsum(m, dim=-1) * m + padding_idx


class SinusoidalPositionalEmbedding(nn.Module):
    """Non-learned positional embedding addressed by a nonpadding mask."""

    def __init__(self, dim: int, max_positions: int = 4096,
                 padding_idx: int = 0):
        super().__init__()
        self.padding_idx = padding_idx
        self.register_buffer("table", torch.as_tensor(sinusoidal_table(
            max_positions + padding_idx + 1, dim, padding_idx)),
            persistent=False)

    def forward(self, nonpadding: torch.Tensor) -> torch.Tensor:
        return self.table[positions_from_mask(nonpadding, self.padding_idx)]


class Embedding(nn.Module):
    """Token embedding whose padding row reads as zeros."""

    def __init__(self, num_embeddings: int, features: int,
                 padding_idx: Optional[int] = 0):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(num_embeddings, features))
        self.padding_idx = padding_idx

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        out = F.embedding(ids, self.weight)
        if self.padding_idx is not None:
            out = out * (ids != self.padding_idx).unsqueeze(-1).to(out.dtype)
        return out


class LambdaDense(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.Dense_0 = Dense(c_in, c_out, compute=True)

    def forward(self, x):
        return self.Dense_0(x)


def _masked_softmax(logits: torch.Tensor, kv_mask: torch.Tensor
                    ) -> torch.Tensor:
    neg = torch.finfo(logits.dtype).min
    logits = logits.masked_fill(~(kv_mask[:, None, None, :] > 0), neg)
    return torch.softmax(logits, dim=-1)


class MultiheadSelfAttention(nn.Module):
    """Scaled-dot self-attention without biases; the logits and the softmax
    in f32, the probabilities cast to the compute dtype before ``@ v``."""

    def __init__(self, hidden: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(hidden, 3 * hidden, bias=False, compute=True)
        self.out = Dense(hidden, hidden, bias=False, compute=True)

    def forward(self, x: torch.Tensor, key_padding_mask: torch.Tensor
                ) -> torch.Tensor:
        b, t, c = x.shape
        h = self.num_heads
        d = c // h
        q, k, v = (a.reshape(b, t, h, d).transpose(1, 2)
                   for a in self.qkv(x).split(c, dim=-1))
        logits = at_least_f32(q) @ at_least_f32(k).transpose(-1, -2) / \
            math.sqrt(d)
        probs = _masked_softmax(logits, key_padding_mask)
        out = (precision.cast(probs) @ v).transpose(1, 2).reshape(b, t, c)
        return self.out(out)


class MultiheadCrossAttention(nn.Module):
    """Cross-attention returning head-averaged attention weights (taken
    before the dropout on them)."""

    def __init__(self, hidden: int, num_heads: int, use_bias: bool = True,
                 dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        for name in ("q", "k", "v", "out"):
            setattr(self, name, Dense(hidden, hidden, bias=use_bias))

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor,
                kv_nonpadding: torch.Tensor, drop=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, tq, c = q_in.shape
        tk = kv_in.shape[1]
        h = self.num_heads
        d = c // h
        q = self.q(q_in).reshape(b, tq, h, d).transpose(1, 2)
        k = self.k(kv_in).reshape(b, tk, h, d).transpose(1, 2)
        v = self.v(kv_in).reshape(b, tk, h, d).transpose(1, 2)
        probs = _masked_softmax(q @ k.transpose(-1, -2) / math.sqrt(d),
                                kv_nonpadding)
        out = (dropout(probs, self.dropout, drop) @ v)
        out = out.transpose(1, 2).reshape(b, tq, c)
        return self.out(out), probs.mean(dim=1)


_ACTS = {"gelu": gelu, "relu": F.relu, "swish": F.silu}


class TransformerFFN(nn.Module):
    """conv1d(k) -> * k**-0.5 -> act -> dropout -> dense."""

    def __init__(self, hidden: int, filter_size: int, kernel_size: int = 9,
                 act: str = "gelu", dropout: float = 0.0):
        super().__init__()
        self.kernel_size = kernel_size
        self.act = _ACTS[act]
        self.dropout = dropout
        self.Conv_0 = Conv(hidden, filter_size, kernel_size, compute=True)
        self.LambdaDense_0 = LambdaDense(filter_size, hidden)

    def forward(self, x, drop=None):
        y = self.Conv_0(x)
        y = self.act(y * const(self.kernel_size ** -0.5, y.dtype))
        return self.LambdaDense_0(dropout(y, self.dropout, drop))


class EncSALayer(nn.Module):
    """Pre-LN self-attention block + pre-LN conv-FFN block, masked."""

    def __init__(self, hidden: int, num_heads: int, kernel_size: int = 9,
                 act: str = "gelu", dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        if num_heads > 0:
            self.LayerNorm_0 = LayerNorm(hidden, compute=True)
            self.MultiheadSelfAttention_0 = MultiheadSelfAttention(
                hidden, num_heads)
        ln = "LayerNorm_1" if num_heads > 0 else "LayerNorm_0"
        setattr(self, ln, LayerNorm(hidden, compute=True))
        self._ffn_ln = ln
        self.TransformerFFN_0 = TransformerFFN(hidden, 4 * hidden,
                                               kernel_size, act, dropout)

    def forward(self, x: torch.Tensor, nonpadding: torch.Tensor, drop=None):
        mask = precision.cast(nonpadding[..., None])
        x = precision.cast(x)
        if self.num_heads > 0:
            y = self.MultiheadSelfAttention_0(self.LayerNorm_0(x), nonpadding)
            x = (x + dropout(y, self.dropout, drop)) * mask
        y = self.TransformerFFN_0(getattr(self, self._ffn_ln)(x), drop)
        return (x + dropout(y, self.dropout, drop)) * mask


class FFTBlocks(nn.Module):
    """Stack of EncSALayers with optional positional embedding + last LN."""

    def __init__(self, hidden: int, num_layers: int, kernel_size: int = 9,
                 num_heads: int = 2, use_pos_embed: bool = True,
                 dropout: float = 0.1):
        super().__init__()
        self.num_layers = num_layers
        self.use_pos_embed = use_pos_embed
        self.dropout = dropout
        if use_pos_embed:
            self.pos_embed_alpha = nn.Parameter(torch.ones(1))
            self.pos = SinusoidalPositionalEmbedding(hidden)
        for i in range(num_layers):
            setattr(self, f"layer_{i}",
                    EncSALayer(hidden, num_heads, kernel_size,
                               dropout=dropout))
        self.LayerNorm_0 = LayerNorm(hidden, compute=True)

    def forward(self, x: torch.Tensor, nonpadding: torch.Tensor, drop=None):
        if self.use_pos_embed:
            x = x + self.pos_embed_alpha * self.pos(nonpadding)
            x = dropout(x, self.dropout, drop)
        x = precision.cast(x)
        mask = precision.cast(nonpadding[..., None])
        x = x * mask
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, nonpadding, drop) * mask
        return self.LayerNorm_0(x) * mask


def espnet_rel_pos_table(n_positions: int, dim: int) -> np.ndarray:
    """ESPnet ``RelPositionalEncoding`` table, rows in reversed position
    order (row i encodes position n_positions - 1 - i)."""
    pos = np.arange(n_positions - 1, -1, -1.0)[:, None]
    div = np.exp(np.arange(0, dim, 2) * -(math.log(10000.0) / dim))
    table = np.zeros((n_positions, dim), np.float32)
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div)
    return table


class FastspeechEncoder(nn.Module):
    """Phone embedding (* sqrt(d)) + positions + FFT stack.  ``rel_pos``
    adds the last T rows of the ESPnet table to every position (padding
    included) in place of the mask-addressed fairseq positions."""

    def __init__(self, vocab_size: int, hidden: int, num_layers: int,
                 kernel_size: int, num_heads: int = 2, dropout: float = 0.1,
                 rel_pos: bool = False):
        super().__init__()
        self.hidden = hidden
        self.dropout = dropout
        self.rel_pos = rel_pos
        self.embed_tokens = Embedding(vocab_size, hidden)
        if rel_pos:
            self.register_buffer("rel_table", torch.as_tensor(
                espnet_rel_pos_table(4096, hidden)), persistent=False)
        else:
            self.pos = SinusoidalPositionalEmbedding(hidden)
        self.blocks = FFTBlocks(hidden, num_layers, kernel_size, num_heads,
                                use_pos_embed=False, dropout=dropout)

    def forward(self, txt_tokens: torch.Tensor, drop=None) -> torch.Tensor:
        nonpadding = (txt_tokens > 0).to(torch.float32)
        x = self.embed_tokens(txt_tokens) * math.sqrt(self.hidden)
        if self.rel_pos:
            x = x + self.rel_table[None, -x.shape[1]:]
        else:
            x = x + self.pos(nonpadding)
        x = dropout(x, self.dropout, drop)
        return self.blocks(x, nonpadding, drop)


class FastspeechDecoder(nn.Module):
    def __init__(self, hidden: int, num_layers: int, kernel_size: int,
                 num_heads: int = 2, dropout: float = 0.1):
        super().__init__()
        self.blocks = FFTBlocks(hidden, num_layers, kernel_size, num_heads,
                                use_pos_embed=True, dropout=dropout)

    def forward(self, x, nonpadding, drop=None):
        return self.blocks(x, nonpadding, drop)


class DurationPredictor(nn.Module):
    """n x (conv k -> relu -> LN -> dropout) -> dense(1); log-domain
    output."""

    def __init__(self, c_in: int, hidden: int, n_layers: int = 2,
                 kernel_size: int = 3, dropout: float = 0.5):
        super().__init__()
        self.n_layers = n_layers
        self.dropout = dropout
        for i in range(n_layers):
            setattr(self, f"conv_{i}",
                    Conv(c_in if i == 0 else hidden, hidden, kernel_size,
                         compute=True))
            setattr(self, f"ln_{i}", LayerNorm(hidden, compute=True))
        self.out = Dense(hidden, 1)

    def forward(self, x: torch.Tensor, nonpadding: torch.Tensor, drop=None):
        mask = precision.cast(nonpadding[..., None])
        for i in range(self.n_layers):
            x = getattr(self, f"ln_{i}")(F.relu(getattr(self, f"conv_{i}")(x)))
            x = dropout(x, self.dropout, drop) * mask
        return (self.out(x) * nonpadding[..., None])[..., 0]

    @staticmethod
    def out2dur(log_dur: torch.Tensor, offset: float = 1.0) -> torch.Tensor:
        return torch.clamp_min(torch.round(torch.exp(log_dur) - offset),
                               0.0).long()


class PitchPredictor(nn.Module):
    """(x + alpha * positions) -> n x (conv k -> relu -> LN -> dropout) ->
    dense(odim), with a learned scale ``pos_embed_alpha`` on the sinusoidal
    positions."""

    def __init__(self, c_in: int, hidden: int, odim: int = 2,
                 n_layers: int = 5, kernel_size: int = 5,
                 dropout: float = 0.1):
        super().__init__()
        self.n_layers = n_layers
        self.dropout = dropout
        self.pos_embed_alpha = nn.Parameter(torch.ones(1))
        self.pos = SinusoidalPositionalEmbedding(c_in)
        for i in range(n_layers):
            setattr(self, f"conv_{i}",
                    Conv(c_in if i == 0 else hidden, hidden, kernel_size,
                         compute=True))
            setattr(self, f"ln_{i}", LayerNorm(hidden, compute=True))
        self.out = Dense(hidden, odim)

    def forward(self, x: torch.Tensor, nonpadding: torch.Tensor, drop=None):
        x = precision.cast(x + self.pos_embed_alpha * self.pos(nonpadding))
        for i in range(self.n_layers):
            x = getattr(self, f"ln_{i}")(F.relu(getattr(self, f"conv_{i}")(x)))
            x = dropout(x, self.dropout, drop)
        return self.out(x)


def length_regulator(dur: torch.Tensor, dur_padding: torch.Tensor,
                     max_frames: int, alpha: float = 1.0) -> torch.Tensor:
    """Durations [B, T_txt] -> ``mel2ph`` [B, max_frames] (1-based, 0=pad),
    with a static output length."""
    dur = torch.round(dur.to(torch.float32) * alpha).long()
    dur = dur * (1 - dur_padding.long())
    token_idx = torch.arange(1, dur.shape[1] + 1, device=dur.device)
    cum = torch.cumsum(dur, dim=1)
    prev = cum - dur
    pos = torch.arange(max_frames, device=dur.device)[None, None]
    token_mask = (pos >= prev[:, :, None]) & (pos < cum[:, :, None])
    return (token_idx[None, :, None] * token_mask.long()).sum(dim=1)


class ConvBlocksResidual(nn.Module):
    """n x (LN -> conv(k, d) -> * k**-0.5 -> gelu -> conv1 -> dropout),
    residual."""

    def __init__(self, channels: int, kernel_size: int, dilation: int,
                 n: int = 2, c_multiple: int = 2, dropout: float = 0.0):
        super().__init__()
        self.n = n
        self.kernel_size = kernel_size
        self.dropout = dropout
        for i in range(n):
            setattr(self, f"ln_{i}", LayerNorm(channels, compute=True))
            setattr(self, f"conv_a_{i}",
                    Conv(channels, c_multiple * channels, kernel_size,
                         dilation=dilation, compute=True))
            setattr(self, f"conv_b_{i}",
                    Conv(c_multiple * channels, channels, 1, compute=True))

    def forward(self, x: torch.Tensor, nonpadding: torch.Tensor, drop=None):
        mask = precision.cast(nonpadding[..., None])
        x = precision.cast(x)
        for i in range(self.n):
            y = getattr(self, f"conv_a_{i}")(getattr(self, f"ln_{i}")(x))
            y = getattr(self, f"conv_b_{i}")(
                gelu(y * const(self.kernel_size ** -0.5, y.dtype)))
            x = (x + dropout(y, self.dropout, drop)) * mask
        return x


class ConvBlocks(nn.Module):
    """Residual conv blocks + LN + postnet conv."""

    def __init__(self, channels: int, out_dims: int,
                 dilations: Sequence[int] = (1, 1, 1, 1, 1),
                 kernel_size: int = 5, dropout: float = 0.0):
        super().__init__()
        self.n = len(dilations)
        for i, d in enumerate(dilations):
            setattr(self, f"res_{i}",
                    ConvBlocksResidual(channels, kernel_size, d,
                                       dropout=dropout))
        self.last_norm = LayerNorm(channels, compute=True)
        self.post = Conv(channels, out_dims, 3, compute=True)

    def forward(self, x: torch.Tensor, nonpadding: torch.Tensor, drop=None):
        mask = precision.cast(nonpadding[..., None])
        for i in range(self.n):
            x = getattr(self, f"res_{i}")(x, nonpadding, drop)
        x = self.last_norm(x * mask) * mask
        return self.post(x) * mask


class WN(nn.Module):
    """Non-causal WaveNet conditioner (gated tanh * sigmoid, res/skip)."""

    def __init__(self, hidden: int, kernel_size: int = 3,
                 dilation_rate: int = 1, n_layers: int = 4):
        super().__init__()
        self.hidden = hidden
        self.n_layers = n_layers
        for i in range(n_layers):
            dilation = dilation_rate ** i if dilation_rate > 1 else 1
            setattr(self, f"in_{i}", Conv(hidden, 2 * hidden, kernel_size,
                                          dilation=dilation, compute=True))
            rs = 2 * hidden if i < n_layers - 1 else hidden
            setattr(self, f"res_skip_{i}", Conv(hidden, rs, 1, compute=True))

    def forward(self, x: torch.Tensor, nonpadding: torch.Tensor):
        mask = precision.cast(nonpadding[..., None])
        x = precision.cast(x)
        hc = self.hidden
        output = torch.zeros_like(x)
        for i in range(self.n_layers):
            x_in = getattr(self, f"in_{i}")(x)
            acts = torch.tanh(x_in[..., :hc]) * torch.sigmoid(x_in[..., hc:])
            rs = getattr(self, f"res_skip_{i}")(acts)
            if i < self.n_layers - 1:
                x = (x + rs[..., :hc]) * mask
                output = output + rs[..., hc:]
            else:
                output = output + rs
        return output * mask
