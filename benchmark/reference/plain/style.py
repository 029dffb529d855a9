"""Residual Style Adaptor (frozen from the port's ``models/style.py``):
reference-mel style encoder (WN + ConvBlocks + RQ) and the cross-attention
prosody aligner with its guided-attention loss and the hard monotonic band
("forcing") that replaces attention early in training."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import (
    ConvBlocks, Dense, LayerNorm, MultiheadCrossAttention, WN, dropout,
)
from .precision import at_least_f32
from .rq import RQBottleneck
from .local import global_sum


def guided_attention_mask(tq: int, q_len: torch.Tensor, tk: int,
                          k_len: torch.Tensor, sigma: float) -> torch.Tensor:
    """[B, Tq, Tk] penalty ``1 - exp(-(y/k_len - x/q_len)^2 / 2s^2)``,
    lengths clamped to >= 1."""
    dev = q_len.device
    gx = torch.arange(tq, device=dev, dtype=torch.float32)[None, :, None]
    gy = torch.arange(tk, device=dev, dtype=torch.float32)[None, None, :]
    ql = torch.clamp_min(q_len.to(torch.float32), 1.0)[:, None, None]
    kl = torch.clamp_min(k_len.to(torch.float32), 1.0)[:, None, None]
    return 1.0 - torch.exp(-((gy / kl - gx / ql) ** 2) / (2 * sigma ** 2))


def monotonic_band_attention(tq: int, tk: int,
                             device: Optional[torch.device] = None
                             ) -> torch.Tensor:
    """Unnormalized 0/1 band [Tq, Tk]: floor(i*k)-1 <= j < ceil(i*k)+1."""
    k = tk / tq
    i = torch.arange(tq, device=device, dtype=torch.float32)[:, None]
    j = torch.arange(tk, device=device, dtype=torch.float32)[None, :]
    return ((j < torch.ceil(i * k) + 1) &
            (j >= torch.floor(i * k) - 1)).to(torch.float32)


class CrossAttenLayer(nn.Module):
    """Post-norm cross-attention + ReLU FFN.  With ``forcing`` the band
    matrix takes the attention's place (unnormalized, as in the
    reference)."""

    def __init__(self, hidden: int, num_heads: int = 2, ffn_dim: int = 2048,
                 dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.mha = MultiheadCrossAttention(hidden, num_heads,
                                           dropout=dropout)
        self.norm1 = LayerNorm(hidden)
        self.linear1 = Dense(hidden, ffn_dim)
        self.linear2 = Dense(ffn_dim, hidden)
        self.norm2 = LayerNorm(hidden)

    def forward(self, src: torch.Tensor, style: torch.Tensor,
                style_nonpadding: torch.Tensor, forcing: bool = False,
                drop=None) -> Tuple[torch.Tensor, torch.Tensor]:
        if forcing:
            b, tq = src.shape[:2]
            attn = monotonic_band_attention(tq, style.shape[1], src.device)
            attn = attn[None].expand(b, -1, -1).to(style.dtype)
            src2 = attn @ style
        else:
            src2, attn = self.mha(src, style, style_nonpadding, drop)
        src = self.norm1(src + dropout(src2, self.dropout, drop))
        y = self.linear2(F.relu(self.linear1(src)))
        src = self.norm2(src + dropout(y, self.dropout, drop))
        return src, attn


class ProsodyAligner(nn.Module):
    """Stack of cross-attention layers with the guided-attention loss."""

    def __init__(self, hidden: int, num_layers: int = 2, num_heads: int = 2,
                 ffn_dim: int = 2048, guided_sigma: float = 0.3):
        super().__init__()
        self.num_layers = num_layers
        self.guided_sigma = guided_sigma
        for i in range(num_layers):
            setattr(self, f"layer_{i}",
                    CrossAttenLayer(hidden, num_heads, ffn_dim))

    def forward(self, src: torch.Tensor, style: torch.Tensor,
                src_nonpadding: torch.Tensor,
                style_nonpadding: torch.Tensor, forcing: bool = False,
                drop=None):
        """-> (aligned [B, Tq, H], guided loss scalar, attn [B, L, Tq, Tk])."""
        tq, tk = src.shape[1], style.shape[1]
        guided = guided_attention_mask(tq, src_nonpadding.sum(-1), tk,
                                       style_nonpadding.sum(-1),
                                       self.guided_sigma)
        pair = src_nonpadding[:, :, None] * style_nonpadding[:, None, :]
        output = src
        loss = torch.zeros((), device=src.device)
        attns = []
        for i in range(self.num_layers):
            output, attn = getattr(self, f"layer_{i}")(
                output, style, style_nonpadding, forcing, drop)
            attns.append(attn)
            loss = loss + (attn * guided * pair).sum() / torch.clamp_min(
                global_sum(pair.sum(), "aligned_pairs"), 1.0)
        return output, loss, torch.stack(attns, dim=1)


class LocalStyleAdaptor(nn.Module):
    """Reference mel -> frame-level style tokens via WN + ConvBlocks + RQ."""

    def __init__(self, hidden: int, n_codes: int = 128, rq_depth: int = 4,
                 mel_bins: int = 80, wn_layers: int = 4,
                 conv_dilations: Sequence[int] = (1, 1, 1, 1, 1),
                 rq_decay: float = 0.99, vae_dropout: float = 0.0):
        super().__init__()
        self.wavenet = WN(mel_bins, kernel_size=3, dilation_rate=1,
                          n_layers=wn_layers)
        self.encoder = ConvBlocks(mel_bins, hidden,
                                  dilations=tuple(conv_dilations),
                                  kernel_size=5, dropout=vae_dropout)
        self.rq = RQBottleneck(n_codes, hidden, rq_depth=rq_depth,
                               decay=rq_decay)

    def forward(self, ref_mels: torch.Tensor, ref_f0: torch.Tensor,
                use_rq: bool = True, noise=None, drop=None):
        """ref_mels [B, T, M], ref_f0 [B, T] -> (style [B, T, H], the
        commitment loss, codes), or (style, None, None) without RQ.
        ``noise`` (training) updates the codebooks.  The style enters the
        RQ bottleneck in f32 (it is in the compute dtype without it), or in
        f64 when the model runs in f64."""
        nonpadding = (ref_mels[:, :, 0].abs() > 1e-8).to(ref_mels.dtype)
        h = self.wavenet(ref_mels, nonpadding) + ref_f0[..., None]
        style = self.encoder(h, nonpadding, drop)
        if not use_rq:
            return style, None, None
        return self.rq(at_least_f32(style), noise, nonpadding)
