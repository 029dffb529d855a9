"""Residual Style Adaptor (port of ``stylesinger_tpu/models/style.py``):
reference-mel style encoder (WN + ConvBlocks + RQ) and the cross-attention
prosody aligner, inference mode."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from stylesinger_torch.models.common import (
    ConvBlocks, LayerNorm, MultiheadCrossAttention, WN,
)
from stylesinger_torch.models.rq import RQBottleneck


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
    """Post-norm cross-attention + ReLU FFN."""

    def __init__(self, hidden: int, num_heads: int = 2, ffn_dim: int = 2048):
        super().__init__()
        self.mha = MultiheadCrossAttention(hidden, num_heads)
        self.norm1 = LayerNorm(hidden)
        self.linear1 = nn.Linear(hidden, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, hidden)
        self.norm2 = LayerNorm(hidden)

    def forward(self, src: torch.Tensor, style: torch.Tensor,
                style_nonpadding: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        src2, attn = self.mha(src, style, style_nonpadding)
        src = self.norm1(src + src2)
        src = self.norm2(src + self.linear2(F.relu(self.linear1(src))))
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
                style_nonpadding: torch.Tensor):
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
            output, attn = getattr(self, f"layer_{i}")(output, style,
                                                       style_nonpadding)
            attns.append(attn)
            loss = loss + (attn * guided * pair).sum() / torch.clamp_min(
                pair.sum(), 1.0)
        return output, loss, torch.stack(attns, dim=1)


class LocalStyleAdaptor(nn.Module):
    """Reference mel -> frame-level style tokens via WN + ConvBlocks + RQ."""

    def __init__(self, hidden: int, n_codes: int = 128, rq_depth: int = 4,
                 mel_bins: int = 80, wn_layers: int = 4,
                 conv_dilations: Sequence[int] = (1, 1, 1, 1, 1)):
        super().__init__()
        self.wavenet = WN(mel_bins, kernel_size=3, dilation_rate=1,
                          n_layers=wn_layers)
        self.encoder = ConvBlocks(mel_bins, hidden,
                                  dilations=tuple(conv_dilations),
                                  kernel_size=5)
        self.rq = RQBottleneck(n_codes, hidden, rq_depth=rq_depth)

    def forward(self, ref_mels: torch.Tensor, ref_f0: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """ref_mels [B, T, M], ref_f0 [B, T] -> (style [B, T, H], codes)."""
        nonpadding = (ref_mels[:, :, 0].abs() > 1e-8).to(torch.float32)
        h = self.wavenet(ref_mels, nonpadding) + ref_f0[..., None]
        style = self.encoder(h, nonpadding)
        return self.rq(style)
