"""Uncertainty-Modeling Layer Normalization (port of ``models/umln.py``).

Outside training UMLN returns its input untouched (the affine layer exists
so that checkpoints load).  In training it normalizes over the hidden dim
with the unbiased (ddof=1) std, like ``torch.std`` in the reference, and
re-scales and shifts with the style projection, perturbed by Gaussian
noise scaled by the projection's std across the batch (zero at B = 1).
One coin with probability ``p`` decides for the whole batch.  In a
data-parallel step the batch std is the global batch's.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .common import Dense
from .local import current, gather_rows_grad


class UMLN(nn.Module):
    def __init__(self, hidden: int, p: float = 0.5, eps: float = 1e-6):
        super().__init__()
        self.p = p
        self.eps = eps
        self.affine = Dense(hidden, 2 * hidden)

    def _batch_std(self, v: torch.Tensor) -> torch.Tensor:
        shard = current()
        if (shard.total if shard is not None else v.shape[0]) == 1:
            return torch.zeros_like(v)
        g = gather_rows_grad(v)
        return (g.std(dim=0, keepdim=True) + self.eps).expand_as(v)

    def forward(self, x: torch.Tensor, style_embed: torch.Tensor,
                noise=None) -> torch.Tensor:
        """x: [B, T, H]; style_embed: [B, 1, H]; ``noise``, the step's UMLN
        source, turns training mode on.  Draws: ``normal`` (beta),
        ``normal`` (gamma), ``bernoulli`` (the coin)."""
        if noise is None:
            return x
        mu = x.mean(-1, keepdim=True)
        x_normed = (x - mu) / (x.std(-1, keepdim=True) + self.eps)
        affine = self.affine(style_embed)
        mu1, sig1 = affine.chunk(2, dim=-1)
        # the batch std of each channel, both halves in one gather
        std_mu, std_sig = self._batch_std(affine).chunk(2, dim=-1)
        beta = mu1 + noise.normal(mu1.shape) * std_mu
        gamma = sig1 + noise.normal(sig1.shape) * std_sig
        return torch.where(noise.bernoulli(self.p), gamma * x_normed + beta,
                           x)
