"""Residual quantization bottleneck (port of ``models/rq.py``).

The codebooks and their EMA statistics are buffers (the JAX package keeps
them in the ``codebook`` collection).  In training mode each codebook's
buffers take an EMA step on the (detached) inputs, with padded frames
masked out, and the codes no real frame used lately are restarted at
jittered input vectors.  In a data-parallel step (``parallel/mesh.py``)
every rank takes that step on the global batch gathered in rank order, so
the statistics, the restart candidates and their draws are the global
batch's and the buffers stay equal on every rank.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .local import gather_rows, global_mean, global_sum


class VQEmbedding(nn.Module):
    """One EMA-updated codebook: nearest code by the expanded quadratic
    distance."""

    def __init__(self, n_embed: int, embed_dim: int, decay: float = 0.99,
                 eps: float = 1e-5):
        super().__init__()
        self.n_embed = n_embed
        self.decay = decay
        self.eps = eps
        self.register_buffer("embedding", torch.zeros(n_embed, embed_dim))
        self.register_buffer("cluster_size_ema", torch.zeros(n_embed))
        self.register_buffer("embed_ema", torch.zeros(n_embed, embed_dim))

    def find_nearest(self, inputs: torch.Tensor) -> torch.Tensor:
        flat = inputs.reshape(-1, inputs.shape[-1])
        cb = self.embedding
        dist = (flat ** 2).sum(-1, keepdim=True) + (cb ** 2).sum(-1)[None] \
            - 2.0 * flat @ cb.T
        return torch.argmin(dist, dim=-1).reshape(inputs.shape[:-1])

    @torch.no_grad()
    def _update(self, vectors: torch.Tensor, idxs: torch.Tensor, noise,
                mask: Optional[torch.Tensor]) -> None:
        """EMA step of the buffers, then the restart of unused codes.
        Draws two ``uniform``s: the restart jitter and the order in which
        input vectors (real frames first) are taken as restart codes."""
        d_embed = self.embedding.shape[1]
        per_row = vectors.shape[1] if vectors.ndim > 2 else 1
        parts = gather_rows([vectors.reshape(-1, d_embed), idxs.reshape(-1)]
                            + ([] if mask is None else [mask.reshape(-1)]),
                            per_row)
        flat, idxs = parts[:2]
        if mask is not None:
            mask = parts[2]
        n_vectors = flat.shape[0]
        w = torch.ones((n_vectors, 1), dtype=flat.dtype, device=flat.device) \
            if mask is None else mask.reshape(-1, 1).to(flat.dtype)
        one_hot = F.one_hot(idxs.reshape(-1), self.n_embed).to(flat.dtype) * w
        d = self.decay
        cluster_ema = self.cluster_size_ema * d + one_hot.sum(0) * (1 - d)
        embed_ema = self.embed_ema * d + (one_hot.T @ flat) * (1 - d)

        n_rep = -(-self.n_embed // n_vectors)
        tiled = flat.repeat(n_rep, 1)
        w_tiled = w[:, 0].repeat(n_rep)
        tiled = tiled + noise.uniform(tiled.shape) * (
            0.01 / math.sqrt(d_embed))
        score = w_tiled + noise.uniform(w_tiled.shape)
        order = torch.argsort(-score, stable=True)
        rand_vecs = tiled[order][: self.n_embed]
        usage = (cluster_ema.reshape(-1, 1) >= 1).to(flat.dtype)
        embed_ema = embed_ema * usage + rand_vecs * (1 - usage)
        cluster_ema = cluster_ema * usage[:, 0] + (1 - usage[:, 0])

        self.cluster_size_ema.copy_(cluster_ema)
        self.embed_ema.copy_(embed_ema)
        n = cluster_ema.sum()
        normalized = n * (cluster_ema + self.eps) / (
            n + self.n_embed * self.eps)
        self.embedding.copy_(embed_ema / normalized.reshape(-1, 1))

    def forward(self, inputs: torch.Tensor, noise=None,
                mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (codes' vectors, codes).  With a ``noise`` source (training)
        the buffers are updated first; the codes are found before the
        update and their vectors read after it, as in JAX."""
        inputs = inputs.detach()
        idxs = self.find_nearest(inputs)
        if noise is not None:
            self._update(inputs, idxs, noise, mask)
        return self.embedding[idxs], idxs


class RQBottleneck(nn.Module):
    """Depth-D residual quantizer."""

    def __init__(self, n_embed: int, embed_dim: int, rq_depth: int = 4,
                 decay: float = 0.99):
        super().__init__()
        self.rq_depth = rq_depth
        for i in range(rq_depth):
            setattr(self, f"codebook_{i}",
                    VQEmbedding(n_embed, embed_dim, decay=decay))

    def forward(self, x: torch.Tensor, noise=None,
                nonpadding: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x: [B, T, D] -> (quantized straight-through [B, T, D], the
        cumulative commitment loss, codes [B, T, depth]).  ``noise``
        (training) updates the codebooks; ``nonpadding`` [B, T] keeps padded
        frames out of the EMA statistics, the restarts and the loss."""
        residual = x.detach()
        aggregated = torch.zeros_like(residual)
        quants, codes = [], []
        for i in range(self.rq_depth):
            quant, code = getattr(self, f"codebook_{i}")(residual, noise,
                                                          nonpadding)
            residual = residual - quant
            aggregated = aggregated + quant
            quants.append(aggregated)
            codes.append(code)
        if nonpadding is None:
            commit = torch.stack([global_mean((x - q) ** 2) for q in quants])
        else:
            m = nonpadding[..., None]
            denom = torch.clamp_min(
                global_sum(m.sum(), "ref_frames") * x.shape[-1], 1.0)
            commit = torch.stack([(((x - q) ** 2) * m).sum() / denom
                                  for q in quants])
        # x + (q - x): the straight-through form, rounded as the JAX one
        return (x + (aggregated - x).detach(), commit.mean(),
                torch.stack(codes, dim=-1))
