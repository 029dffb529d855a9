"""Residual quantization bottleneck, inference mode (port of ``models/rq.py``).

The codebooks are buffers (the JAX package keeps them in the ``codebook``
collection); the EMA update and code restarts belong to training.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn


class VQEmbedding(nn.Module):
    """One codebook: nearest code by the expanded quadratic distance."""

    def __init__(self, n_embed: int, embed_dim: int):
        super().__init__()
        self.register_buffer("embedding", torch.zeros(n_embed, embed_dim))

    def find_nearest(self, inputs: torch.Tensor) -> torch.Tensor:
        flat = inputs.reshape(-1, inputs.shape[-1])
        cb = self.embedding
        dist = (flat ** 2).sum(-1, keepdim=True) + (cb ** 2).sum(-1)[None] \
            - 2.0 * flat @ cb.T
        return torch.argmin(dist, dim=-1).reshape(inputs.shape[:-1])

    def forward(self, inputs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        idxs = self.find_nearest(inputs)
        return self.embedding[idxs], idxs


class RQBottleneck(nn.Module):
    """Depth-D residual quantizer."""

    def __init__(self, n_embed: int, embed_dim: int, rq_depth: int = 4):
        super().__init__()
        self.rq_depth = rq_depth
        for i in range(rq_depth):
            setattr(self, f"codebook_{i}", VQEmbedding(n_embed, embed_dim))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [B, T, D] -> (quantized [B, T, D], codes [B, T, depth])."""
        residual = x
        aggregated = torch.zeros_like(x)
        codes = []
        for i in range(self.rq_depth):
            quant, code = getattr(self, f"codebook_{i}")(residual)
            residual = residual - quant
            aggregated = aggregated + quant
            codes.append(code)
        # x + (q - x): the straight-through form, rounded as the JAX one
        return x + (aggregated - x), torch.stack(codes, dim=-1)
