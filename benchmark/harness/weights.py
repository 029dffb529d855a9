"""Seeded weights, made on the device in one draw per module.

The rules are those of the port's ``init_random_`` (the weights its tests
and chip runs use): matrices N(0, 1/fan_in), 3-D conv kernels N(0,
``conv_std``) where one is given, biases 0, other vectors (norm scales) 1,
codebooks N(0, 1).  The benchmark builds the state dict from the
reference's module (whose names are the program's) and loads the same
tensors into both sides, so the reference takes nothing the program made.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn


def _is_codebook(name: str) -> bool:
    return ".codebook_" in name and name.endswith(".embedding")


def seeded_state(module: nn.Module, seed: int, device: torch.device,
                 conv_std: Optional[float] = None
                 ) -> Dict[str, torch.Tensor]:
    """``module``'s full state dict with seeded values on ``device``: one
    ``torch.randn`` of every normal entry together, sliced and scaled."""
    params = dict(module.named_parameters())
    state = {k: v.detach().to(device) for k, v in module.state_dict().items()}
    normal = []
    for name, p in params.items():
        if p.ndim >= 2:
            std = conv_std if (conv_std and p.ndim == 3) \
                else p[0].numel() ** -0.5
            normal.append((name, std))
        elif name.endswith("bias") or "bias_" in name:
            state[name] = torch.zeros_like(state[name])
        else:
            state[name] = torch.ones_like(state[name])
    normal += [(name, 1.0) for name in state if _is_codebook(name)]
    total = sum(state[n].numel() for n, _ in normal)
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=g, device=device)
    i = 0
    for name, std in normal:
        n = state[name].numel()
        state[name] = (flat[i:i + n].view_as(state[name]) * std).to(
            state[name].dtype)
        i += n
    return state
