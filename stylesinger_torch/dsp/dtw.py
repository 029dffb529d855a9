"""Dynamic time warping (F0 / prosody comparison metrics); port of
``stylesinger_tpu/dsp/dtw.py``.

JAX scans the cost matrix row by row (``lax.scan``); here the
accumulated cost fills one anti-diagonal per step, every cell of a
diagonal at once, on the tensor's device: each cell is the same
``min(left, up, diag) + d`` as JAX's.  The alignment path is host numpy.
"""

from __future__ import annotations

import numpy as np
import torch


def dtw_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """DTW distance between x [Tx, D] and y [Ty, D] with an L2 local cost
    (the accumulated cost of the last cell, a 0-d tensor)."""
    dist = torch.sqrt(torch.clamp_min(
        ((x[:, None] - y[None, :]) ** 2).sum(-1), 1e-12))       # [Tx, Ty]
    tx, ty = dist.shape
    # acc[i + 1, j + 1] is the cost of cell (i, j); row and column 0 are
    # the inf border, with acc[0, 0] = 0 so that cell (0, 0) costs d(0, 0)
    acc = torch.full((tx + 1, ty + 1), float("inf"), dtype=dist.dtype,
                     device=dist.device)
    acc[0, 0] = 0.0
    flat = acc.view(-1)
    w = ty + 1
    for k in range(2, tx + ty + 1):          # i + j of the 1-based cells
        i = torch.arange(max(1, k - ty), min(tx, k - 1) + 1,
                         device=dist.device)
        j = k - i
        best = torch.minimum(torch.minimum(flat[(i - 1) * w + j],
                                           flat[i * w + j - 1]),
                             flat[(i - 1) * w + j - 1])
        flat[i * w + j] = best + dist[i - 1, j - 1]
    return acc[tx, ty]


def align_from_distances(dist: np.ndarray) -> np.ndarray:
    """Monotonic alignment path from a [Tx, Ty] cost matrix: for each x
    frame the chosen y index (reference ``align_from_distances``)."""
    tx, ty = dist.shape
    acc = np.full((tx, ty), np.inf)
    acc[0] = np.cumsum(dist[0])
    ptr = np.zeros((tx, ty), np.int64)
    for i in range(1, tx):
        for j in range(ty):
            cands = [acc[i - 1, j]]
            if j > 0:
                cands.append(acc[i - 1, j - 1])
                cands.append(acc[i, j - 1])
            k = int(np.argmin(cands))
            acc[i, j] = cands[k] + dist[i, j]
            ptr[i, j] = j if k == 0 else j - 1
    path = np.zeros(tx, np.int64)
    path[-1] = int(np.argmin(acc[-1]))
    for i in range(tx - 2, -1, -1):
        path[i] = min(ptr[i + 1, path[i + 1]], path[i + 1])
    return path


def f0_dtw_error(f0_a: np.ndarray, f0_b: np.ndarray) -> float:
    """DTW-aligned mean absolute F0 error over the voiced frames (offline
    eval metric, on the host)."""
    a = np.asarray(f0_a, np.float32)
    b = np.asarray(f0_b, np.float32)
    a, b = a[a > 0][:, None], b[b > 0][:, None]
    if len(a) == 0 or len(b) == 0:
        return float("nan")
    d = float(dtw_distance(torch.as_tensor(a), torch.as_tensor(b)))
    return d / max(len(a), len(b))
