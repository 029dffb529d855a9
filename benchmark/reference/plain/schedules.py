"""Learning-rate schedules (frozen from the port's ``training/schedules.py``).

``rsqrt``: lr(t) = base_lr * min(t / warmup, 1) * max(warmup, t)^-0.5 *
hidden^-0.5, with t = max(t, 1), floored at 1e-7.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np


def rsqrt_schedule(base_lr: float, warmup_updates: int,
                   hidden_size: int) -> Callable[[int], float]:
    rsqrt_hidden = np.float32(hidden_size ** -0.5)

    def schedule(step: int) -> float:
        step = np.float32(max(int(step), 1))
        warmup = min(step / np.float32(warmup_updates), np.float32(1.0))
        rsqrt_decay = max(np.float32(warmup_updates), step) ** \
            np.float32(-0.5)
        return float(max(np.float32(base_lr) * warmup * rsqrt_decay *
                         rsqrt_hidden, np.float32(1e-7)))

    return schedule


def constant_schedule(base_lr: float) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        return float(np.float32(base_lr))

    return schedule


def make_schedule(cfg: Any) -> Callable[[int], float]:
    """The schedule ``cfg["scheduler"]`` names (rsqrt or constant)."""
    if cfg["scheduler"] == "rsqrt":
        return rsqrt_schedule(cfg["lr"], cfg["warmup_updates"],
                              cfg["hidden_size"])
    return constant_schedule(cfg["lr"])


# The largest Adam lr at which the 20-layer DiffWave eps head still trains:
# above it its gated tanh * sigmoid units saturate and the L1(eps) loss pins
# at the predict-zero baseline sqrt(2/pi) (the JAX package's finding).
DIFF_HEAD_MAX_LR = 7e-4


def check_diff_start_lr(cfg: Any) -> float:
    """Warn when a (scaled) curriculum would start training the shallow
    diffusion's mel head at a saturating learning rate.  Returns
    lr(diff_start)."""
    if cfg.get("decoder") != "diffsinger" or cfg.get("scheduler") != "rsqrt":
        return 0.0
    sched = rsqrt_schedule(cfg["lr"], cfg["warmup_updates"],
                           cfg["hidden_size"])
    lr0 = sched(max(int(cfg["diff_start"]), 1))
    if lr0 > DIFF_HEAD_MAX_LR:
        print(f"| WARN: lr(diff_start={cfg['diff_start']}) = {lr0:.2e} > "
              f"{DIFF_HEAD_MAX_LR:.0e} — the DiffWave mel head saturates "
              f"and never recovers at hot lr. Raise diff_start (lr decays "
              f"as step^-0.5) or keep the reference warmup_updates=8000 "
              f"when scaling the curriculum down.")
    return lr0
