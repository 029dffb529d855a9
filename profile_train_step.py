"""Where a warm StyleSinger train step's time goes on the GPU, f32 against
bf16 activations.

The recipe's model (``egs/stylesinger.yaml``) on ``chip_smoke.py``'s
``train recipe`` batch (8 seeded synthetic items in the 1024-frame /
128-token buckets) in the RQ + diffusion phase of the curriculum, once at
``compute_dtype=float32`` and once at ``bfloat16``: 2 warm-up steps, 3
steps timed on the host clock between ``torch.cuda.synchronize()`` calls,
then 3 steps under ``torch.profiler``.  For each it prints the warm step
times, the profiled steps' wall time, the CUDA kernels' summed durations
per step (device busy), the idle share of the wall time, kernel launches
per step and the three kernels with the most device time, then the
``nvidia-smi`` name and power limit of the card.

Run from the repo root on a machine with a CUDA device:

    python3 profile_train_step.py

It exits non-zero without a CUDA device or when the profiler sees no
device time.
"""

import json
import sys
import time

import chip_smoke as cs


def profile_step(torch, np, dtype: str, steps: int = 3) -> dict:
    """The profile of the warm recipe step at ``dtype`` activations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stylesinger_torch.models.stylesinger import StyleSinger
    from stylesinger_torch.training import step as ts

    phase = ts.Phase(use_rq=True, forcing=False, use_diff=True)
    cfg, batch, vocab = cs.recipe_training(np, compute_dtype=dtype)
    state = ts.init_state(StyleSinger(cfg, vocab).cuda(), cfg)
    b = ts.batch_to_device(batch, "cuda")
    for _ in range(2):
        ts.train_step(state, b, phase, cfg)
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        tb = time.perf_counter()
        ts.train_step(state, b, phase, cfg)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - tb))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        tb = time.perf_counter()
        for _ in range(steps):
            ts.train_step(state, b, phase, cfg)
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - tb) / steps
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in kernels) / steps / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    return dict(
        compute_dtype=dtype, warm_ms=[round(v, 1) for v in times],
        profiled_ms=round(prof_ms, 1), device_busy_ms=round(busy_ms, 1),
        idle_share=round(1 - busy_ms / prof_ms, 3),
        kernels_per_step=round(len(kernels) / steps),
        top_ms={k[:60]: round(v / steps / 1e3, 2) for k, v in top})


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_train_step: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    for dtype in ("float32", "bfloat16"):
        row = profile_step(torch, np, dtype)
        print(json.dumps(row), flush=True)
        rows.append(row)
        torch.cuda.empty_cache()
    print(cs.nvidia_smi_line())
    if not all(r["device_busy_ms"] > 0 for r in rows):
        print("profile_train_step: the profiler saw no device time",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
