"""Per-op time tables from ``torch.profiler`` traces (port of
``stylesinger_tpu/utils/profiling.py``, which parses ``jax.profiler``'s).

A trace is the profiler's Chrome trace (``export_trace``).
:func:`parse_trace` sums its complete events by name: the device's
(CUDA kernels, copies and sets) when it has any, else the host's
operators (a CPU-only run).  :func:`format_table` prints the rows in the
JAX package's columns: time per iteration, calls, category, name.

Usage::

    from stylesinger_torch.utils.profiling import format_table, profile_step
    rows = profile_step(lambda: train_step(state, batch, phase, cfg),
                        iters=3, trace_dir="profile")
    print(format_table(rows))
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def export_trace(prof, trace_dir: str) -> str:
    """Write a stopped profiler's Chrome trace into ``trace_dir``; returns
    its path."""
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"trace_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


def latest_trace(trace_dir: str) -> Optional[str]:
    files = [f for pattern in ("*.json", "*.json.gz") for f in glob.glob(
        os.path.join(trace_dir, "**", pattern), recursive=True)]
    return max(files, key=os.path.getmtime) if files else None


def parse_trace(trace_file: str, device_only: bool = True
                ) -> List[Dict[str, Any]]:
    """Sum the trace's complete events by name -> rows sorted by total
    duration (microseconds): the device's events when there are any (and
    ``device_only``), else the host's operators."""
    opener = gzip.open if trace_file.endswith(".gz") else open
    with opener(trace_file, "rt") as f:
        data = json.load(f)
    events = [e for e in data.get("traceEvents", []) if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    if device_only and device:
        chosen = device
    else:
        chosen = [e for e in events if e.get("cat") == "cpu_op"] or events
    dur: collections.Counter = collections.Counter()
    count: collections.Counter = collections.Counter()
    meta: Dict[str, Dict[str, str]] = {}
    for e in chosen:
        name = e.get("name", "")
        dur[name] += e.get("dur", 0)
        count[name] += 1
        meta.setdefault(name, {"category": e.get("cat", ""),
                               "long_name": name})
    return [{"name": name, "total_us": d, "count": count[name],
             **meta[name]} for name, d in dur.most_common()]


def profile_step(fn: Callable[[], Any], iters: int = 3,
                 trace_dir: Optional[str] = None) -> List[Dict[str, Any]]:
    """Run ``fn`` ``iters`` times under ``torch.profiler`` (and the card's
    activity when CUDA is available) and return the per-op table with
    ``per_iter_us``.  Warm ``fn`` up first."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    trace_dir = trace_dir or tempfile.mkdtemp(prefix="ss_trace_")
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        if cuda:
            torch.cuda.synchronize()
    rows = parse_trace(export_trace(prof, trace_dir))
    for r in rows:
        r["per_iter_us"] = r["total_us"] / max(iters, 1)
    return rows


def format_table(rows: List[Dict[str, Any]], top: int = 20,
                 iters: int = 1) -> str:
    lines = ["per-op device time (aggregated over trace):"]
    for r in rows[:top]:
        per = r.get("per_iter_us", r["total_us"]) / 1e3
        lines.append(
            f"{per:9.3f} ms  x{r['count']:5d}  [{r.get('category', ''):>20s}]"
            f"  {(r.get('long_name') or r['name'])[:100]}")
    return "\n".join(lines)
