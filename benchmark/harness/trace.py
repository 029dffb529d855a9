"""One ``torch.profiler`` slice of a ``--trace 1`` run, reduced to what the
per-layer readers and the result's ``breakdown`` take.

The slice runs after the run's timed part (a profiler session moves later
eager launches), synchronizes at both ends, and is exported as a Chrome
trace into the run's ``TMPDIR``, read, and deleted.  From it:

- ``window_s``: the slice's length on the host clock;
- ``busy_s``: the union of the device's kernel, copy and set intervals;
- ``kernels``: device seconds per name;
- ``gaps``: idle seconds between device intervals, each put on the host
  operator that started last before the device resumed (what the host was
  doing while the device waited).
"""

from __future__ import annotations

import bisect
import collections
import gzip
import json
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def union_intervals(spans: List[Tuple[float, float]]
                    ) -> List[Tuple[float, float]]:
    """Merge overlapping (start, end) intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def reduce_events(events: List[Dict[str, Any]], window_s: float
                  ) -> Dict[str, Any]:
    """Chrome-trace complete events (``ts``/``dur`` in microseconds) ->
    the slice's summary (see the module docstring)."""
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    host = sorted((e["ts"], e["ts"] + e.get("dur", 0), e.get("name", ""))
                  for e in events if e.get("cat") == "cpu_op")
    kernels: collections.Counter = collections.Counter()
    for e in device:
        kernels[e.get("name", "")] += e.get("dur", 0) / 1e6
    busy = union_intervals([(e["ts"], e["ts"] + e.get("dur", 0))
                            for e in device])
    busy_s = sum(e - s for s, e in busy) / 1e6
    gaps: collections.Counter = collections.Counter()
    starts = [h[0] for h in host]
    for (_, g0), (g1, _) in zip(busy[:-1], busy[1:]):
        i = bisect.bisect_right(starts, g1) - 1
        name = host[i][2] if i >= 0 and host[i][0] >= g0 else "host: no op"
        gaps[name] += (g1 - g0) / 1e6
    return dict(window_s=window_s, busy_s=busy_s,
                kernels=dict(kernels), gaps=dict(gaps),
                n_kernels=len(device))


def profile_slice(fn: Callable[[], Any], synchronize: Callable[[], None]
                  ) -> Tuple[Any, Dict[str, Any]]:
    """Run ``fn`` once under ``torch.profiler`` (host and device
    activity); returns (its result, the slice's summary)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        synchronize()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            events = [e for e in json.load(f).get("traceEvents", [])
                      if e.get("ph") == "X"]
    finally:
        os.remove(path)
    return out, reduce_events(events, window_s)


def breakdown(summary: Dict[str, Any], top: int = 10) -> Dict[str, list]:
    """The result line's ``breakdown``: the device operations that took
    most time and the longest idle gaps by host operator (seconds)."""
    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]
    return {"device_ops": ranked(summary["kernels"]),
            "idle_gaps": ranked(summary["gaps"])}
