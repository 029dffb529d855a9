"""The port's spans and counters, and per-op time tables from
``torch.profiler`` traces (port of ``stylesinger_tpu/utils/profiling.py``,
which parses ``jax.profiler``'s).

Spans and counters::

    from stylesinger_torch.utils import profiling
    with profiling.span("frontend", n=1):       # n: the work it covers
        ...
    profiling.count("denoiser.f0")
    profiling.registry()    # {"spans": ..., "graphs": ..., "counters": ...}

A span is on while a ``torch.profiler`` session records, or inside a
``with profiling.spans():`` block.  Off, it costs one probe of the
profiler's state and nothing else: no event, no annotation, no
synchronize, no allocation.  On, it is a ``record_function`` annotation in
the profiler's Chrome trace (on the clock of its host operators and
device kernels), a host ``perf_counter`` interval and, on CUDA, a pair of
timing events on the current stream; it adds ``n`` to the span's total.
It never synchronizes: the events resolve when :func:`registry` is read.

A span entered while :func:`capturing` (``training/graphs.py`` wraps each
CUDA graph capture in it) records external timing events into the graph,
whatever the on/off state, so that each replay carries its own timing;
the registry reads each graph's last replay.  Counters are always on, and
count what the host runs: a kernel wrapper counts the launch it records
into a graph during the capture, and a replay, which runs the recorded
launches without the wrapper, moves no counter.  The registry's
``graphs`` entry reports instead each graph's capture counts and those
counts times its replays.

:func:`idle_by_span` reduces a Chrome trace to the device's idle seconds
per innermost span.

Per-op tables: a trace is the profiler's Chrome trace (``export_trace``).
:func:`parse_trace` sums its complete events by name: the device's (CUDA
kernels, copies and sets) when it has any, else the host's operators (a
CPU-only run).  :func:`format_table` prints the rows in the JAX package's
columns: time per iteration, calls, category, name.

Usage::

    from stylesinger_torch.utils.profiling import format_table, profile_step
    rows = profile_step(lambda: train_step(state, batch, phase, cfg),
                        iters=3, trace_dir="profile")
    print(format_table(rows))
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import glob
import gzip
import json
import os
import tempfile
import time
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
OUTSIDE = "outside spans"
_profiler_enabled = torch._C._autograd._profiler_enabled
_DRAIN_AT = 512  # unresolved event pairs kept before the finished go


# ------------------------------------------------------------ the registry
class GraphTiming:
    """What one CUDA graph capture recorded: each span's pair of external
    events (nodes of the graph, recorded again by every replay) and the
    counts the capture made, which each replay runs again."""

    def __init__(self, label: str):
        self.label = label
        self.events: List[Tuple[str, Any, Any]] = []
        self.counts: Dict[str, int] = {}
        self.replays = 0

    def replayed(self) -> None:
        """Call after each replay of the graph."""
        self.replays += 1

    def device_s(self) -> Dict[str, float]:
        """Device seconds of each span in the last replay (a name's spans
        summed)."""
        out: Dict[str, float] = collections.defaultdict(float)
        for name, start, end in self.events:
            end.synchronize()
            out[name] += start.elapsed_time(end) / 1e3
        return dict(out)


class _Registry:
    def __init__(self) -> None:
        self.counters: collections.Counter = collections.Counter()
        self.forced = 0                           # open spans() blocks
        self.capture: Optional[GraphTiming] = None
        self.graphs: Dict[str, GraphTiming] = {}
        self.reset()

    def reset(self) -> None:
        self.counters.clear()
        self.calls: collections.Counter = collections.Counter()
        self.n: collections.Counter = collections.Counter()
        self.host_s: Dict[str, float] = collections.defaultdict(float)
        self.device_s: Dict[str, float] = collections.defaultdict(float)
        self.pending: collections.deque = collections.deque()
        for g in self.graphs.values():
            g.replays = 0

    def add(self, name: str, n: float, host: float, start, end) -> None:
        self.calls[name] += 1
        self.n[name] += n
        self.host_s[name] += host
        if start is not None:
            self.pending.append((name, start, end))
            if len(self.pending) >= _DRAIN_AT:
                self.resolve(finished_only=True)

    def resolve(self, finished_only: bool = False) -> None:
        while self.pending:
            name, start, end = self.pending[0]
            if finished_only and not end.query():
                return
            self.pending.popleft()
            end.synchronize()
            self.device_s[name] += start.elapsed_time(end) / 1e3


_REG = _Registry()


class _Off:
    """The span that is off: a shared, stateless context manager."""

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()


class _Span:
    __slots__ = ("name", "n", "rf", "start", "end", "t0")

    def __init__(self, name: str, n: float):
        self.name, self.n = name, n
        self.start = self.end = None

    def __enter__(self) -> "_Span":
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        if torch.cuda.is_initialized():
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        host = time.perf_counter() - self.t0
        if self.start is not None:
            self.end = torch.cuda.Event(enable_timing=True)
            self.end.record()
        self.rf.__exit__(None, None, None)
        _REG.add(self.name, self.n, host, self.start, self.end)


class _GraphSpan:
    __slots__ = ("timing", "name", "start")

    def __init__(self, timing: GraphTiming, name: str):
        self.timing, self.name = timing, name

    def __enter__(self) -> "_GraphSpan":
        self.start = torch.cuda.Event(enable_timing=True, external=True)
        self.start.record()
        return self

    def __exit__(self, *exc) -> None:
        end = torch.cuda.Event(enable_timing=True, external=True)
        end.record()
        self.timing.events.append((self.name, self.start, end))


def span(name: str, n: float = 0):
    """A context manager around one stage of the program; ``n`` is the
    work it covers (requests, audio samples, steps)."""
    if _REG.capture is not None:
        return _GraphSpan(_REG.capture, name)
    if not _REG.forced and not _profiler_enabled():
        return _OFF
    return _Span(name, n)


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to the counter ``name``."""
    _REG.counters[name] += k


def counter(name: str) -> int:
    return _REG.counters[name]


def set_counter(name: str, value: int) -> None:
    _REG.counters[name] = value


@contextlib.contextmanager
def spans():
    """Spans on inside the block, with no profiler running."""
    _REG.forced += 1
    try:
        yield
    finally:
        _REG.forced -= 1


@contextlib.contextmanager
def capturing(key: Hashable):
    """Around a CUDA graph capture: the spans entered inside record
    external events into the graph, and the counts made inside are kept.
    Yields the capture's :class:`GraphTiming`, which the registry reads
    (the last capture of a key replaces the one before)."""
    timing = GraphTiming(str(key))
    before = dict(_REG.counters)
    outer, _REG.capture = _REG.capture, timing
    try:
        yield timing
    finally:
        _REG.capture = outer
    timing.counts = {k: v - before.get(k, 0)
                     for k, v in _REG.counters.items()
                     if v != before.get(k, 0)}
    _REG.graphs[timing.label] = timing


def registry() -> Dict[str, Any]:
    """What was recorded since the last :func:`reset`:

    - ``spans``: per name, ``calls``, summed ``n``, ``host_s`` and
      ``device_s`` (None without CUDA events);
    - ``graphs``: per captured graph that replayed, ``replays``,
      ``spans`` (each span's device seconds in the last replay),
      ``counts`` (what the capture counted) and ``replayed`` (those counts
      times the replays: the launches the replays ran);
    - ``counters``: every counter (host side: no replay moves one).

    Waits for the device to pass the spans' end events."""
    _REG.resolve()
    spans_ = {name: dict(calls=_REG.calls[name], n=_REG.n[name],
                         host_s=_REG.host_s[name],
                         device_s=_REG.device_s.get(name))
              for name in _REG.calls}
    graphs = {label: dict(replays=g.replays, spans=g.device_s(),
                          counts=dict(g.counts),
                          replayed={k: v * g.replays
                                    for k, v in g.counts.items()})
              for label, g in _REG.graphs.items() if g.replays}
    return dict(spans=spans_, graphs=graphs, counters=dict(_REG.counters))


def reset() -> None:
    """Clear the spans, the counters and the graphs' replay counts."""
    _REG.reset()


# ------------------------------------------------------------- the traces
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


def _complete_events(trace_file: str) -> List[Dict[str, Any]]:
    opener = gzip.open if trace_file.endswith(".gz") else open
    with opener(trace_file, "rt") as f:
        data = json.load(f)
    return [e for e in data.get("traceEvents", []) if e.get("ph") == "X"]


def parse_trace(trace_file: str, device_only: bool = True
                ) -> List[Dict[str, Any]]:
    """Sum the trace's complete events by name -> rows sorted by total
    duration (microseconds): the device's events when there are any (and
    ``device_only``), else the host's operators."""
    events = _complete_events(trace_file)
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    if device_only and device:
        chosen = device
    else:
        chosen = [e for e in events if e.get("cat") == "cpu_op"] or events
    dur: collections.Counter = collections.Counter()
    count_: collections.Counter = collections.Counter()
    meta: Dict[str, Dict[str, str]] = {}
    for e in chosen:
        name = e.get("name", "")
        dur[name] += e.get("dur", 0)
        count_[name] += 1
        meta.setdefault(name, {"category": e.get("cat", ""),
                               "long_name": name})
    return [{"name": name, "total_us": d, "count": count_[name],
             **meta[name]} for name, d in dur.most_common()]


def _union(intervals: List[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def idle_by_span(trace_file: str) -> Dict[str, float]:
    """The device's idle seconds per innermost span: each gap between the
    union of its kernel, copy and set intervals is put on the innermost
    ``record_function`` annotation that encloses the host's clock when
    the device resumed, or on ``"outside spans"``."""
    events = _complete_events(trace_file)
    busy = _union([(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("cat") in DEVICE_CATEGORIES])
    spans_ = sorted((e["ts"], e["ts"] + e.get("dur", 0), e.get("name", ""))
                    for e in events if e.get("cat") == "user_annotation")
    starts = [s[0] for s in spans_]
    idle: collections.Counter = collections.Counter()
    for (_, g0), (g1, _) in zip(busy[:-1], busy[1:]):
        inner = None
        for s, e, name in spans_[:bisect.bisect_right(starts, g1)]:
            if e >= g1 and (inner is None or e - s < inner[1] - inner[0]):
                inner = (s, e, name)
        idle[inner[2] if inner else OUTSIDE] += (g1 - g0) / 1e6
    return dict(idle.most_common())


def format_idle(idle: Dict[str, float]) -> str:
    lines = ["device idle by span (the innermost span the host was in "
             "when the device resumed):"]
    lines += [f"{s:9.4f} s  {name}" for name, s in idle.items()]
    return "\n".join(lines) if idle else lines[0] + " no device activity"


def profile_step(fn: Callable[[], Any], iters: int = 3,
                 trace_dir: Optional[str] = None) -> List[Dict[str, Any]]:
    """Run ``fn`` ``iters`` times under ``torch.profiler`` (and the card's
    activity when CUDA is available) and return the per-op table with
    ``per_iter_us``.  Warm ``fn`` up first."""
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
