"""Training steps replayed as CUDA graphs: the port's counterpart of the
JAX package's scan windows (``training/step.py::make_train_scan`` and
``training/vocoder_task.py::make_vocoder_scan`` there).

JAX runs a window of optimizer steps as one device program, so the host
dispatches once per window and not once per kernel.  On the card the port
captures one step into a ``torch.cuda.CUDAGraph`` and replays it for every
step of a window; on the CPU it calls the same step function eagerly, the
plain version.  :class:`GraphedSteps` keeps one graph per key (the
curriculum phase and whatever else the step branches on on the host), all
in one memory pool.

A graph replays the kernels it captured, on the addresses and with the
scalar arguments it captured.  So:

- draws: a step draws from noise sources that the host seeds per step
  (``models/diffusion.Noise``).  The first run of a key is a real, eager
  step that records each source's draws (:class:`RecordingNoise`); the
  graph reads :class:`StaticNoise` buffers in that order, and before each
  run they are filled from that step's own sources, so that a replay
  draws what the eager step would draw;
- host scalars (the learning rate, the bias corrections) and the batch
  index are device buffers that the step function reads and the caller
  writes before each run;
- host counters (the step, the optimizer's count): a capture runs the
  Python of the step once and the device not at all, so the counters are
  put back after it; each replay adds to them what the key's eager run
  added.  A kernel wrapper called during the capture counts the launch
  it records into the graph; a replay runs the recorded launches without
  the wrapper, so the wrapper's count does not move (a profiler sees
  them);
- the registry (``utils/profiling.py``): the capture runs inside
  ``profiling.capturing``, which keeps the counts it made, so the
  registry's ``graphs`` entry reports them times the replays; a span
  entered during the capture is a pair of timing events in the graph,
  which every replay records.

A failed capture or replay raises; nothing falls back to eager steps on
the card.
"""

from __future__ import annotations

import time
from typing import (
    Any, Callable, Dict, Hashable, Iterable, List, Optional, Sequence, Tuple,
)

import torch

from stylesinger_torch.models.diffusion import Noise, TensorNoise
from stylesinger_torch.utils import profiling

Sources = Dict[str, Any]  # name -> noise source (None: that stream is off)


def _draw_shape(kind: str, args: tuple) -> tuple:
    return args[1] if kind == "bernoulli" else args[0]


class RecordingNoise:
    """Draws from ``source`` and records each draw: (method, arguments,
    dtype)."""

    def __init__(self, source: Any):
        self.source = source
        self.draws: List[tuple] = []

    def _draw(self, kind: str, *args) -> torch.Tensor:
        out = getattr(self.source, kind)(*args)
        self.draws.append((kind, args, out.dtype))
        return out

    def normal(self, shape):
        return self._draw("normal", tuple(shape))

    def uniform(self, shape):
        return self._draw("uniform", tuple(shape))

    def randint(self, shape, low, high):
        return self._draw("randint", tuple(shape), low, high)

    def bernoulli(self, p, shape=()):
        return self._draw("bernoulli", p, tuple(shape))


class StaticNoise(TensorNoise):
    """A noise source that hands out one buffer per recorded draw, in the
    recorded order, raising when a draw differs from the record.
    :meth:`fill` draws a step's values into the buffers from that step's
    source (in place where it is a :class:`Noise`)."""

    def __init__(self, draws: Sequence[tuple], device: torch.device):
        super().__init__([torch.empty(_draw_shape(kind, args), dtype=dtype,
                                      device=device)
                          for kind, args, dtype in draws], draws)

    def fill(self, source: Any) -> None:
        if source is None:
            raise ValueError("StaticNoise: this stream drew in the recorded "
                             "step and has no source now")
        for (kind, args, _), buf in zip(self.draws, self.values):
            if isinstance(source, Noise):
                getattr(source, kind)(*args, out=buf)
            else:
                buf.copy_(getattr(source, kind)(*args))
        self.rewind()


_CAPTURE_STREAMS: Dict[torch.device, Any] = {}


def capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The side stream of every capture on ``device``.  PyTorch keeps the
    cuBLAS workspaces of each stream that ran a matmul for the life of the
    process, so a new stream per capture would leave them allocated each
    time."""
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    stream = _CAPTURE_STREAMS.get(device)
    if stream is None:
        stream = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return stream


class _Entry:
    def __init__(self, fn, noise: Dict[str, Optional[StaticNoise]],
                 delta: tuple):
        self.fn = fn
        self.noise = noise
        self.delta = delta       # what one run adds to the host counters
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Any = None     # the graph's outputs
        self.timing: Optional[profiling.GraphTiming] = None


class GraphedSteps:
    """Steps ``fn(noise) -> outputs`` by key, on the device of the state
    they train.

    :meth:`bind` ties the steps to a state and its data, compared by
    identity: for another pair it drops every graph and buffer and starts
    anew on that state's device.  ``counters(state)`` names the host
    counters a step advances, as (object, attribute) pairs.

    :meth:`run` of a new key runs ``fn`` eagerly on the given sources,
    recording their draws; on the card it then captures ``fn`` on the
    static buffers (on a side stream, the warm-up step included, as
    capture requires).  A later run of the key fills the buffers from its
    sources and replays the graph (card) or calls ``fn`` on them (CPU).
    On the card the outputs of a replay are the graph's own tensors,
    which the key's next replay overwrites: copy what is kept."""

    def __init__(self, counters: Callable[[Any], Sequence[Tuple[Any, str]]],
                 log: Callable[[str], None] = print):
        self._counters_of = counters
        self._log = log
        self._bound: tuple = ()
        self.capture_seconds: Dict[Hashable, float] = {}

    def bind(self, state: Any, data: Any) -> None:
        if len(self._bound) == 2 and self._bound[0] is state and \
                self._bound[1] is data:
            return
        self._bound = (state, data)
        self.device = torch.device(state.device)
        self.graphed = self.device.type == "cuda"
        self._counters = list(self._counters_of(state))
        self._entries: Dict[Hashable, _Entry] = {}
        self._buffers: Dict[str, torch.Tensor] = {}
        self._pool = None
        self._stream = capture_stream(self.device) if self.graphed \
            else None
        self.capture_seconds = {}

    def buffer(self, name: str, shape: tuple,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """A device tensor the steps read and the caller writes before
        each run, kept until the next :meth:`bind` (a graph reads it at
        the address it captured)."""
        buf = self._buffers.get(name)
        if buf is None:
            buf = self._buffers[name] = torch.zeros(shape, dtype=dtype,
                                                    device=self.device)
        return buf

    def _get(self) -> List[Any]:
        return [getattr(obj, name) for obj, name in self._counters]

    def _set(self, values: Sequence[Any]) -> None:
        for (obj, name), v in zip(self._counters, values):
            setattr(obj, name, v)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._entries

    def draws(self) -> Dict[Hashable, int]:
        """The draws that each key's step fills before a run."""
        return {key: sum(len(st.draws) for st in e.noise.values()
                         if st is not None)
                for key, e in self._entries.items()}

    def run(self, key: Hashable, fn: Callable[[Sources], Any],
            sources: Sources) -> Any:
        """One step of ``key``; ``fn`` is used only when the key is new."""
        entry = self._entries.get(key)
        if entry is None:
            return self._first(key, fn, sources)
        for name, st in entry.noise.items():
            if st is not None:
                st.fill(sources.get(name))
        if entry.graph is None:  # the CPU: the plain version
            out = entry.fn(entry.noise)
            self._check_done(entry)
            return out
        entry.graph.replay()
        entry.timing.replayed()
        self._set([c + d for c, d in zip(self._get(), entry.delta)])
        return entry.out

    def _first(self, key: Hashable, fn, sources: Sources) -> Any:
        pre = self._get()
        rec = {k: None if s is None else RecordingNoise(s)
               for k, s in sources.items()}
        if self.graphed:
            current = torch.cuda.current_stream(self.device)
            self._stream.wait_stream(current)
            with torch.cuda.stream(self._stream):
                out = fn(rec)
            current.wait_stream(self._stream)
        else:
            out = fn(rec)
        post = self._get()
        entry = _Entry(fn, {k: None if r is None else
                            StaticNoise(r.draws, self.device)
                            for k, r in rec.items()},
                       tuple(b - a for a, b in zip(pre, post)))
        if self.graphed:
            self._capture(key, entry, pre, post)
        self._entries[key] = entry
        return out

    def _capture(self, key: Hashable, entry: _Entry, pre: list,
                 post: list) -> None:
        self._set(pre)
        for st in entry.noise.values():
            if st is not None:
                st.rewind()
        t = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        try:
            with profiling.capturing(key) as entry.timing, \
                    torch.cuda.graph(graph, pool=self._pool,
                                     stream=self._stream):
                entry.out = entry.fn(entry.noise)
            self._check_done(entry)
        finally:
            self._set(post)
        torch.cuda.synchronize(self.device)
        if self._pool is None:
            self._pool = graph.pool()
        entry.graph = graph
        self.capture_seconds[key] = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated(self.device) / 2 ** 30
        self._log(f"| captured the step of {key} as a CUDA graph in "
                  f"{self.capture_seconds[key]:.2f} s (peak memory "
                  f"{peak:.2f} GiB)")

    @staticmethod
    def _check_done(entry: _Entry) -> None:
        left = [k for k, st in entry.noise.items()
                if st is not None and not st.done()]
        if left:
            raise RuntimeError(f"GraphedSteps: the step drew less from "
                               f"{left} than the recorded step")


def stack_steps(steps: Iterable[Dict[str, torch.Tensor]]
                ) -> Dict[str, torch.Tensor]:
    """A window's metrics as [W] vectors from its steps' scalars, each
    step's copied as it comes (a replay's outputs are overwritten by the
    next)."""
    rows, keys = [], None
    for m in steps:
        keys = keys or sorted(m)
        rows.append(torch.stack([m[k] for k in keys]))
    return dict(zip(keys, torch.stack(rows, 1).unbind(0)))
