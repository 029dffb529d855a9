"""Spans of a ``--trace 1`` run, recorded from the benchmark's own files
around the calls into each layer, with a device synchronize at each edge
(so that a span holds the device work it launched)."""

from __future__ import annotations

import collections
import time
from typing import Any, Callable, Dict, List


class Spans:
    def __init__(self, synchronize: Callable[[], None]):
        self.sync = synchronize
        self.total: Dict[str, float] = collections.defaultdict(float)
        self.calls: Dict[str, int] = collections.defaultdict(int)
        self._open: Dict[str, float] = {}
        self._hooks: List[Any] = []

    def start(self, name: str) -> None:
        self.sync()
        self._open[name] = time.perf_counter()

    def stop(self, name: str) -> None:
        self.sync()
        self.total[name] += time.perf_counter() - self._open.pop(name)
        self.calls[name] += 1

    def wrap(self, obj: Any, attr: str, name: str) -> None:
        """Time every call of ``obj.attr`` (an instance attribute that
        shadows the method; :meth:`remove` takes it away)."""
        fn = getattr(obj, attr)
        had = attr in vars(obj)

        def timed(*args, **kwargs):
            self.start(name)
            try:
                return fn(*args, **kwargs)
            finally:
                self.stop(name)

        setattr(obj, attr, timed)
        self._hooks.append(("attr", obj, attr, fn if had else None))

    def module(self, module, name: str) -> None:
        """Time every forward of ``module`` (forward pre- and post-hooks)."""
        self._hooks.append(("hook", module.register_forward_pre_hook(
            lambda *_: self.start(name))))
        self._hooks.append(("hook", module.register_forward_hook(
            lambda *_: self.stop(name))))

    def remove(self) -> None:
        for h in reversed(self._hooks):
            if h[0] == "hook":
                h[1].remove()
            elif h[3] is None:
                delattr(h[1], h[2])
            else:
                setattr(h[1], h[2], h[3])
        self._hooks = []
