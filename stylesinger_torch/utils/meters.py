"""Timers and scalar meters (port of ``stylesinger_tpu/utils/meters.py``:
the reference's ``utils.Timer`` and ``AvgrageMeter``).  For the device's
time use ``utils/profiling.py``: a host clock around asynchronous CUDA
work measures the enqueue."""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict


class Timer:
    """Accumulating named wall time, as a context manager."""
    timer_map: Dict[str, float] = defaultdict(float)

    def __init__(self, name: str, enable: bool = True,
                 print_time: bool = False):
        self.name = name
        self.enable = enable
        self.print_time = print_time

    def __enter__(self):
        if self.enable:
            self.t = time.time()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if self.enable:
            Timer.timer_map[self.name] += time.time() - self.t
            if self.print_time:
                print(self.name, Timer.timer_map[self.name])


class AvgMeter:
    """The running mean of weighted values."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.avg = 0.0
        self.sum = 0.0
        self.cnt = 0

    def update(self, val: float, n: int = 1):
        self.sum += val * n
        self.cnt += n
        self.avg = self.sum / max(self.cnt, 1)
