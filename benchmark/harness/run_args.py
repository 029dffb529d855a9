"""What a loop is given, and the small pieces every loop uses."""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from benchmark.harness.registry import Cell


@dataclasses.dataclass
class RunArgs:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float                 # the process's start on the host clock
    system: str = "program"        # "program", or "control" (the check's)
    # tests only: a function that breaks the system under the window
    fault: Optional[Callable[[Any], None]] = None


class PhaseClock:
    """Prints, on standard error, the host seconds since the process
    started at each named point of set-up (where set-up time goes)."""

    def __init__(self, t_start: float):
        self.t_start = t_start

    def __call__(self, name: str) -> None:
        print(f"setup {name}: {time.perf_counter() - self.t_start:.3f} s",
              file=sys.stderr, flush=True)


def synchronizer(device: torch.device) -> Callable[[], None]:
    if torch.device(device).type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


class Reservoir:
    """A uniform sample of ``n`` items from a stream of unknown length,
    drawn from ``rng`` (Algorithm R)."""

    def __init__(self, n: int, rng: np.random.Generator):
        self.n = n
        self.rng = rng
        self.items: List[Any] = []
        self.seen = 0

    def offer(self, item: Any) -> bool:
        """Offer the next item; True when it is kept."""
        self.seen += 1
        if len(self.items) < self.n:
            self.items.append(item)
            return True
        j = int(self.rng.integers(0, self.seen))
        if j < self.n:
            self.items[j] = item
            return True
        return False


def precision_as_stated(allow_tf32: bool = False) -> None:
    """f32 as the configurations state it: TF32 off in cuBLAS and cuDNN
    (PyTorch leaves it on in cuDNN by default)."""
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    torch.backends.cudnn.allow_tf32 = allow_tf32
