"""The numbers compared for ``correct``, each beside its limit.

A cell's workload file holds the limits (``limits``: name -> limit).  A
number is the worst reading over what the run checked; ``correct`` holds
when every limited number was read, is finite, and is at most its limit.
"""

from __future__ import annotations

import math
from typing import Dict, List


class Checks:
    def __init__(self, limits: Dict[str, float]):
        self.limits = dict(limits)
        self.values: Dict[str, float] = {}
        self.notes: List[str] = []

    def add(self, name: str, value: float) -> None:
        """Record a reading of ``name``; the worst one stands (NaN
        stands over everything)."""
        value = float(value)
        old = self.values.get(name)
        if old is None or math.isnan(value) or (
                not math.isnan(old) and value > old):
            self.values[name] = value

    def fail(self, note: str) -> None:
        """A check that could not be made (an answer that never came)."""
        self.notes.append(note)

    def correct(self) -> bool:
        if self.notes:
            return False
        for name, limit in self.limits.items():
            v = self.values.get(name)
            if v is None or not math.isfinite(v) or v > limit:
                return False
        return True

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {name: {"value": self.values.get(name, float("nan")),
                       "limit": limit}
                for name, limit in self.limits.items()}

    def lines(self) -> List[str]:
        out = [f"check {n}: {d['value']!r} limit {d['limit']!r}"
               f"{'' if d['value'] <= d['limit'] else '  FAILS'}"
               for n, d in self.as_dict().items()]
        return out + [f"check failed: {n}" for n in self.notes]
