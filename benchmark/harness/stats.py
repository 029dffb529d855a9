"""Host-clock arithmetic of a closed-loop window.

Every request that started inside the window is counted and waited for,
so the window ends at the last one's return; a rate is all the work over
all that time, and a tail is the tail of all requests.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0..100) with linear interpolation between
    the closest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def window_rate(spans: Sequence[Tuple[float, float]],
                work: Sequence[float], t0: float) -> float:
    """Work per second over the window from ``t0`` to the last request's
    end: ``spans`` are each request's (start, end) on the host clock."""
    if not spans:
        raise ValueError("no request in the window")
    end = max(e for _, e in spans)
    return sum(work) / (end - t0)


def latencies_ms(spans: Sequence[Tuple[float, float]]) -> list:
    return [1e3 * (e - s) for s, e in spans]
