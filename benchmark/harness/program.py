"""The port's own spans and counters (``stylesinger_torch/utils/
profiling.py``), as the per-layer readers of ``program_span`` metrics take
them.  In a ``--trace 1`` run the spans are on only while the profiled
slice records, so the registry holds the slice alone; a graph's spans are
its last replay's.  Every function returns None where the port has no
registry or the run recorded none of the spans it reads."""

from __future__ import annotations

from typing import Any, Dict, Optional


def registry() -> Optional[Dict[str, Any]]:
    try:
        from stylesinger_torch.utils.profiling import registry as read
    except ImportError:
        return None
    return read()


def span(name: str) -> Optional[Dict[str, Any]]:
    reg = registry()
    s = None if reg is None else reg.get("spans", {}).get(name)
    return s if s and s.get("calls") else None


def device_ms_per_unit(name: str, per: str) -> Optional[float]:
    """Device milliseconds of the span ``name`` over the summed ``n`` of
    the span ``per`` (the requests of ``infer_batch``)."""
    s, p = span(name), span(per)
    if s is None or p is None or s.get("device_s") is None or not p.get("n"):
        return None
    return 1e3 * s["device_s"] / p["n"]


def graph_ms_per_step(name: str) -> Optional[float]:
    """Device milliseconds of the span ``name`` in a replayed CUDA graph:
    each graph's last replay, weighted by its replays."""
    reg = registry()
    if reg is None:
        return None
    pairs = [(g["replays"], g["spans"][name])
             for g in reg.get("graphs", {}).values()
             if g.get("replays") and g.get("spans", {}).get(name) is not None]
    if not pairs:
        return None
    return 1e3 * sum(r * s for r, s in pairs) / sum(r for r, _ in pairs)
