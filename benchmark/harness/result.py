"""The run's result line and the guard against JAX in the process."""

from __future__ import annotations

import json
import math
import sys
from typing import Any, Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "stylesinger_tpu")


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is
    ``jax``, ``jaxlib``, ``flax`` or the JAX package, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def refuse_jax(where: str) -> None:
    """Stop the run, naming what it found, where JAX or the JAX package
    is loaded."""
    bad = forbidden_modules()
    if bad:
        print(f"JAX was loaded {where}: {bad}", file=sys.stderr)
        raise SystemExit(4)


def _finite(x: Any) -> Any:
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    return x


def device_info(count: int) -> Dict[str, Any]:
    import torch

    peak = max(torch.cuda.max_memory_allocated(i) for i in range(count))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak)}


def emit(correct: bool, attempted: int, failed: int,
         metrics: Dict[str, Dict[str, Any]], device: Dict[str, Any],
         checks: Dict[str, Dict[str, float]], check_lines: List[str],
         breakdown: Optional[Dict[str, list]] = None) -> None:
    """Each number compared beside its limit as the last lines on standard
    error, then the result as the last line of standard output, with the
    compared numbers under ``checks``, its last key."""
    line: Dict[str, Any] = {"correct": bool(correct), "attempted": attempted,
                            "failed": failed, "metrics": metrics,
                            "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = _finite(checks)
    sys.stdout.flush()
    for s in check_lines:
        print(s, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
