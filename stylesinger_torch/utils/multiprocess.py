"""Ordered multiprocess map for CPU-heavy offline work (port of
``stylesinger_tpu/utils/multiprocess.py``).

A pool of ``spawn`` workers consumes ``(idx, args)`` jobs and yields the
results in order; a job that raises yields None (its traceback printed).
``num_workers <= 1`` maps in this process.  The JAX package's
``host_only_children`` (it keeps a remote-accelerator backend from
registering in each child) has no counterpart: the port has no such
backend.
"""

from __future__ import annotations

import traceback
from typing import Any, Callable, Iterator, List, Optional, Tuple


def _safe_call(job: Tuple[Callable, tuple]) -> Any:
    fn, args = job
    try:
        return fn(*args)
    except Exception:
        traceback.print_exc()
        return None


def multiprocess_run(fn: Callable, args_list: List[tuple],
                     num_workers: int = 1,
                     desc: Optional[str] = None) -> Iterator[Tuple[int, Any]]:
    """Yield (idx, fn(*args)) in order; a pool only when num_workers > 1
    (``fn`` must then be importable by the workers)."""
    if num_workers <= 1:
        for i, args in enumerate(args_list):
            yield i, _safe_call((fn, args))
        return
    import multiprocessing as mp

    with mp.get_context("spawn").Pool(num_workers) as pool:
        for i, res in enumerate(
                pool.imap(_safe_call, [(fn, a) for a in args_list])):
            yield i, res
