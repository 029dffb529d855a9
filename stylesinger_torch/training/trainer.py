"""The training loop (port of ``stylesinger_tpu/training/trainer.py``).

:meth:`Trainer.fit` runs optimizer steps to ``max_updates`` through the
curriculum: every ``tb_log_interval`` steps it writes the window's mean
losses and steps/s to ``<work_dir>/metrics.jsonl`` and stops on a
non-finite loss; every ``val_check_interval`` steps it validates and saves a
checkpoint.  It resumes from the latest checkpoint, can warm-start from
another run's weights (``load_ckpt``, a non-strict merge), and on Ctrl-C
finishes the step it is in, saves a checkpoint and raises
``KeyboardInterrupt``: a step changes the model's codebook buffers and the
optimizer's state in place, so a checkpoint is only taken between steps.

Under a process group (``parallel/mesh.py``, one process per device) each
step is one step on the global batch; rank 0 alone writes metrics and
checkpoints and runs validation (on the whole valid split, as JAX's
``BucketBatcher`` without a rank split gives it).

The scan dispatcher, the host-RSS watchdog, ``profile_step`` and the
validation image and audio dumps of the JAX trainer are not ported.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch
import torch.nn as nn

from stylesinger_torch.inference import resolve_device
from stylesinger_torch.models import precision
from stylesinger_torch.parallel import mesh
from stylesinger_torch.training.checkpoint import (
    CheckpointManager, latest_checkpoint, load_payload,
)
from stylesinger_torch.training.schedules import check_diff_start_lr
from stylesinger_torch.training.step import (
    Phase, TrainState, batch_to_device, eval_step, init_state,
    phase_for_step, train_step,
)


def warm_start_params(model: nn.Module, load_path: str) -> List[str]:
    """Copy into ``model`` every tensor of another run whose name and shape
    match (its parameters and RQ buffers; the reference's non-strict
    ``load_ckpt``).  ``load_path`` is a checkpoint file or a work dir
    (its latest checkpoint).  Returns what was dropped."""
    if os.path.isdir(load_path):
        latest = latest_checkpoint(load_path)
        if latest is None:
            raise FileNotFoundError(
                f"load_ckpt: no checkpoint under {load_path}/ckpt")
        load_path = latest[1]
    loaded = load_payload(load_path)["model"]
    target = model.state_dict()
    merged, dropped = {}, []
    for k, v in loaded.items():
        if k not in target:
            dropped.append(f"{k} (unknown key)")
        elif tuple(v.shape) != tuple(target[k].shape):
            dropped.append(f"{k} (shape {tuple(v.shape)} vs "
                           f"{tuple(target[k].shape)})")
        else:
            merged[k] = v
    model.load_state_dict(merged, strict=False)
    print(f"| warm-start from {load_path}: {len(merged)}/{len(loaded)} "
          "tensors loaded")
    for d in dropped[:20]:
        print(f"|   dropped {d}")
    if len(dropped) > 20:
        print(f"|   ... and {len(dropped) - 20} more")
    return dropped


class MetricsWriter:
    """Rows of ``{"step", "prefix", <metric>: value}`` appended to
    ``<work_dir>/metrics.jsonl``; on ranks other than 0 it writes
    nothing."""

    def __init__(self, work_dir: str):
        self._f = None
        if mesh.rank() == 0:
            os.makedirs(work_dir, exist_ok=True)
            self._f = open(os.path.join(work_dir, "metrics.jsonl"), "a")

    def write(self, step: int, metrics: Dict[str, Any],
              prefix: str = "train") -> None:
        if self._f is None:
            return
        row = {"step": step, "prefix": prefix,
               **{k: float(v) for k, v in metrics.items()}}
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()


class Trainer:
    """Drives :func:`train_step` for a model on ``device`` (``cuda`` unless
    the caller asks for the CPU; raises when CUDA is asked for and absent;
    ``cuda:LOCAL_RANK`` under a process group).  Raises on a
    ``compute_dtype`` other than float32 / bfloat16 and on a
    ``mesh_shape`` with a ``model`` axis."""

    def __init__(self, model: nn.Module, cfg: Any, work_dir: str,
                 device: Any = "cuda"):
        self.model = model
        self.cfg = cfg
        self.work_dir = work_dir
        self.device = mesh.local_device(resolve_device(device))
        precision.parse(cfg.get("compute_dtype", "float32"))
        mesh.check_mesh_shape(cfg.get("mesh_shape"))
        self.ckpt = CheckpointManager(
            work_dir, keep=cfg["num_ckpt_keep"], save_best=cfg["save_best"],
            milestone_interval=cfg.get("milestone_interval", 0))
        self.metrics = MetricsWriter(work_dir)
        self.state: Optional[TrainState] = None

    def init_state(self) -> TrainState:
        """Seeded weights, then the latest checkpoint if there is one, else
        the ``load_ckpt`` warm start."""
        state = init_state(self.model.to(self.device), self.cfg)
        state, start = self.ckpt.restore(state)
        if start == 0 and self.cfg.get("load_ckpt", ""):
            warm_start_params(state.model, self.cfg["load_ckpt"])
        return state

    def fit(self, train_batches: Iterable[Dict],
            valid_batches_fn: Optional[Callable[[], Iterable[Dict]]] = None,
            max_updates: Optional[int] = None) -> TrainState:
        """Train to ``max_updates`` (default ``cfg["max_updates"]``).
        ``train_batches`` is re-iterated at the end of each epoch;
        ``valid_batches_fn()`` gives a fresh validation iterator."""
        c = self.cfg
        max_updates = max_updates or c["max_updates"]
        check_diff_start_lr(c)
        state = self.state = self.init_state()
        self._stop = False
        previous = None
        if threading.current_thread() is threading.main_thread():
            previous = signal.signal(signal.SIGINT, self._on_sigint)
        try:
            self._train_loop(iter(train_batches), train_batches, state,
                             max_updates, valid_batches_fn)
        finally:
            if previous is not None:
                signal.signal(signal.SIGINT, previous)
        return state

    def _on_sigint(self, signum, frame) -> None:
        self._stop = True

    def _train_loop(self, it: Iterator, train_batches, state: TrainState,
                    max_updates: int, valid_batches_fn) -> None:
        window: Dict[str, list] = {}
        t0 = time.time()
        while state.step < max_updates:
            if self._stop:
                print(f"| KeyboardInterrupt: saving checkpoint at step "
                      f"{state.step}")
                if mesh.rank() == 0:
                    self.ckpt.save(state.step, state)
                raise KeyboardInterrupt
            try:
                batch = next(it)
            except StopIteration:
                it = iter(train_batches)
                batch = next(it, None)
                if batch is None:
                    raise ValueError(
                        f"rank {mesh.rank()}: an epoch gives no batch (fewer "
                        f"batches than the {mesh.world_size()} process(es))")
            phase = phase_for_step(state.step, self.cfg)
            m = train_step(state, batch_to_device(batch, self.device), phase,
                           self.cfg)
            for k, v in m.items():
                window.setdefault(k, []).append(v)
            t0 = self._log_val_save(state, phase, window, t0,
                                    valid_batches_fn)

    def _log_val_save(self, state: TrainState, phase: Phase,
                      window: Dict[str, list], t0: float,
                      valid_batches_fn) -> float:
        """The window's metrics and steps/s, the non-finite-loss trap, and
        validation with a checkpoint at the validation cadence.  Returns the
        (possibly reset) window start time."""
        c = self.cfg
        step = state.step
        if step % c["tb_log_interval"] == 0:
            logged = self._drain_window(window)
            logged["steps_per_sec"] = c["tb_log_interval"] / max(
                time.time() - t0, 1e-9)
            t0 = time.time()
            self.metrics.write(step, logged, "train")
            window.clear()
            if not np.isfinite(logged.get("total_loss", 0.0)):
                raise FloatingPointError(
                    f"non-finite loss at step {step}: {logged}")
        if step % c["val_check_interval"] == 0 and mesh.rank() == 0:
            val_loss = None
            if valid_batches_fn is not None:
                val_loss = self.validate(state, valid_batches_fn(), step,
                                         phase)
            self.ckpt.save(step, state, val_loss)
        return t0

    @staticmethod
    def _drain_window(window: Dict[str, list]) -> Dict[str, float]:
        """The mean of each metric over the window, with one copy from the
        device."""
        keys = sorted(window)
        values = torch.stack([torch.stack([v.float() for v in window[k]])
                              .mean() for k in keys]).cpu().tolist()
        return dict(zip(keys, values))

    def validate(self, state: TrainState, batches: Iterable[Dict],
                 step: int, phase: Phase) -> float:
        """The mean validation losses, written to ``metrics.jsonl``;
        returns the mean ``total_loss``."""
        sums: Dict[str, float] = {}
        n = 0
        for batch in batches:
            losses = eval_step(state, batch_to_device(batch, self.device),
                               phase, self.cfg)
            for k, v in losses.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
        avg = {k: v / max(n, 1) for k, v in sums.items()}
        self.metrics.write(step, avg, "valid")
        return avg.get("total_loss", 0.0)
