"""Checkpoints with keep-K pruning, a best-validation copy, permanent
milestones and resume (port of ``stylesinger_tpu/training/checkpoint.py``,
written with ``torch.save`` instead of orbax).

Layout under the work dir:

- ``ckpt/model_ckpt_steps_<step>.pt``: the model's parameters and RQ
  buffers, the optimizer's state and the step; the K latest are kept (never
  pruned by metric, so the latest step always survives for resume);
- ``ckpt_best/model_ckpt_best.pt`` with ``best_val.json`` beside it: the
  copy with the lowest validation loss so far;
- ``ckpt_milestones/model_ckpt_steps_<step>.pt``: every
  ``milestone_interval`` steps, the model alone (an eval-only payload),
  never pruned.

Every file is written to a ``.part`` name and renamed into place.  A model
split over a mesh's ``model`` axis is saved gathered to its full layout and
re-sharded on restore, so its work dir loads in one process
(``StyleSingerInfer.load_params``).
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

from stylesinger_torch.parallel import mesh
from stylesinger_torch.training.step import TrainState

_STEP_FILE = re.compile(r"^model_ckpt_steps_(\d+)\.pt$")
BEST_FILE = "model_ckpt_best.pt"


def _save(payload: Dict[str, Any], path: str) -> None:
    torch.save(payload, path + ".part")
    os.replace(path + ".part", path)


def _steps_in(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_FILE.match,
                                               os.listdir(directory)) if m)


def load_payload(path: str, device: Any = "cpu") -> Dict[str, Any]:
    return torch.load(path, map_location=device, weights_only=True)


def save_model(work_dir: str, step: int,
               state_dict: Dict[str, torch.Tensor]) -> str:
    """A model alone (no optimizer) as ``ckpt/model_ckpt_steps_<step>.pt``
    under ``work_dir``, the payload ``load_params`` reads; returns the
    path."""
    ckpt_dir = os.path.join(os.path.abspath(work_dir), "ckpt")
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"model_ckpt_steps_{int(step)}.pt")
    _save({"model": state_dict, "step": int(step)}, path)
    return path


def latest_checkpoint(work_dir: str) -> Optional[Tuple[int, str]]:
    """(step, path) of the latest ``ckpt/model_ckpt_steps_<step>.pt`` under
    ``work_dir``; None when there is none.  Creates nothing."""
    ckpt_dir = os.path.join(os.path.abspath(work_dir), "ckpt")
    steps = _steps_in(ckpt_dir)
    if not steps:
        return None
    return steps[-1], os.path.join(ckpt_dir,
                                   f"model_ckpt_steps_{steps[-1]}.pt")


class CheckpointManager:
    """Saves and restores :class:`TrainState` under ``<work_dir>``."""

    def __init__(self, work_dir: str, keep: int = 3, save_best: bool = True,
                 milestone_interval: int = 0):
        root = os.path.abspath(work_dir)
        self.dir = os.path.join(root, "ckpt")
        self.best_dir = os.path.join(root, "ckpt_best")
        self.milestone_dir = os.path.join(root, "ckpt_milestones")
        os.makedirs(self.dir, exist_ok=True)
        self.keep = keep
        self.save_best = save_best
        self.milestone_interval = int(milestone_interval)
        self._best = self._read_best_sidecar() if save_best else None

    # -------------------------------------------------------------- save
    @staticmethod
    def payload(state: TrainState) -> Dict[str, Any]:
        """The state in its full layout: a model split over a mesh's model
        axis (``parallel/mesh.py::shard_params``) is gathered, its
        parameters and optimizer moments alike, as orbax saves global
        arrays (a collective: every rank of the model group calls it)."""
        model = state.model
        opt = state.opt.state_dict()
        for key in ("mu", "nu", "acc"):
            if key in opt:
                opt[key] = mesh.full_tensors(model, opt[key])
        return {"model": mesh.full_tensors(model, model.state_dict()),
                "step": int(state.step), "opt": opt}

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"model_ckpt_steps_{step}.pt")

    def _best_path(self) -> str:
        return os.path.join(self.best_dir, BEST_FILE)

    def save(self, step: int, state: TrainState,
             val_loss: Optional[float] = None) -> None:
        """Writes the checkpoint of ``step``.  A model split over a model
        axis is gathered first, so every rank calls this and rank 0
        writes."""
        payload = self.payload(state)
        if mesh.split_dims(state.model) and mesh.rank() != 0:
            return
        payload["step"] = int(step)
        _save(payload, self._path(step))
        for old in _steps_in(self.dir)[:-self.keep]:
            os.remove(self._path(old))
        if self.milestone_interval > 0 and step > 0 and \
                step % self.milestone_interval == 0 and \
                step not in self.milestone_steps():
            os.makedirs(self.milestone_dir, exist_ok=True)
            milestone = {k: v for k, v in payload.items() if k != "opt"}
            _save(milestone, os.path.join(self.milestone_dir,
                                          f"model_ckpt_steps_{step}.pt"))
        if self.save_best and val_loss is not None and \
                (self._best is None or float(val_loss) < self._best):
            self._best = float(val_loss)
            os.makedirs(self.best_dir, exist_ok=True)
            _save(payload, self._best_path())
            self._write_best_sidecar(step, self._best)

    def _sidecar_path(self) -> str:
        return os.path.join(self.best_dir, "best_val.json")

    def _write_best_sidecar(self, step: int, val_loss: float) -> None:
        with open(self._sidecar_path() + ".part", "w") as f:
            json.dump({"step": int(step), "val_loss": float(val_loss)}, f)
        os.replace(self._sidecar_path() + ".part", self._sidecar_path())

    def _read_best_sidecar(self) -> Optional[float]:
        try:
            with open(self._sidecar_path()) as f:
                return float(json.load(f)["val_loss"])
        except (OSError, ValueError, KeyError, TypeError):
            return None

    # ----------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        steps = _steps_in(self.dir)
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        return _steps_in(self.dir)

    def milestone_steps(self) -> List[int]:
        return _steps_in(self.milestone_dir)

    def best_step(self) -> Optional[int]:
        if not os.path.exists(self._best_path()):
            return None
        with open(self._sidecar_path()) as f:
            return int(json.load(f)["step"])

    @staticmethod
    def _load_into(state: TrainState, payload: Dict[str, Any]) -> int:
        """A full-layout payload into ``state``, each split leaf of a model
        on a model axis re-sharded to this rank's chunk."""
        model = state.model
        model.load_state_dict(mesh.local_tensors(model, payload["model"]))
        if "opt" in payload:
            opt = dict(payload["opt"])
            for key in ("mu", "nu", "acc"):
                if key in opt:
                    opt[key] = mesh.local_tensors(model, opt[key])
            state.opt.load_state_dict(opt)
        state.step = int(payload["step"])
        return state.step

    def restore(self, state: TrainState, step: Optional[int] = None
                ) -> Tuple[TrainState, int]:
        """The latest (or the given) checkpoint into ``state``; (state, 0)
        when there is none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return state, 0
        return state, self._load_into(
            state, load_payload(self._path(step), state.device))

    def restore_best(self, state: TrainState) -> Tuple[TrainState, int]:
        """The best-validation copy (the latest checkpoint when there is
        none)."""
        if not os.path.exists(self._best_path()):
            return self.restore(state)
        return state, self._load_into(
            state, load_payload(self._best_path(), state.device))

    def restore_milestone(self, state: TrainState, step: int) -> TrainState:
        """A milestone's model into ``state`` (the optimizer untouched:
        milestones are eval-only)."""
        path = os.path.join(self.milestone_dir, f"model_ckpt_steps_{step}.pt")
        self._load_into(state, load_payload(path, state.device))
        return state
