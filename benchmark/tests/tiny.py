"""Cells of ``BENCHMARK.json`` at a size a CPU test run holds: the tiny
model of the port's tests, short traffic, a one-second window."""

from __future__ import annotations

import time
from typing import Any, Dict

import torch

from benchmark.harness.registry import Cell
from benchmark.harness.run_args import RunArgs

TINY_AUDIO = dict(hop_size=64, fft_size=256, win_size=256, fmax=8000,
                  audio_sample_rate=16000, mrf_block=64)


def tiny_cfg(**kw: Any) -> Dict[str, Any]:
    from stylesinger_torch.config import tiny_test_config

    cfg = dict(tiny_test_config(**{**TINY_AUDIO, **kw}))
    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in cfg.items()}


def tiny_cell(name: str, cfg: Dict[str, Any] = None,
              traffic: Dict[str, Any] = None,
              spec: Dict[str, Any] = None) -> Cell:
    cell = Cell(name)
    cell.cfg = tiny_cfg() if cfg is None else cfg
    cell.traffic = {**cell.traffic, **(traffic or {})}
    cell.spec = {**cell.spec, **(spec or {})}
    return cell


def tiny_args(cell: Cell, seed: int = 2 ** 40 + 11, seconds: float = 1.0,
              trace: bool = False, **kw: Any) -> RunArgs:
    return RunArgs(cell=cell, seed=seed, seconds=seconds, trace=trace,
                   device=torch.device("cpu"), t_start=time.perf_counter(),
                   **kw)
