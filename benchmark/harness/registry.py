"""Finds a cell's files by the names in ``BENCHMARK.json``.

- ``benchmark/workloads/<cell>.json``: the loop that drives the cell, its
  check sizes and the limits of ``correct``;
- ``benchmark/traffic/<traffic>.json``: the traffic mix, with the name of
  the generator (``benchmark/traffic/<generator>.py``) that reads it;
- the configuration's ``file``, and ``benchmark/costs/<config>.py``;
- ``benchmark/loops/<loop>.py`` and ``benchmark/metrics/<metric>.py``.

A later cell, configuration or per-layer metric is added by adding such
files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def read_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """The Python file ``path`` as a module named ``name`` (a file name may
    hold a dot, as ``mfu.synth.py`` does)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


class Cell:
    """One entry of ``workloads`` with everything it names, read from
    ``root`` (the checkout)."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root = Path(root)
        self.bench = read_json(self.root / "BENCHMARK.json")
        entries = {w["name"]: w for w in self.bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(known: {sorted(entries)})")
        self.name = name
        self.entry = entries[name]
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config_file = read_json(self.root / self.config_entry["file"])
        self.cfg: Dict[str, Any] = self.config_file["config"]
        bench_dir = self.root / "benchmark"
        self.spec = read_json(bench_dir / "workloads" / f"{name}.json")
        self.traffic = read_json(bench_dir / "traffic"
                                 / f"{self.entry['traffic']}.json")
        self.bench_dir = bench_dir

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def loop(self) -> ModuleType:
        loop = self.spec["loop"]
        return load_module(self.bench_dir / "loops" / f"{loop}.py",
                           f"bench_loop_{loop}")

    def generator(self) -> ModuleType:
        gen = self.traffic["generator"]
        return load_module(self.bench_dir / "traffic" / f"{gen}.py",
                           f"bench_traffic_{gen}")

    def costs(self) -> ModuleType:
        name = self.entry["config"]
        return load_module(self.bench_dir / "costs" / f"{name}.py",
                           f"bench_costs_{name}")

    def metrics(self, trace: bool) -> List[Dict[str, Any]]:
        """The metrics this cell reports: its end-to-end metrics with
        ``--trace 0``, its per-layer metrics with ``--trace 1``."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if self.name in m.get("workloads", [self.name])]

    def reader(self, metric: str) -> ModuleType:
        return load_module(self.bench_dir / "metrics" / f"{metric}.py",
                           f"bench_metric_{metric.replace('.', '_')}")
