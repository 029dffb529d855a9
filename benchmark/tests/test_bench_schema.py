"""``BENCHMARK.json`` against the contract's shape, a cell added as files
alone, and the guard against JAX."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from benchmark.harness.registry import BENCH_DIR, ROOT, Cell
from benchmark.harness.result import forbidden_modules

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "e2e": {"name", "unit", "better", "bound", "source"},
    "layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_shape(bench):
    assert set(bench) == KEYS["top"]
    assert bench["paths"] == ["benchmark"]
    assert all(line(w) for w in bench["command"])
    assert 1 <= bench["run_seconds"] <= 51
    names = set()
    for c in bench["configs"]:
        assert set(c) == KEYS["config"] and NAME.match(c["name"])
        assert line(c["source"]) and line(c["why"])
        assert c["file"].startswith("benchmark/")
        cfile = json.load(open(ROOT / c["file"]))
        assert cfile["reduced"] == c["reduced"] and "config" in cfile
        names.add(c["name"])
    cells = set()
    for w in bench["workloads"]:
        assert set(w) == KEYS["workload"] and NAME.match(w["name"])
        assert w["config"] in names and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line(w["why"])
        cells.add(w["name"])
    e2e = {}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == KEYS["e2e"]
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25 and m["bound"] >= 0.01
        e2e[m["name"]] = set(m.get("workloads", cells))
    assert "setup_s" in e2e
    setup = [m for m in bench["end_to_end"] if m["name"] == "setup_s"][0]
    assert "workloads" not in setup       # every cell, later ones too
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == KEYS["layer"]
        assert m["moves"] in e2e and line(m["layer"])
        assert set(m["workloads"]) <= e2e[m["moves"]]
        layers.setdefault(m["layer"], []).append(m["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    every = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(every) == len(set(every))
    for cell in cells:
        assert cell in e2e["setup_s"]
        assert any(cell in ws for n, ws in e2e.items() if n != "setup_s")
        assert any(cell in m["workloads"] for m in bench["per_layer"])
    assert len(json.dumps(bench)) < 64 * 1024


def test_every_cell_finds_its_files(bench):
    for w in bench["workloads"]:
        cell = Cell(w["name"])
        assert callable(cell.loop().run)
        assert callable(cell.generator().make)
        cell.costs()
        for m in cell.metrics(trace=True):
            assert callable(cell.reader(m["name"]).read)
        assert set(cell.spec["limits"])


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    """A new traffic mix, cell and per-layer metric, added by files and
    entries only."""
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(ROOT / "BENCHMARK.json"))
    mix = json.load(open(BENCH_DIR / "traffic" / "synth_batch.json"))
    mix.update(phones=[2, 10], ref_s=[1.0, 2.0])
    json.dump(mix, open(tmp_path / "benchmark" / "traffic" /
                        "synth_short.json", "w"))
    spec = json.load(open(BENCH_DIR / "workloads" /
                          "stylesinger.synth_batch.json"))
    json.dump(spec, open(tmp_path / "benchmark" / "workloads" /
                         "stylesinger.synth_short.json", "w"))
    (tmp_path / "benchmark" / "metrics" / "requests_per_s.py").write_text(
        "def read(ctx):\n    return ctx.get('requests')\n")
    bench["workloads"].append(dict(
        name="stylesinger.synth_short", config="stylesinger",
        traffic="synth_short", chips=1, why="short phrases"))
    bench["per_layer"].append(dict(
        name="requests_per_s", unit="1/s", better="higher",
        source="host_clock", layer="request", moves="synth_audio_s_per_s",
        workloads=["stylesinger.synth_short"]))
    for m in bench["end_to_end"]:
        if m["name"] == "synth_audio_s_per_s":
            m["workloads"].append("stylesinger.synth_short")
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    cell = Cell("stylesinger.synth_short", root=tmp_path)
    assert cell.spec["loop"] == "synth_batch"
    pool = cell.generator().make(cell.traffic, 5, cell.cfg)
    assert max(len(r["ph"].split()) for b in pool for r in b) == 10
    names = [m["name"] for m in cell.metrics(trace=True)]
    assert "requests_per_s" in names and "frontend_ms_per_req" not in names
    assert "setup_s" in [m["name"] for m in cell.metrics(trace=False)]
    assert cell.reader("requests_per_s").read({"requests": 3}) == 3


def test_forbidden_names_compare_whole_top_level_names():
    mods = ["stylesinger_torch", "stylesinger_torch.models", "jaxlib.xla",
            "jax", "flaxen", "stylesinger_tpu.models.x", "flax.linen"]
    assert forbidden_modules(mods) == ["flax.linen", "jax", "jaxlib.xla",
                                       "stylesinger_tpu.models.x"]


def test_the_benchmark_loads_no_jax():
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from benchmark.harness.registry import Cell\n"
        "b = json.load(open(%r))\n"
        "for w in b['workloads']:\n"
        "    c = Cell(w['name']); c.loop(); c.generator(); c.costs()\n"
        "    [c.reader(m['name']) for m in c.metrics(True)]\n"
        "import stylesinger_torch.inference, stylesinger_torch.vocoder_infer\n"
        "from benchmark.harness.result import forbidden_modules\n"
        "print(json.dumps(forbidden_modules()))\n"
        % (str(ROOT), str(ROOT / "BENCHMARK.json")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, str(BENCH_DIR / "run.py"), "--workload",
         "hifigan_nsf.vocode", "--seed", str(2 ** 40), "--seconds", "1"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    if out.returncode == 0:
        pytest.skip("a card is present")
    assert not out.stdout.strip()
