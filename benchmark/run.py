"""The port's benchmark: one run of one cell.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cell (an entry of ``BENCHMARK.json``'s
``workloads``) names its configuration, traffic and loop; the run builds
the system from the seed, warms up the cell's shapes, measures for
``--seconds`` (``--trace 0``: the end-to-end metrics; ``--trace 1``: the
per-layer metrics, from synchronized spans and then one profiled slice),
checks the window's answers against the plain reference, and prints one
JSON line last on standard output.  It needs the cards the cell asks for,
and refuses to report if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def cache_env(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port builds its kernels into ``stylesinger_torch/_build/``)."""
    cache = root / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")


def few_threads() -> None:
    """One process with one host thread for the numeric libraries: the
    card's runs share their host's cores, and idle pools of spinning
    threads add to the spread of host-paced cells."""
    for name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[name] = "1"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cache_env(ROOT)
    few_threads()
    sys.path.insert(0, str(ROOT))
    from benchmark.harness.registry import Cell
    from benchmark.harness.result import emit, refuse_jax
    from benchmark.harness.run_args import RunArgs
    from benchmark.harness.trace import breakdown

    cell = Cell(args.workload, ROOT)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    import stylesinger_torch

    if ROOT not in Path(stylesinger_torch.__file__).resolve().parents:
        print(f"the port is not in this checkout ({ROOT}): "
              f"{stylesinger_torch.__file__}", file=sys.stderr)
        return 3

    out = cell.loop().run(RunArgs(
        cell=cell, seed=args.seed, seconds=args.seconds,
        trace=bool(args.trace), device=torch.device("cuda"),
        t_start=T_START))
    refuse_jax("once the window had closed")

    metrics = {}
    values = dict(out["e2e"], setup_s=out["setup_s"])
    for m in cell.metrics(trace=bool(args.trace)):
        if args.trace:
            v = cell.reader(m["name"]).read(out["ctx"])
        else:
            v = values.get(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = dict(out["device"])
    brk = None
    if args.trace:
        s = out["ctx"]["slice"]
        device.update(busy_s=s["busy_s"], window_s=s["window_s"])
        brk = breakdown(s)
        for kind, rows in brk.items():
            for name, sec in rows:
                print(f"{kind}: {sec!r} s  {name}", file=sys.stderr)
    checks = out["checks"]
    emit(checks.correct(), out["attempted"], out["failed"], metrics, device,
         checks.as_dict(), checks.lines(), brk)
    return 0


if __name__ == "__main__":
    sys.exit(main())
