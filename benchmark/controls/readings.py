"""The readings that the limits of ``correct`` are set from, in one process
on the card: a cell's compared numbers over many seeds of the program
(the lower reading of each is the largest), and over seeds of the control
(the reference one precision below the configuration's, in the program's
place; the upper reading of each is the smallest), and over seeds of the
program with a fault of ``faults.py`` planted (``--fault``).

    python benchmark/controls/readings.py --workload <cell> \\
        --program-seeds 1,2,... --control-seeds 7,8,9 --seconds 2 \\
        [--fault half_batch --fault-seeds 4,5,6] [--out readings.json]

Each seed is a run of the cell's loop at its own size, with a short
window (one batch, or a few seconds of requests: as many answers as a run
compares).  The benchmark's own runs never run the control.
"""

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.controls.faults import FAULTS
    from benchmark.harness.registry import Cell
    from benchmark.harness.run_args import RunArgs

    if not torch.cuda.is_available():
        print("the readings need a CUDA device", file=sys.stderr)
        return 3
    if a.fault and a.fault not in FAULTS:
        print(f"no fault {a.fault!r} (known: {sorted(FAULTS)})",
              file=sys.stderr)
        return 2
    cell = Cell(a.workload, ROOT)
    loop = cell.loop()
    rows = []
    for system, seeds in (("program", a.program_seeds),
                          ("control", a.control_seeds),
                          (a.fault, a.fault_seeds)):
        for s in [int(x) for x in seeds.split(",") if x]:
            t0 = time.perf_counter()
            fault = FAULTS.get(system)
            out = loop.run(RunArgs(
                cell=cell, seed=s, seconds=a.seconds, trace=False,
                device=torch.device("cuda"), t_start=t0,
                system="program" if fault else system, fault=fault))
            ch = out["checks"]
            rows.append({"system": system, "seed": s,
                         "correct": ch.correct(), "values": ch.values,
                         "notes": ch.notes,
                         "seconds": time.perf_counter() - t0})
            print(json.dumps(rows[-1]), flush=True)
    summary = {}
    names = sorted({k for r in rows for k in r["values"]})
    for n in names:
        prog = [r["values"].get(n, math.nan) for r in rows
                if r["system"] == "program"]
        ctrl = [r["values"].get(n, math.nan) for r in rows
                if r["system"] == "control"]
        fault = [r["values"].get(n, math.nan) for r in rows
                 if r["system"] == a.fault]
        summary[n] = {"lower": max(prog) if prog else None,
                      "upper": min(ctrl) if ctrl else None,
                      "fault": min(fault) if fault else None,
                      "limit": cell.spec["limits"].get(n)}
        print(f"{n}: " + " ".join(f"{k} {v!r}" for k, v in
                                  summary[n].items()), flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
