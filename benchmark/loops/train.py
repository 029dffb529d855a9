"""Acoustic training past the curriculum's starts: ``Trainer.fit`` with
its epoch on the device, each step a CUDA graph replay
(``steps_per_dispatch`` > 1, ``training/graphs.py``).

Set-up makes the traffic's items, builds the model and the trainer (the
workload's ``overrides`` on the recipe: every step a full-phase step,
windows of ``steps_per_dispatch`` steps, the seed from ``--seed``) and
enters ``fit`` on the port's bucket batcher over the items.  The trainer's
windows go through a wrapper on its ``scan``: the first window is set-up
(the epoch on the device, the eager step, the capture); it is run as
steps 1, 2-3 and the rest, with the optimizer's moments kept after step
1 and the parameters after step 3 for the check.  Every later window is
timed between device synchronizes; once ``--seconds`` have passed, the
wrapper ends ``fit`` at that window's last step, before anything ``fit``
writes at its end.  The work dir lives under ``TMPDIR`` and is removed.
With ``--trace 1``, ``slice_windows`` more windows run under the profiler
after the window.  The check runs the first three steps again with the
plain reference (``reference/train.py``).
"""

from __future__ import annotations

import gc
import shutil
import tempfile
import time
import traceback
from typing import Any, Dict

import torch

from benchmark.harness.noise import DrawNoise, derive_seed
from benchmark.harness.result import device_info, refuse_jax
from benchmark.harness.run_args import (
    PhaseClock, RunArgs, precision_as_stated, synchronizer,
)
from benchmark.harness.trace import profile_slice
from benchmark.reference.train import check_train, control_train

WEIGHTS, TRAFFIC, NOISE = 0, 1, 2
STREAMS = ("dropout", "umln", "rq", "diffusion")


class WindowClosed(Exception):
    """Raised from the trainer's window when the timed window is over."""


def run_config(args: RunArgs) -> Dict[str, Any]:
    """The configuration's file with the workload's overrides and the
    seed of the run (the port's initial weights and batch schedule)."""
    cfg = dict(args.cell.cfg)
    cfg.update(args.cell.spec["overrides"])
    cfg["seed"] = int(derive_seed(args.seed, WEIGHTS) % (2 ** 31))
    return cfg


def noise_fn(seed: int, device):
    """Each step's draws: one source per stream, seeded from (the run's
    seed, the step, the stream)."""
    def sources(step: int):
        return {name: DrawNoise(derive_seed(seed, NOISE, step, i), device)
                for i, name in enumerate(STREAMS)}
    return sources


def run(args: RunArgs) -> Dict[str, Any]:
    cell, dev = args.cell, args.device
    sync = synchronizer(dev)
    precision_as_stated()
    clock = PhaseClock(args.t_start)
    clock("harness imported")
    cfg = run_config(args)
    items = cell.generator().make(cell.traffic,
                                  derive_seed(args.seed, TRAFFIC), cfg)
    vocab = int(cell.traffic["vocab"])
    noises = noise_fn(args.seed, dev)
    clock("traffic made")
    if args.system == "control":
        return control_run(args, cfg, items, vocab, noises)

    from stylesinger_torch.config import Config
    from stylesinger_torch.data.batching import EpochBatches
    from stylesinger_torch.data.dataset import StyleSingerDataset
    from stylesinger_torch.models.stylesinger import StyleSinger
    from stylesinger_torch.training.trainer import Trainer

    pcfg = Config(cfg)
    work = tempfile.mkdtemp(prefix="bench_train_")
    trainer = Trainer(StyleSinger(pcfg, vocab), pcfg, work, device=dev,
                      noise_fn=noises)
    batches = EpochBatches(StyleSingerDataset(pcfg, "train", items=items),
                           pcfg)
    if args.fault is not None:
        args.fault(trainer)
    scan = trainer.scan
    seen: Dict[str, Any] = {"windows": [], "frames": None, "totals": []}

    def windowed(state, stacked, order, phase):
        if seen["frames"] is None:           # the first window: set-up
            seen["frames"] = (stacked["mel2ph"] > 0).sum(
                dim=tuple(range(1, stacked["mel2ph"].ndim))).tolist()
            seen.update(state=state, stacked=stacked, phase=phase,
                        order=list(order))
            clock("epoch on the device")
            parts = [scan(state, stacked, order[:1], phase)]
            sync()
            seen["mu1"] = [m.detach().clone() for m in state.opt.mu]
            parts.append(scan(state, stacked, order[1:3], phase))
            sync()
            seen["after3"] = [p.detach().clone()
                              for p in state.model.parameters()]
            if len(order) > 3:
                parts.append(scan(state, stacked, order[3:], phase))
            sync()
            m = {k: torch.cat([p[k].reshape(-1) for p in parts])
                 for k in parts[0]}
            seen["totals"] = m["total_loss"][:3].tolist()
            refuse_jax("during set-up")
            seen["t_first"] = time.perf_counter()
            return m
        m = scan(state, stacked, order, phase)
        sync()
        seen["windows"].append((time.perf_counter(), list(order)))
        if time.perf_counter() - seen["t_first"] >= args.seconds:
            raise WindowClosed
        return m

    trainer.scan = windowed
    failed = 0
    try:
        trainer.fit(batches, max_updates=10 ** 9)
    except WindowClosed:
        pass
    except Exception:                    # a step that fails ends the run
        failed = 1
        traceback.print_exc()
    finally:
        trainer.scan = scan
        shutil.rmtree(work, ignore_errors=True)
    steps = [j for _, order in seen["windows"] for j in order]
    attempted = len(steps) + failed
    device = device_info(1) if dev.type == "cuda" else {}
    t_end = seen["windows"][-1][0] if seen["windows"] else None
    frames = seen["frames"] or []
    out: Dict[str, Any] = {
        "setup_s": seen.get("t_first", time.perf_counter()) - args.t_start,
        "attempted": attempted, "failed": failed, "device": device,
        "e2e": {"train_frames_per_s": sum(frames[j] for j in steps)
                / (t_end - seen["t_first"])} if steps else {},
        "ctx": {},
    }
    if args.trace and steps:
        out["ctx"].update(traced_slice(cell, cfg, scan, seen, sync))
    mu1, after3, totals = seen.get("mu1"), seen.get("after3"), seen["totals"]
    del trainer, scan, seen
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["checks"] = check_train(cfg, cell.spec["limits"], items, vocab, dev,
                                noises, totals, mu1, after3)
    return out


def traced_slice(cell, cfg, scan, seen, sync) -> Dict[str, Any]:
    """``slice_windows`` windows of ``steps_per_dispatch`` steps under the
    profiler, and the cost model's training FLOP of their batches."""
    state, stacked = seen["state"], seen["stacked"]
    n_b = len(seen["frames"])
    w = int(cfg["steps_per_dispatch"])
    orders = [[(state.step + i * w + j) % n_b for j in range(w)]
              for i in range(cell.spec["slice_windows"])]
    _, summary = profile_slice(lambda: [scan(state, stacked, o,
                                             seen["phase"])
                                        for o in orders], sync)
    costs = cell.costs()
    lengths = costs.batch_lengths(stacked)
    flops = sum(costs.train_step_flops(cfg, lengths[j])
                for o in orders for j in o)
    return dict(slice=summary, slice_flops=flops)


def control_run(args: RunArgs, cfg, items, vocab, noises) -> Dict[str, Any]:
    """The control: the reference's first three steps with TF32 on, held
    against the reference's own with it off.  No window."""
    checks = control_train(cfg, args.cell.spec["limits"], items, vocab,
                           args.device, noises)
    return {"setup_s": 0.0, "attempted": 0, "failed": 0, "device": {},
            "e2e": {}, "ctx": {}, "checks": checks}
