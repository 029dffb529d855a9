"""Data-parallel training across GPUs on NCCL, against one process.

The recipe's model (``egs/stylesinger.yaml``) on ``chip_smoke.py``'s
``train recipe`` batch (8 seeded synthetic items in the 1024-frame /
128-token buckets), RQ + diffusion phase, TF32 off:

1. one process on one GPU takes a step on the whole batch from seeded
   weights (the reference), then times warm steps on the whole batch and
   on one rank's share of it;
2. ``--world`` processes, one per GPU with torchrun's variables (NCCL),
   each take the same first step on their rows of the batch (every draw
   made at the global batch's shape, ``parallel/mesh.py``), and time warm
   steps.

Checked: rank 0's losses within 1e-4 (relative, atol 1e-4) of the
reference's, every gradient leaf within 1e-3 * max|g_leaf| + 1e-6 * max|g|
and the RQ buffers within 1e-5 (``chip_smoke.py``'s ``data parallel``
tolerances), and every rank's parameters and buffers equal after the step.
Printed: the errors and the gradient leaf that errs most, the same for
the one process's first step taken twice (the card's own spread between
two runs of one step), the warm step times (host clock between
synchronizes, the ranks between barriers), the card's ``nvidia-smi`` name
and power limit, and as the last line ``{"ok": true, ...}``.

With ``--model M`` the ranks form a ``world / M`` x ``M`` grid
(``parallel/mesh.py::make_mesh``): each ``TransformerFFN`` is split over
the M ranks of a model group (``shard_params``), whose ranks hold the same
rows; the batch splits over the ``world / M`` data indices.  The
gradients and parameters are gathered to their full layout before the
comparison.

Run from the repo root on a machine with N GPUs:

    python3 data_parallel_check.py --world N [--model M]

or on the CPU with the tiny model over gloo (a rehearsal of the same
path): ``python3 data_parallel_check.py --device cpu --tiny --world 4``.
Each rank's process has a timeout; the check fails if any rank does.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import chip_smoke as cs

REPO = Path(__file__).resolve().parent
RANK_TIMEOUT_S = 600


def make_run(np, tiny: bool):
    """(config, the 8-item batch as numpy, vocabulary size)."""
    if tiny:
        from stylesinger_torch.config import tiny_test_config

        cfg = tiny_test_config()
        return cfg, cs.collated(cfg, cs.synthetic_items(
            np, 8, (16, 30), (3, 7), 16, 20, cs.SEED)), 20
    return cs.recipe_training(np)


def rows_of(batch, lo: int, hi: int):
    """Rows [lo, hi) of every field that leads with the batch's rows."""
    n = batch["mels"].shape[0]
    return {k: v[lo:hi] for k, v in batch.items()
            if getattr(v, "shape", ())[:1] == (n,)}


def timed_steps(torch, ts, state, batch, phase, cfg, steps, sync):
    """Milliseconds of ``steps`` warm steps after 2 warm-up steps."""
    for _ in range(2):
        ts.train_step(state, batch, phase, cfg)
    times = []
    for _ in range(steps):
        sync()
        tb = time.perf_counter()
        ts.train_step(state, batch, phase, cfg)
        sync()
        times.append(1e3 * (time.perf_counter() - tb))
    return times


def snapshot(state, metrics):
    """The step's metrics, gradients and buffers, on the CPU."""
    return dict(
        metrics={k: float(v) for k, v in metrics.items()},
        grads={k: p.grad.detach().cpu().clone()
               for k, p in state.model.named_parameters()
               if p.grad is not None},
        buffers={k: v.detach().cpu().clone()
                 for k, v in state.model.state_dict().items()
                 if ".codebook_" in k})


def compare(torch, ref, got):
    """(worst loss error, worst gradient error over its tolerance, the
    name of that gradient leaf, worst RQ buffer error) of ``got`` against
    ``ref``."""
    loss = max(abs(got["metrics"][k] - v) / max(1.0, abs(v))
               for k, v in ref["metrics"].items())
    g_max = max(float(g.abs().max()) for g in ref["grads"].values())
    grad, leaf = max((float((got["grads"][k] - g).abs().max()) /
                      (1e-3 * float(g.abs().max()) + 1e-6 * g_max), k)
                     for k, g in ref["grads"].items())
    buf = max(float((got["buffers"][k] - v).abs().max())
              for k, v in ref["buffers"].items())
    return loss, grad, leaf, buf


def rank_worker(d: Path, device: str, tiny: bool, steps: int,
                n_model: int = 1) -> int:
    import numpy as np
    import torch
    import torch.distributed as dist

    from stylesinger_torch.models.stylesinger import StyleSinger
    from stylesinger_torch.parallel import mesh
    from stylesinger_torch.training import step as ts

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if device == "cpu":
        torch.set_num_threads(1)
    assert mesh.init_distributed(device)
    r, w = mesh.rank(), mesh.world_size()
    grid = mesh.make_mesh(w // n_model, n_model) if n_model > 1 else None
    dr, dw = mesh.data_rank(), mesh.data_size()
    dev = mesh.local_device(device)
    cfg, batch, vocab = make_run(np, tiny)
    n = batch["mels"].shape[0]
    local = ts.batch_to_device(rows_of(batch, dr * n // dw,
                                       (dr + 1) * n // dw), dev)
    model = StyleSinger(cfg, vocab)
    model.load_state_dict(torch.load(d / "weights.pt"))
    model.to(dev)
    if grid is not None:
        mesh.shard_params(model, grid)
    state = ts.TrainState(model, ts.Optimizer(
        dict(model.named_parameters()), cfg))
    phase = ts.Phase(use_rq=True, forcing=False, use_diff=True)
    m = ts.train_step(state, local, phase, cfg)
    full = mesh.full_tensors(model, model.state_dict())
    flat = torch.cat([v.detach().reshape(-1).float() for v in full.values()])
    hi, lo = flat.clone(), flat.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    equal = bool(torch.equal(hi, lo))
    snap = snapshot(state, m)
    snap["grads"] = {k: v.cpu() for k, v in mesh.full_tensors(model, {
        k: p.grad for k, p in model.named_parameters()
        if p.grad is not None}).items()}
    if r == 0:
        torch.save(snap, d / "rank0.pt")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier()

    times = timed_steps(torch, ts, state, local, phase, cfg, steps, sync)
    print("RANK " + json.dumps(dict(rank=r, world=w, model=n_model,
                                    rows=local["mels"].shape[0],
                                    ranks_equal=equal,
                                    warm_ms=[round(t, 1) for t in times])),
          flush=True)
    dist.destroy_process_group()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser("data_parallel_check")
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default: the number of GPUs)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny test model in place of the recipe's")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--model", type=int, default=1,
                    help="ranks of a model group (the FFN split)")
    ap.add_argument("--rank-worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank_worker:
        return rank_worker(Path(args.rank_worker), args.device, args.tiny,
                           args.steps, args.model)

    import numpy as np
    import torch

    from stylesinger_torch.models.stylesinger import StyleSinger
    from stylesinger_torch.training import step as ts

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("data_parallel_check: no CUDA device", file=sys.stderr)
        return 2
    world = args.world or (torch.cuda.device_count() if cuda else 2)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, batch, vocab = make_run(np, args.tiny)
    n = batch["mels"].shape[0]
    n_data = world // args.model
    if world % args.model or n % n_data or (
            cuda and world > torch.cuda.device_count()):
        print(f"data_parallel_check: {n_data} x {args.model} ranks for {n} "
              f"rows on {torch.cuda.device_count() if cuda else 'no'} GPUs",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    phase = ts.Phase(use_rq=True, forcing=False, use_diff=True)
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        d = Path(tmp)
        state = ts.init_state(StyleSinger(cfg, vocab).to(dev), cfg)
        init = {k: v.cpu().clone() for k, v in
                state.model.state_dict().items()}
        torch.save(init, d / "weights.pt")
        whole = ts.batch_to_device(rows_of(batch, 0, n), dev)
        ref = snapshot(state, ts.train_step(state, whole, phase, cfg))
        ref_ms = timed_steps(torch, ts, state, whole, phase, cfg, args.steps,
                             sync)
        model = StyleSinger(cfg, vocab)
        model.load_state_dict(init)
        state = ts.TrainState(model.to(dev), ts.Optimizer(
            dict(model.named_parameters()), cfg))
        # the same first step again in this process: how far one card's
        # step moves from itself (the backward's atomic sums)
        _, repeat, repeat_leaf, _ = compare(torch, ref, snapshot(
            state, ts.train_step(state, whole, phase, cfg)))
        model = StyleSinger(cfg, vocab)
        model.load_state_dict(init)
        state = ts.TrainState(model.to(dev), ts.Optimizer(
            dict(model.named_parameters()), cfg))
        share_ms = timed_steps(torch, ts, state, ts.batch_to_device(
            rows_of(batch, 0, n // n_data), dev), phase, cfg, args.steps,
            sync)
        del state, model, whole
        if cuda:
            torch.cuda.empty_cache()
        print("ONE " + json.dumps(dict(rows=n, warm_ms=[
            round(t, 1) for t in ref_ms], share_rows=n // n_data,
            share_warm_ms=[round(t, 1) for t in share_ms])), flush=True)

        env = dict(os.environ, PYTHONPATH=str(REPO), WORLD_SIZE=str(world),
                   MASTER_ADDR="localhost", MASTER_PORT=str(cs._free_port()))
        if not cuda:
            env["OMP_NUM_THREADS"] = "1"
        cmd = [sys.executable, str(REPO / "data_parallel_check.py"),
               "--rank-worker", str(d), "--device", args.device,
               "--steps", str(args.steps), "--model", str(args.model)] + \
            (["--tiny"] if args.tiny else [])
        tp = time.perf_counter()
        procs = [subprocess.Popen(cmd, cwd=str(REPO), env=dict(
            env, RANK=str(r), LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        outs = ["" for _ in procs]
        try:
            for r, p in enumerate(procs):
                outs[r] = p.communicate(timeout=RANK_TIMEOUT_S)[0]
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        seconds = time.perf_counter() - tp
        failed = [r for r, p in enumerate(procs)
                  if p.returncode != 0 or "RANK {" not in outs[r]]
        if failed:
            for r in failed:
                print(f"data_parallel_check: rank {r} failed:\n"
                      f"{outs[r][-3000:]}", file=sys.stderr)
            return 1
        ranks = [json.loads(o.split("RANK ", 1)[1].splitlines()[0])
                 for o in outs]
        loss, grad, leaf, buf = compare(torch, ref,
                                        torch.load(d / "rank0.pt"))
    ok = loss <= 1e-4 and grad <= 1.0 and buf <= 1e-5 and all(
        r["ranks_equal"] for r in ranks)
    med = sorted(ranks[0]["warm_ms"])[len(ranks[0]["warm_ms"]) // 2]
    print("RESULT " + json.dumps(dict(
        world=world, model=args.model, backend="nccl" if cuda else "gloo",
        rows_per_rank=n // n_data, loss_err=f"{loss:.2e}",
        grad_err_over_tol=f"{grad:.3f}", grad_worst_leaf=leaf,
        one_process_repeat_grad_err_over_tol=f"{repeat:.3f}",
        one_process_repeat_worst_leaf=repeat_leaf, rq_err=f"{buf:.2e}",
        ranks_equal=all(r["ranks_equal"] for r in ranks),
        warm_ms_per_rank={r["rank"]: r["warm_ms"] for r in ranks},
        world_warm_median_ms=med,
        one_process_warm_median_ms=sorted(ref_ms)[len(ref_ms) // 2],
        one_process_share_warm_median_ms=sorted(share_ms)[
            len(share_ms) // 2],
        ranks_seconds=round(seconds, 1), tol="1e-4/1e-3*max|g|/1e-5")))
    if cuda:
        print(cs.nvidia_smi_line())
    if not ok:
        print("data_parallel_check: the ranks' step differs from the "
              "one-process step", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": torch.cuda.device_count() if cuda else 0}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
