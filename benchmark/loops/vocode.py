"""Vocoding mels made elsewhere: one ``HifiGAN_NSF.spec2wav(mel, f0)`` per
request, closed loop, one client, timed from the call until the numpy wav
is back.

Set-up builds the generator on the device, loads the benchmark's seeded
weights, makes the traffic's pool and vocodes one request of each length
in it (every shape the window uses).  The window then cycles through the pool, each
request with noise of its own seed.  With ``--trace 1`` the window's
generator forwards are timed (synchronized) and a profiled slice of
``slice_requests`` requests follows it.  The check vocodes a sample of the
window's requests (drawn from the seed, the longest mel among them) with
the plain generator and compares the wavs.
"""

from __future__ import annotations

import gc
import time
import traceback
from typing import Any, Dict

import numpy as np
import torch

from benchmark.harness.checks import Checks
from benchmark.harness.noise import DrawNoise, derive_seed
from benchmark.harness.result import device_info, refuse_jax
from benchmark.harness.run_args import (
    PhaseClock, Reservoir, RunArgs, precision_as_stated, synchronizer,
)
from benchmark.harness.spans import Spans
from benchmark.harness.stats import latencies_ms, percentile, window_rate
from benchmark.harness.trace import profile_slice
from benchmark.harness.weights import seeded_state
from benchmark.reference.plain.hifigan import HifiGanGenerator as PlainGen
from benchmark.reference.vocode import PlainVocoder, wav_errors

# streams of the run's seed
WEIGHTS, TRAFFIC, REQUEST, SAMPLE = 0, 1, 2, 3


def build_system(args: RunArgs, state: Dict[str, torch.Tensor]):
    """(the system under test, its generator module): the port's
    ``HifiGAN_NSF``, or for the control the plain generator through
    float8."""
    cfg = args.cell.cfg
    if args.system == "control":
        voc = PlainVocoder(cfg, state, args.device, fp8=True)
        return voc, voc.model
    from stylesinger_torch.config import Config
    from stylesinger_torch.models.hifigan import HifiGanGenerator
    from stylesinger_torch.vocoder_infer import HifiGAN_NSF

    with torch.device(args.device):
        gen = HifiGanGenerator(Config(cfg))
    gen.load_state_dict(state)
    return HifiGAN_NSF(Config(cfg), model=gen, device=args.device), gen


def run(args: RunArgs) -> Dict[str, Any]:
    cell, dev = args.cell, args.device
    cfg, spec = cell.cfg, cell.spec
    sync = synchronizer(dev)
    precision_as_stated()
    clock = PhaseClock(args.t_start)
    clock("harness imported")
    with torch.device(dev):
        state = seeded_state(PlainGen(cfg), derive_seed(args.seed, WEIGHTS),
                             dev, conv_std=0.01)
    system, gen = build_system(args, state)
    clock("system built")
    pool = cell.generator().make(cell.traffic,
                                 derive_seed(args.seed, TRAFFIC), cfg)
    clock("traffic made")
    warm = {r["mel"].shape[0]: r for r in pool}
    for r in warm.values():              # every length the window uses
        system.spec2wav(r["mel"], r["f0"], noise=DrawNoise(0, dev))
    if args.fault is not None:
        args.fault(system)
    sync()
    clock("shapes warmed up")
    refuse_jax("during set-up")

    spans = Spans(sync)
    if args.trace:
        spans.module(gen, "vocoder")
    sr = cfg["audio_sample_rate"]
    longest = int(np.argmax([r["mel"].shape[0] for r in pool]))
    sample = Reservoir(spec["check_requests"],
                       np.random.default_rng(derive_seed(args.seed, SAMPLE)))
    kept_longest = None
    times, audio = [], []
    attempted = failed = 0
    t_first = time.perf_counter()
    while time.perf_counter() - t_first < args.seconds:
        i = attempted % len(pool)
        ns = derive_seed(args.seed, REQUEST, attempted)
        attempted += 1
        s = time.perf_counter()
        try:
            wav = system.spec2wav(pool[i]["mel"], pool[i]["f0"],
                                  noise=DrawNoise(ns, dev))
        except Exception:               # a request that fails is counted
            failed += 1
            traceback.print_exc()
            continue
        times.append((s, time.perf_counter()))
        audio.append(len(wav) / sr)
        item = (i, ns, wav)
        sample.offer(item)
        if i == longest and kept_longest is None:
            kept_longest = item
    spans.remove()
    device = device_info(1) if dev.type == "cuda" else {}
    out: Dict[str, Any] = {
        "setup_s": t_first - args.t_start,
        "attempted": attempted, "failed": failed, "device": device,
        "e2e": {"synth_audio_s_per_s": window_rate(times, audio, t_first),
                "request_p95_ms": percentile(latencies_ms(times), 95)}
        if times else {},
        "ctx": {"spans": spans, "audio_s": float(sum(audio))},
    }
    if args.trace:
        n = spec["slice_requests"]
        reqs = [pool[j % len(pool)] for j in range(n)]
        _, summary = profile_slice(lambda: [system.spec2wav(
            r["mel"], r["f0"], noise=DrawNoise(j, dev))
            for j, r in enumerate(reqs)], sync)
        costs = cell.costs()
        takes = costs.kernel_takes(cfg)
        frames = [r["mel"].shape[0] for r in reqs]
        out["ctx"].update(
            slice=summary,
            slice_flops=sum(costs.vocoder_flops(cfg, t) for t in frames),
            slice_mrf_bound_s=sum(costs.bound_s(*costs.mrf_work(cfg, t,
                                                                takes))
                                  for t in frames))
    del system, gen
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["checks"] = check(args, state, pool, sample.items + (
        [kept_longest] if kept_longest is not None else []))
    return out


def check(args: RunArgs, state, pool, items) -> Checks:
    """The plain generator in the configuration's precision on each
    sampled request's mel, F0 and noise; the worst wav error."""
    checks = Checks(args.cell.spec["limits"])
    if not items:
        checks.fail("no request finished in the window")
        return checks
    precision_as_stated()
    ref = PlainVocoder(args.cell.cfg, state, args.device)
    for i, ns, wav in items:
        r = pool[i]
        want = ref.spec2wav(r["mel"], r["f0"], DrawNoise(ns, args.device))
        for name, v in wav_errors(wav, want).items():
            checks.add(name, v)
    return checks
