"""Batch synthesis: ``StyleSingerInfer.infer_batch`` on ``batch`` requests
per call, closed loop, one caller; a batch is timed from the call until
its numpy wavs are back.

Set-up builds the instance on the device, loads the benchmark's seeded
weights (the duration head set so that predicted lengths follow the
notes), makes the traffic's pool and runs one batch (every batch has the
same padded shapes).  The window cycles through the pool's batches, each
with noise of its own seed.  Hooks keep what the check needs of each
batch (the front-end's outputs, the acoustic model's inputs and outputs,
the RQ codes, the denoisers' calls at the checked steps and their draws,
the vocoder's draws); one batch, drawn from the seed over the window's
batches, is kept and worked out again by the plain reference after the
window (``reference/synth.py``).  With ``--trace 1`` the front-end, the
acoustic model and the vocoder are timed (synchronized spans) and a
profiled slice of ``slice_batches`` batches follows the window.
"""

from __future__ import annotations

import gc
import time
import traceback
from typing import Any, Dict, List

import numpy as np
import torch

from benchmark.harness.noise import DrawNoise, derive_seed
from benchmark.harness.result import device_info, refuse_jax
from benchmark.harness.run_args import (
    PhaseClock, Reservoir, RunArgs, precision_as_stated, synchronizer,
)
from benchmark.harness.spans import Spans
from benchmark.harness.stats import window_rate
from benchmark.harness.trace import profile_slice
from benchmark.harness.weights import seeded_state
from benchmark.reference.plain.infer import PlainInfer
from benchmark.reference.synth import check_batch
from benchmark.reference.vocode import to_fp8

# streams of the run's seed
WEIGHTS, TRAFFIC, BATCH, SAMPLE, STEPS = 0, 1, 2, 3, 4


def seeded_states(cfg, phones, seed: int, dev, head_frames: float):
    """The state dicts of the four networks, from the seed, on the device;
    the duration head's weights 0 and its bias log(1 + ``head_frames``):
    every phone lasts the traffic's mean note, so that every seed's
    weights give the same lengths (random weights follow no note)."""
    ref = PlainInfer(cfg, phones, dev)
    states = {}
    for k, (name, conv_std) in enumerate((
            ("model", None), ("vocoder", 0.01), ("spk_encoder", None),
            ("emo_encoder", None))):
        states[name] = seeded_state(getattr(ref, name),
                                    derive_seed(seed, WEIGHTS, k), dev,
                                    conv_std)
    sd = states["model"]
    sd["dur_predictor.out.weight"] = torch.zeros_like(
        sd["dur_predictor.out.weight"])
    sd["dur_predictor.out.bias"] = torch.full_like(
        sd["dur_predictor.out.bias"], float(np.log1p(head_frames)))
    return states


class Lowered:
    """The control's system: the plain instance, each part one precision
    below the configuration's: TF32 on in cuBLAS and cuDNN for the f32
    front-end and acoustic model, the log-mel's f64 DFT in f32, the bf16
    vocoder through float8 (``reference/vocode.py::to_fp8``)."""

    def __init__(self, infer: PlainInfer):
        self.inner = infer
        to_fp8(infer.vocoder)

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def infer_batch(self, inps, noise=None):
        precision_as_stated(allow_tf32=True)
        try:
            return self.inner.infer_batch(inps, noise=noise)
        finally:
            precision_as_stated()


def build_system(args: RunArgs, cfg, phones, states):
    if args.system == "control":
        ref = PlainInfer(cfg, phones, args.device, dft_dtype=torch.float32)
        ref.load(states)
        return Lowered(ref), ref
    from stylesinger_torch.config import Config
    from stylesinger_torch.inference import StyleSingerInfer

    with torch.device(args.device):
        infer = StyleSingerInfer(Config(cfg), phone_list=phones,
                                 device=args.device)
    for name, sd in states.items():
        getattr(infer, name).load_state_dict(sd)
    return infer, infer


class Capture:
    """Forward hooks (and a wrapper on the instance's
    ``preprocess_input``) that keep, for the batch in flight, what the
    check needs.  ``steps``: {"f0": set, "mel": set} of the checked
    sampler steps; a checked step s keeps the call at s (inputs, output,
    its draws) and the input of the call at s - 1."""

    def __init__(self, inst, cfg, steps: Dict[str, set]):
        self.steps = steps
        self.n_f0 = cfg["f0_timesteps"]
        self.n_mel = cfg["K_step"]
        self.rec: Dict[str, Any] = {}
        self.noise = None
        self.hooks: List[Any] = []
        model = inst.model
        fn = inst.preprocess_input

        def pre(inp):
            out = fn(inp)
            self.rec["fe"].append(out)
            return out

        inst.preprocess_input = pre
        self._inst = inst
        self.hooks.append(model.register_forward_pre_hook(
            self._model_in, with_kwargs=True))
        self.hooks.append(model.register_forward_hook(self._model_out))
        self.hooks.append(model.style_extractor.rq.register_forward_hook(
            self._rq))
        for chain, net in (("a", model.gm_diffnet),
                           ("b", model.gm_diffnet_inpainte)):
            self.hooks.append(net.register_forward_hook(
                self._f0_call(chain)))
        self.hooks.append(model.postdiff.register_forward_hook(
            self._mel_call))
        self.hooks.append(inst.vocoder.register_forward_pre_hook(
            self._vocoder_in))

    def start(self, noise: DrawNoise) -> None:
        self.noise = noise
        self.rec = {"fe": [], "f0": {"a": {}, "b": {}}, "mel": {},
                    "calls": {"a": 0, "b": 0, "mel": 0}, "voc": []}

    def remove(self) -> None:
        for h in self.hooks:
            h.remove()
        del self._inst.preprocess_input

    def _model_in(self, module, args, kwargs):
        self.rec["joint"] = {k: v for k, v in kwargs.items()
                             if isinstance(v, torch.Tensor)}

    def _model_out(self, module, args, ret):
        self.rec["ret"] = {k: ret[k] for k in (
            "dur", "mel2ph", "pitch_pred", "f0_denorm", "mel_out")}

    def _rq(self, module, args, out):
        self.rec["rq_in"] = args[0].detach()
        self.rec["rq_codes"] = out[2]

    def _keep(self, n: int):
        start = self.noise.count
        self.noise.keep_next(n)
        return start

    def _f0_call(self, chain: str):
        def hook(module, args, out):
            i = self.rec["calls"][chain]
            self.rec["calls"][chain] += 1
            s = self.n_f0 - 1 - i
            if i == 0:
                self.rec["f0_cond_" + chain] = (args[3], args[4])
            if s in self.steps["f0"] or s + 1 in self.steps["f0"]:
                call = {"x": args[0].clone(), "uv": args[1].clone()}
                if s in self.steps["f0"]:
                    call["out"] = out.clone()
                    call["draw0"] = self._keep(2)
                self.rec["f0"][chain][s] = call
        return hook

    def _mel_call(self, module, args, out):
        i = self.rec["calls"]["mel"]
        self.rec["calls"]["mel"] += 1
        s = self.n_mel - 1 - i
        if i == 0:
            self.rec["mel_cond"] = args[2]
        if s in self.steps["mel"] or s + 1 in self.steps["mel"]:
            call = {"x": args[0].clone()}
            if s in self.steps["mel"]:
                call["out"] = out.clone()
                call["draw0"] = self._keep(1)
            self.rec["mel"][s] = call

    def _vocoder_in(self, module, args):
        self.rec["voc"].append(self._keep(2))

    def finish(self) -> Dict[str, Any]:
        rec = self.rec
        rec["draws"] = {i: x for i, _, x in self.noise.take_kept()}
        self.noise = None
        return rec


def checked_steps(n: int, rng: np.random.Generator, k: int) -> set:
    """The first and last sampler steps and ``k`` more drawn from the
    seed."""
    inner = rng.choice(np.arange(1, n - 1), size=min(k, max(n - 2, 0)),
                       replace=False) if n > 2 else []
    return {0, n - 1} | {int(s) for s in inner}


def run(args: RunArgs) -> Dict[str, Any]:
    cell, dev = args.cell, args.device
    cfg, spec, mix = cell.cfg, cell.spec, cell.traffic
    sync = synchronizer(dev)
    precision_as_stated()
    clock = PhaseClock(args.t_start)
    clock("harness imported")
    gen = cell.generator()
    phones = gen.phone_names(mix)
    states = seeded_states(cfg, phones, args.seed, dev,
                           gen.mean_note_frames(mix, cfg))
    clock("weights made")
    system, inst = build_system(args, cfg, phones, states)
    clock("system built")
    pool = gen.make(mix, derive_seed(args.seed, TRAFFIC), cfg)
    clock("traffic made")
    rng = np.random.default_rng(derive_seed(args.seed, STEPS))
    steps = {"f0": checked_steps(cfg["f0_timesteps"], rng,
                                 spec["check_steps"]),
             "mel": checked_steps(cfg["K_step"], rng, spec["check_steps"])}
    cap = Capture(inst, cfg, steps)
    cap.start(DrawNoise(0, dev))
    system.infer_batch(pool[0], noise=cap.noise)   # the window's shapes
    cap.finish()
    if args.fault is not None:
        args.fault(inst)
    sync()
    clock("shapes warmed up")
    refuse_jax("during set-up")

    spans = Spans(sync)
    if args.trace:
        spans.wrap(inst, "preprocess_input", "frontend")
        spans.module(inst.model, "acoustic")
        spans.module(inst.vocoder, "vocoder")
    sr = cfg["audio_sample_rate"]
    sample = Reservoir(1, np.random.default_rng(derive_seed(args.seed,
                                                            SAMPLE)))
    times, audio, requests = [], [], 0
    attempted = failed = 0
    t_first = time.perf_counter()
    while time.perf_counter() - t_first < args.seconds:
        k = attempted
        batch = pool[k % len(pool)]
        attempted += 1
        cap.start(DrawNoise(derive_seed(args.seed, BATCH, k), dev))
        s = time.perf_counter()
        try:
            outs = system.infer_batch(batch, noise=cap.noise)
        except Exception:               # a call that fails is counted
            failed += 1
            traceback.print_exc()
            cap.finish()
            continue
        times.append((s, time.perf_counter()))
        audio.append(sum(len(o["wav"]) for o in outs) / sr)
        requests += len(batch)
        sample.offer((k % len(pool), cap.finish(), outs))
    spans.remove()
    device = device_info(1) if dev.type == "cuda" else {}
    out: Dict[str, Any] = {
        "setup_s": t_first - args.t_start,
        "attempted": attempted * len(pool[0]),
        "failed": failed * len(pool[0]), "device": device,
        "e2e": {"synth_audio_s_per_s": window_rate(times, audio, t_first)}
        if times else {},
        "ctx": {"spans": spans, "audio_s": float(sum(audio)),
                "requests": requests, "batch": len(pool[0])},
    }
    cap.remove()
    if args.trace:
        out["ctx"].update(traced_slice(cell, system, pool, dev, sync))
    del system, inst
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    precision_as_stated()
    out["checks"] = check_batch(cfg, phones, states, dev, spec["limits"],
                                steps, pool, sample.items)
    return out


def traced_slice(cell, system, pool, dev, sync) -> Dict[str, Any]:
    """``slice_batches`` batches under the profiler, and the cost model's
    work for what they returned."""
    n = cell.spec["slice_batches"]
    batches = [pool[j % len(pool)] for j in range(n)]
    outs, summary = profile_slice(lambda: [system.infer_batch(
        b, noise=DrawNoise(j, dev)) for j, b in enumerate(batches)], sync)
    costs = cell.costs()
    cfg = cell.cfg
    flops = bound = 0.0
    for b, o in zip(batches, outs):
        for inp, r in zip(b, o):
            t = int(r["mel"].shape[0])
            flops += costs.request_flops(cfg, n_txt=len(inp["ph"].split()),
                                         n_ref=costs.ref_frames(
                                             cfg, len(inp["ref_audio"])),
                                         n_frames=t)
            bound += costs.mrf_bound_s(cfg, t)
    return dict(slice=summary, slice_flops=flops, slice_mrf_bound_s=bound)
