#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``stylesinger_torch``) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printed on its own line with its elapsed seconds:

0. environment: torch / CUDA versions, the card's name and power limit
   (``nvidia-smi``), ``nvcc --version``, and the kernels' build (plain
   ``nvcc`` into ``stylesinger_torch/_build/``) with its time and, per
   kernel, the registers, shared memory and spills ``-Xptxas -v`` reports;
1. each CUDA kernel against its plain PyTorch twin on the card, at the
   shapes of the flagship main path, with its error, tolerance, launches
   per call, time per call (``ms``: CUDA events around one call, median),
   the twin's time, and the least time the card could take (``bound_ms``,
   with the peak it is taken against): the mel kernel, the MRF kernel's
   f32 mode and its bf16 mode (with the blocks that fit on an SM);
2. zero-shot requests through ``StyleSingerInfer.infer_once`` on
   flagship-width models with seeded random weights, path by path, each
   with every launch count and the denoiser-call counts set to 0 just
   before it and read just after:
   - ``defaults`` (``load_config()``, f32 vocoder): one request, which must
     launch the mel kernel once and the f32 MRF mode 27 times;
   - ``recipe`` (``load_config(recipe="stylesinger")``, the repo's recipe:
     bf16 vocoder, 100-step samplers): three requests, each 1 mel and 27
     bf16-mode MRF launches and 2 x 100 + 100 denoiser calls;
   - ``fast dpm10_f0fast5`` (the recipe with ``f0_speedup=5,
     dpm_steps=10``) and ``fast fast_both`` (``f0_speedup=5,
     pndm_speedup=5``): three requests each, with 2 x 20 + 10 and
     2 x 20 + 21 denoiser calls;
   each request prints its latency and real-time factor, and each path
   ends with request 0 timed stage by stage (reference front-end, acoustic
   model, vocoder); then ``HifiGAN_NSF.spec2wav_streaming`` once on the
   recipe's request 0;
3. agreement on small inputs, the card (kernels) against the CPU (plain
   twins): the tiny model; the tiny ProDiff / FFT-denoiser / conv-pitch
   model with a ``ResBlock2`` vocoder; a generator whose MRF reach is past
   the kernel's 64 rows; the mel kernel at n_fft 2048 and 1000; with the
   mel launches and the MRF stage routes printed;
4. training the acoustic model on the card:
   - ``small train step``: one step of the tiny model on the card against
     the same step on the CPU (same weights, the draws made on CPU
     generators and replayed on the card, TF32 off): every loss and the
     grad norm within 1e-3 (relative, atol 1e-3), each gradient leaf within
     1e-3 * max|g_leaf| + 1e-6 * max|g|;
   - ``train recipe``: ``Trainer.fit`` at the recipe's full width
     (``load_config(recipe="stylesinger")``, f32) on 8 seeded synthetic
     items of 600-1000 frames and 60-120 phones, collated into the
     1024-frame / 128-token buckets, for 4 steps across a scaled-down
     curriculum (``forcing=2, rq_start=1, diff_start=1``: 2 forcing steps,
     then 2 with RQ and the mel diffusion), validation and a checkpoint at
     step 4, then a restore that resumes at step 4 and must equal the
     saved state exactly; it prints each step's time (host clock between
     ``torch.cuda.synchronize()`` calls), steps/s after the first step,
     the peak memory and one eval step's time, and it launches neither
     kernel;
5. device time per call of each kernel and its twin at the shapes of
   phase 1 (``device_ms``: the durations of the CUDA kernels a call
   launches, from ``torch.profiler``), host gaps left out.  It runs last,
   so that no profiler session comes before the timed requests; the
   recipe's request 0 stage timing is then repeated, to show whether
   profiling slowed the process.

It prints a JSON line with one entry per kernel, the ``nvidia-smi`` line,
and as its last line ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero.  Without a CUDA device, or without the package beside it, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 1234
# train recipe: steps per curriculum phase (the first pays the phase's
# first run)
TRAIN_PHASE_STEPS = 6
PEAK_F32_FLOPS = 67e12   # H100 SXM, f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # H100 SXM, dense TF32 on the tensor cores
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores
PEAK_BYTES = 3.35e12     # H100 SXM HBM3
BUILD_LIMIT_S = 60.0
MEL_TOL = dict(atol=3e-3, rtol=2e-3)
MRF_REL_TOL = 1e-4       # of max|y|: the kernel sums in another order
MRF_BF16_ULPS = 2        # bf16 ulps of max|y|: an f32 sum in another order
                         # can land across a bf16 rounding

# the phrase and notes of the JAX package's example_run
EXAMPLE = dict(
    ph="x iao j iu w o ch ang j ie m ao AP sh i n i z ui m ei d e j i h ao",
    notes=[68, 68, 68, 68, 69, 69, 71, 71, 71, 71, 69, 69, 0, 68, 68, 66, 66,
           68, 68, 69, 69, 68, 68, 66, 66, 64, 64],
    notes_duration=[0.23, 0.23, 0.23, 0.23, 0.68, 0.68, 0.46, 0.46, 0.23,
                    0.23, 0.81, 0.81, 0.23, 0.23, 0.23, 0.23, 0.23, 0.23,
                    0.23, 0.46, 0.46, 0.23, 0.23, 0.23, 0.23, 0.58, 0.58],
    note_types=[2] * 12 + [1] + [2] * 14,
)


class Failure(Exception):
    pass


def say(phase: str, t0: float, **fields) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{phase}] t={time.perf_counter() - t0:.2f}s {body}", flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise Failure(what)


def cut(inp: dict, n: int) -> dict:
    return dict(ph=" ".join(inp["ph"].split()[:n]),
                notes=inp["notes"][:n],
                notes_duration=inp["notes_duration"][:n],
                note_types=inp["note_types"][:n])


def reference_clip(np, seconds: float = 4.0, sr: int = 48000):
    """A harmonic tone with vibrato and a soft envelope, from SEED."""
    rng = np.random.default_rng(SEED)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 220.0 * 2 ** (rng.uniform(-3, 3) / 12)
    inst = f0 * (1 + 0.02 * np.sin(2 * np.pi * 5.5 * t))
    phase = 2 * np.pi * np.cumsum(inst) / sr
    amps = rng.uniform(0.2, 1.0, 8) / np.arange(1, 9)
    wav = sum(a * np.sin((h + 1) * phase + rng.uniform(0, 2 * np.pi))
              for h, a in enumerate(amps))
    env = np.minimum(1.0, np.minimum(t, seconds - t) / 0.1)
    wav = 0.3 * wav * env / np.abs(wav).max()
    return wav.astype(np.float32)


def time_ms(torch, fn, iters: int = 20) -> float:
    """Median of per-call CUDA-event times, after one warm-up call."""
    fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def device_ms(torch, fn, iters: int = 10) -> float:
    """Device time per call: the summed durations of the CUDA kernels that
    ``iters`` calls launch (torch.profiler, CUPTI), over ``iters``, after
    one warm-up call.  Unlike :func:`time_ms` it leaves out the host's time
    between launches.  Fails if the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.device_time_total for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    require(total_us > 0, "torch.profiler recorded no device time")
    return total_us / iters / 1e3


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS):
    t_ops = flops / peak
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def phase_env(t0, torch):
    from stylesinger_torch.kernels import _build

    smi = nvidia_smi_line()
    nvcc = _build.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    say("env", t0, python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, gpu=repr(smi),
        nvcc=repr(ver[-1] if ver else "?"))
    tb = time.perf_counter()
    _build.library()
    built = _build.build_seconds()
    build_s = time.perf_counter() - tb
    say("build", t0, route="nvcc->.so->ctypes", sources=len(_build.sources()),
        build_s=f"{build_s:.2f}", compiled=built is not None)
    for line in _build.ptxas_report():
        say("ptxas", t0, kernel=line)
    require(build_s < BUILD_LIMIT_S,
            f"the kernels' build took {build_s:.1f} s")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say("precision", t0,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    return smi


def phase_mel(t0, torch, np, wav_np):
    from stylesinger_torch.kernels import mel as melk

    dev = torch.device("cuda")
    wav = torch.as_tensor(wav_np, device=dev)
    kw = dict(sample_rate=48000, n_fft=1024, hop_size=256, win_length=1024,
              n_mels=80, fmin=20.0, fmax=24000.0)
    consts = melk._constants(48000, 1024, 1024, 80, 20.0, 24000.0, dev)
    before = melk.counter.count
    out = melk.mel_spectrogram(wav, **kw)
    per_call = melk.counter.count - before
    ref = melk.mel_spectrogram_plain(wav, *consts, 256, 1e-6)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    ok = bool(torch.allclose(out, ref, **MEL_TOL))
    call = functools.partial(melk.mel_spectrogram, wav, **kw)
    plain = functools.partial(melk.mel_spectrogram_plain, wav, *consts, 256,
                              1e-6)
    ms, plain_ms = time_ms(torch, call), time_ms(torch, plain)
    n_frames, n_fft, n_freqs, n_mels = out.shape[0], 1024, 513, 80
    # the least work for a log-mel: a real FFT per frame (2.5 N log2 N)
    # and the mel projection, not the direct DFT that the kernel runs
    flops = n_frames * (2.5 * n_fft * math.log2(n_fft)
                        + 2.0 * n_freqs * n_mels)
    nbytes = 4.0 * (wav.numel() + 1024 + n_freqs * n_mels
                    + n_frames * n_mels)
    b_ms, b_by = bound_ms(flops, nbytes)
    say("kernel mel", t0, shape=tuple(out.shape), max_abs_err=f"{err:.3e}",
        tol="atol3e-3/rtol2e-3", ok=ok, launches_per_call=per_call,
        ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        bound_ms=f"{b_ms:.5f}", bound_by=b_by, peak="f32 67e12",
        flop=f"{flops:.3e}", library_ms="none")
    require(ok and out.shape == ref.shape, f"mel kernel disagrees: {err}")
    require(per_call == 1, f"mel: {per_call} launches per call")
    entry = dict(name="mel_spectrogram", route="cuda",
                 source="stylesinger_torch/csrc/mel.cu",
                 replaces="stylesinger_tpu/ops/mel_pallas.py:78",
                 max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                 bound_by=b_by, library_ms=None)
    return entry, [("mel", call, plain)]


def mrf_stages(cfg, np):
    """(C, T) of the vocoder stages that run the MRF kernel (the
    generator's routing rule, models/hifigan.py::HifiGanGenerator.mrf_route:
    ResBlock1, C <= 128, reach <= 64, at least two blocks); the vocoder
    runs at ``max_frames``."""
    from stylesinger_torch.kernels.mrf import takes_stage

    rates = cfg["upsample_rates"]
    rk = tuple(cfg["resblock_kernel_sizes"])
    rd = tuple(tuple(d) for d in cfg["resblock_dilation_sizes"])
    stages = []
    for i in range(len(rates)):
        c = cfg["upsample_initial_channel"] // 2 ** (i + 1)
        t = cfg["max_frames"] * int(np.prod(rates[: i + 1]))
        if (str(cfg["resblock"]) == "1" and takes_stage(c, rk, rd)
                and t >= 2 * cfg["mrf_block"]):
            stages.append((c, t))
    return stages


def ulp_bf16(v: float) -> float:
    """The spacing of bf16 values at v (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(v)) - 7)


def phase_mrf(t0, torch, np, cfg, bf16=False):
    """The MRF kernel at the flagship's kernel stages, in its f32 mode
    (against the f32 twin, 1e-4 of max|y|) or its bf16 mode (bf16 inputs
    and output, against the bf16 twin, 2 bf16 ulps of max|y|)."""
    from stylesinger_torch.kernels import mrf as mrfk
    from stylesinger_torch.models.hifigan import ResBlock1, _blockify

    dev = torch.device("cuda")
    dtype = torch.bfloat16 if bf16 else torch.float32
    counter = mrfk.counter_bf16 if bf16 else mrfk.counter
    plain_fn = mrfk.mrf_blocks_plain_bf16 if bf16 else mrfk.mrf_blocks_plain
    tag = "mrf_bf16" if bf16 else "mrf"
    rk = tuple(cfg["resblock_kernel_sizes"])
    rd = tuple(tuple(d) for d in cfg["resblock_dilation_sizes"])
    block = cfg["mrf_block"]
    halo = max(ResBlock1.halo(k, d) for k, d in zip(rk, rd))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = 0.0
    timed = []
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, flops=0.0, bytes=0.0)
    peak, peak_name = ((PEAK_BF16_FLOPS, "bf16 989e12") if bf16
                       else (PEAK_TF32_FLOPS, "tf32 495e12"))
    elem = 2 if bf16 else 4
    for c, t in mrf_stages(cfg, np):
        x = torch.randn((1, t, c), generator=gen, device=dev).to(dtype)
        xb, mask, _ = _blockify(x, block, halo)
        weights = [[tuple((torch.randn((k, c, c), generator=gen, device=dev)
                           / math.sqrt(k * c),
                           0.1 * torch.randn((c,), generator=gen,
                                             device=dev))
                          for _ in range(2)) for _ in ds]
                   for k, ds in zip(rk, rd)]
        kw = dict(kernels=rk, dilations=rd, block=block, halo=halo)
        before = counter.count
        out = mrfk.fused_mrf_blocks(xb, mask, weights, compute_dtype=dtype,
                                    **kw)
        per_call = counter.count - before
        ref = plain_fn(xb, mask, weights, **kw)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        if bf16:
            tol = MRF_BF16_ULPS * ulp_bf16(scale)
            tol_text = f"{MRF_BF16_ULPS}ulp(max|y|)={tol:.3e}"
        else:
            tol = MRF_REL_TOL * scale
            tol_text = f"{MRF_REL_TOL:g}*max|y|"
        call = functools.partial(mrfk.fused_mrf_blocks, xb, mask, weights,
                                 compute_dtype=dtype, **kw)
        plain = functools.partial(plain_fn, xb, mask, weights, **kw)
        ms, plain_ms = time_ms(torch, call, 10), time_ms(torch, plain, 10)
        timed.append((f"{tag} C={c}", call, plain))
        # the group's own work on the true T rows (no halo or padding
        # rows): 2 convs per dilation, each 2*T*C*C*k FLOP; x read and y
        # written once, and the weights (f32 biases)
        sum_k = sum(2 * k * len(ds) for k, ds in zip(rk, rd))
        flops = 2.0 * t * c * c * sum_k
        nbytes = (elem * 2.0 * t * c +
                  sum((elem * 2 * k * c * c + 4 * 2 * c) * len(ds)
                      for k, ds in zip(rk, rd)))
        b_ms, b_by = bound_ms(flops, nbytes, peak)
        # the step of widest reach: its tile has the most rows
        k_w, d_w = max(((k, d) for k, ds in zip(rk, rd) for d in ds),
                       key=lambda kd: (kd[0] - 1) * kd[1])
        fits, smem = mrfk.occupancy(c, k_w, d_w, dtype)
        say(f"kernel {tag} C={c}", t0, xb=tuple(xb.shape),
            dtype=str(dtype).split(".")[-1], max_abs_err=f"{err:.3e}",
            max_abs_y=f"{scale:.3e}", rel_err=f"{err / scale:.3e}",
            tol=tol_text, ok=err <= tol, launches_per_call=per_call,
            widest_step_smem_bytes=smem, blocks_per_sm=fits,
            ms=f"{ms:.3f}", plain_ms=f"{plain_ms:.3f}",
            bound_ms=f"{b_ms:.3f}", bound_by=b_by, peak=peak_name,
            flop=f"{flops:.3e}", tflops=f"{flops / ms / 1e9:.2f}",
            library_ms="none")
        require(out.shape == ref.shape and out.dtype == dtype and err <= tol,
                f"MRF kernel ({tag}) disagrees at C={c}: {err} > {tol}")
        steps = sum(len(ds) for ds in rd)
        require(per_call == steps,
                f"{tag} C={c}: {per_call} launches per call, not {steps}")
        worst = max(worst, err)
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["bound_ms"] += b_ms
        tot["flops"] += flops
        tot["bytes"] += nbytes
    _, by = bound_ms(tot["flops"], tot["bytes"], peak)
    say(f"kernel {tag} total", t0, flop=f"{tot['flops']:.4e}",
        ms=f"{tot['ms']:.3f}", bound_ms=f"{tot['bound_ms']:.3f}",
        share_of_bound=f"{tot['bound_ms'] / tot['ms']:.3f}")
    entry = dict(name="fused_mrf_blocks_bf16" if bf16 else
                 "fused_mrf_blocks", route="cuda",
                 source="stylesinger_torch/csrc/mrf.cu",
                 replaces="stylesinger_tpu/ops/mrf_pallas.py:141",
                 max_abs_err=worst, ms=tot["ms"], plain_ms=tot["plain_ms"],
                 bound_ms=tot["bound_ms"], bound_by=by, library_ms=None)
    return entry, timed


def make_infer(cfg, phones, device, seed, frames=None):
    """A seeded random-weight model.  Random weights give ~0-frame phones,
    so the duration head is set to log(1 + frames) (default: the mean note
    of EXAMPLE) with its weights scaled by 0.1."""
    import numpy as np
    import torch

    from stylesinger_torch.inference import StyleSingerInfer

    infer = StyleSingerInfer(cfg, phone_list=phones, device=device)
    infer.init_random(seed)
    if frames is None:
        frames = np.mean(EXAMPLE["notes_duration"]) * \
            cfg["audio_sample_rate"] / cfg["hop_size"]
    head = infer.model.dur_predictor.out
    with torch.no_grad():
        head.weight.mul_(0.1)
        head.bias.fill_(float(np.log1p(frames)))
    return infer


def expected_calls(cfg):
    """Denoiser calls per request: (F0 chains, mel sampler)."""
    from stylesinger_torch.models import diffusion as diff

    f0 = 2 * len(range(cfg["f0_timesteps"] - 1, -1,
                       -int(cfg.get("f0_speedup", 1))))
    k = cfg["K_step"]
    if int(cfg.get("dpm_steps", 0) or 0) > 0:
        mel = len(diff.dpmpp_grid(diff.make_schedule(cfg["timesteps"],
                                                     cfg["max_beta"]),
                                  k, cfg["dpm_steps"])[0])
    elif int(cfg.get("pndm_speedup", 1) or 1) > 1:
        # steps t = K - s, K - 2s, .., 0; the first calls the denoiser twice
        steps = len(range(k - cfg["pndm_speedup"], -1, -cfg["pndm_speedup"]))
        mel = steps + 1 if steps else 0
    else:
        mel = k
    return f0, mel


def count_denoiser_calls(model) -> dict:
    """Counts the calls of the F0 and mel denoisers (forward hooks)."""
    calls = {"f0": 0, "mel": 0}

    def hook(key):
        def tick(*_):
            calls[key] += 1
        return tick

    for name in ("gm_diffnet", "gm_diffnet_inpainte"):
        getattr(model, name).register_forward_hook(hook("f0"))
    model.postdiff.register_forward_hook(hook("mel"))
    return calls


def counters():
    from stylesinger_torch.kernels import mel as melk
    from stylesinger_torch.kernels import mrf as mrfk

    return {"mel_spectrogram": melk.counter,
            "fused_mrf_blocks": mrfk.counter,
            "fused_mrf_blocks_bf16": mrfk.counter_bf16}


def run_path(t0, torch, np, infer, calls, label, requests, wav_np,
             expect):
    """Drives ``infer_once`` over ``requests``, with every launch count and
    the denoiser-call counts set to 0 just before and read just after.
    ``expect``: launches per request of each kernel.  Returns the path's
    launches."""
    cfg = infer.cfg
    want_calls = expected_calls(cfg)
    for ctr in counters().values():
        ctr.reset()
    calls.update(f0=0, mel=0)
    lat_total = audio_total = 0.0
    for n, req in enumerate(requests):
        req = dict(req, ref_audio=wav_np)
        before = {k: c.count for k, c in counters().items()}
        calls_before = dict(calls)
        torch.cuda.synchronize()
        tr = time.perf_counter()
        wav = infer.infer_once(req)
        torch.cuda.synchronize()
        lat = time.perf_counter() - tr
        launches = {k: c.count - before[k] for k, c in counters().items()}
        n_calls = (calls["f0"] - calls_before["f0"],
                   calls["mel"] - calls_before["mel"])
        audio_s = wav.shape[0] / cfg["audio_sample_rate"]
        finite = bool(np.isfinite(wav).all())
        say(f"request {label} {n}", t0, phones=len(req["ph"].split()),
            note_s=f"{sum(req['notes_duration']):.2f}",
            latency_s=f"{lat:.3f}", samples=wav.shape[0],
            audio_s=f"{audio_s:.2f}",
            rtf=f"{lat / audio_s:.4f}" if audio_s > 0 else "inf",
            finite=finite, mel_launches=launches["mel_spectrogram"],
            mrf_launches=launches["fused_mrf_blocks"],
            mrf_bf16_launches=launches["fused_mrf_blocks_bf16"],
            denoiser_calls_f0=n_calls[0], denoiser_calls_mel=n_calls[1])
        require(finite and wav.ndim == 1 and wav.shape[0] > 0,
                f"request {label} {n}: bad output {wav.shape}")
        require(launches == expect,
                f"request {label} {n}: launches {launches}, expected "
                f"{expect}")
        require(n_calls == want_calls,
                f"request {label} {n}: denoiser calls {n_calls}, expected "
                f"{want_calls}")
        lat_total += lat
        audio_total += audio_s
    say(f"path {label}", t0, requests=len(requests),
        latency_s=f"{lat_total:.3f}", audio_s=f"{audio_total:.2f}",
        rtf=f"{lat_total / audio_total:.4f}",
        denoiser_calls_per_request=sum(want_calls))
    launches = {k: c.count for k, c in counters().items()}
    breakdown(t0, torch, infer, dict(requests[0], ref_audio=wav_np),
              label=f"breakdown {label} request 0")
    return launches


def phase_requests(t0, torch, np, cfg, recipe, wav_np):
    """The defaults path, the recipe path and the two fast-sampler paths.
    Returns the launches of each kernel on its path, the recipe's model
    and a callable that repeats the recipe's stage timing."""
    phones = sorted(set(EXAMPLE["ph"].split()))
    requests = [cut(EXAMPLE, 27), cut(EXAMPLE, 12), cut(EXAMPLE, 6)]
    stages = len(mrf_stages(cfg, np)) * sum(
        len(d) for d in cfg["resblock_dilation_sizes"])
    none = {k: 0 for k in counters()}

    infer = make_infer(cfg, phones, "cuda", SEED)
    n_params = sum(p.numel() for m in infer.modules()
                   for p in m.parameters())
    say("model", t0, hidden=cfg["hidden_size"], enc=cfg["enc_layers"],
        dec=cfg["dec_layers"], f0_net=f"{cfg['f0_residual_layers']}x"
        f"{cfg['f0_residual_channels']}", mel_net=f"{cfg['residual_layers']}"
        f"x{cfg['residual_channels']}", steps=cfg["timesteps"],
        max_frames=cfg["max_frames"],
        params=n_params, dur_head="bias=log1p(mean note frames),w*0.1",
        mrf_routes=infer.vocoder.mrf_routes(cfg["max_frames"]))
    calls = count_denoiser_calls(infer.model)
    defaults = run_path(t0, torch, np, infer, calls, "defaults",
                        requests[:1], wav_np,
                        dict(none, mel_spectrogram=1,
                             fused_mrf_blocks=stages))
    del infer

    infer = make_infer(recipe, phones, "cuda", SEED)
    say("model recipe", t0, vocoder_compute_dtype=recipe[
        "vocoder_compute_dtype"], mrf_routes=infer.vocoder.mrf_routes(
            recipe["max_frames"]))
    calls = count_denoiser_calls(infer.model)
    expect = dict(none, mel_spectrogram=1, fused_mrf_blocks_bf16=stages)
    launches = run_path(t0, torch, np, infer, calls, "recipe", requests,
                        wav_np, expect)
    for label, fast in (("fast dpm10_f0fast5", dict(f0_speedup=5,
                                                    dpm_steps=10)),
                        ("fast fast_both", dict(f0_speedup=5,
                                                pndm_speedup=5))):
        saved = {k: infer.cfg[k] for k in fast}
        infer.cfg.update(fast)
        run_path(t0, torch, np, infer, calls, label, requests, wav_np,
                 expect)
        infer.cfg.update(saved)
    launches["fused_mrf_blocks"] = defaults["fused_mrf_blocks"]
    req0 = dict(requests[0], ref_audio=wav_np)
    return launches, infer, functools.partial(
        breakdown, t0, torch, infer, req0)


def phase_streaming(t0, torch, np, infer, wav_np):
    """``HifiGAN_NSF.spec2wav_streaming`` on the recipe's request 0 mel."""
    from stylesinger_torch.kernels import mrf as mrfk
    from stylesinger_torch.vocoder_infer import HifiGAN_NSF

    out = infer.forward_model(infer.preprocess_input(
        dict(cut(EXAMPLE, 27), ref_audio=wav_np)))
    voc = HifiGAN_NSF(infer.cfg, model=infer.vocoder, device="cuda",
                      seed=SEED)
    mrfk.counter_bf16.reset()
    torch.cuda.synchronize()
    ts = time.perf_counter()
    wav = voc.spec2wav_streaming(out["mel"], out["f0"])
    torch.cuda.synchronize()
    lat = time.perf_counter() - ts
    frames, hop = out["mel"].shape[0], infer.cfg["hop_size"]
    say("spec2wav_streaming", t0, frames=frames, chunk_frames=256,
        overlap_frames=16, latency_s=f"{lat:.3f}", samples=wav.shape[0],
        finite=bool(np.isfinite(wav).all()),
        mrf_bf16_launches=mrfk.counter_bf16.count)
    require(wav.shape == (frames * hop,) and np.isfinite(wav).all(),
            f"spec2wav_streaming: bad output {wav.shape}")
    require(mrfk.counter_bf16.count > 0,
            "spec2wav_streaming: the bf16 MRF kernel was not launched")


def breakdown(t0, torch, infer, req, label="breakdown request 0"):
    """Where request 0's time goes: each stage ends in a synchronize."""
    from stylesinger_torch.models.diffusion import Noise

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    batch, t_pre = timed(lambda: infer.preprocess_input(req))
    noise = Noise(infer.cfg["seed"], infer.device)
    ret, t_model = timed(lambda: infer.model(**batch, noise=noise))
    _, t_voc = timed(lambda: infer.vocoder(ret["mel_out"], ret["f0_denorm"],
                                           noise))
    say(label, t0, preprocess_s=f"{t_pre:.3f}",
        acoustic_s=f"{t_model:.3f}", vocoder_s=f"{t_voc:.3f}")


def phase_device(t0, torch, timed) -> None:
    """Device time per call of each kernel's call and of its twin, from
    torch.profiler.  Runs after the requests, so that no profiler session
    comes before the timed requests."""
    for name, call, plain in timed:
        say(f"device {name}", t0, device_ms=f"{device_ms(torch, call):.4f}",
            plain_device_ms=f"{device_ms(torch, plain):.4f}",
            timer="torch.profiler")


class _Replay:
    """Hands out recorded draws in order, on a given device (the
    ``models/diffusion.py::Noise`` interface)."""

    def __init__(self, draws, device):
        self.draws = list(draws)
        self.device = device

    def _next(self, kind, shape):
        k, a = self.draws.pop(0)
        if k != kind or tuple(a.shape) != tuple(shape):
            raise Failure(f"noise replay out of order: {kind}{shape}")
        return a.to(self.device).clone()

    def normal(self, shape):
        return self._next("n", shape)

    def uniform(self, shape):
        return self._next("u", shape)

    def randint(self, shape, low, high):
        return self._next("i", shape)

    def bernoulli(self, p, shape=()):
        return self._next("b", shape)


class _Recorder:
    def __init__(self, seed):
        import torch

        self.g = torch.Generator().manual_seed(seed)
        self.draws = []

    def normal(self, shape):
        import torch

        a = torch.randn(tuple(shape), generator=self.g)
        self.draws.append(("n", a))
        return a.clone()

    def uniform(self, shape):
        import torch

        a = torch.rand(tuple(shape), generator=self.g)
        self.draws.append(("u", a))
        return a.clone()

    def randint(self, shape, low, high):
        import torch

        a = torch.randint(low, high, tuple(shape), generator=self.g)
        self.draws.append(("i", a))
        return a.clone()

    def bernoulli(self, p, shape=()):
        import torch

        a = torch.rand(tuple(shape), generator=self.g) < p
        self.draws.append(("b", a))
        return a.clone()


def small_pair(t0, torch, np, cfg, wav_np, label):
    """A tiny model on the card (kernels) and on the CPU (plain twins), the
    same weights, input and noise: fails unless mel, f0 and wav agree."""
    phones = sorted(set(EXAMPLE["ph"].split()))
    cpu = make_infer(cfg, phones, "cpu", SEED, frames=6)
    gpu = make_infer(cfg, phones, "cuda", SEED, frames=6)
    req = dict(cut(EXAMPLE, 6), ref_audio=wav_np[:48000])
    b_cpu = cpu.preprocess_input(req)
    for ctr in counters().values():
        ctr.reset()
    b_gpu = gpu.preprocess_input(req)
    rec = _Recorder(SEED)
    out_cpu = cpu.forward_model(b_cpu, noise=rec)
    out_gpu = gpu.forward_model(b_gpu, noise=_Replay(rec.draws, "cuda"))
    launches = {k: c.count for k, c in counters().items()}
    mel_err = float((b_gpu["ref_mels"].cpu() - b_cpu["ref_mels"]).abs().max())
    errs = {k: float(np.abs(out_gpu[k] - out_cpu[k]).max())
            if out_gpu[k].shape == out_cpu[k].shape else float("inf")
            for k in ("mel", "f0", "wav")}
    frames = out_cpu["mel"].shape[0]
    say(f"small {label}", t0, frames=frames,
        phones=len(req["ph"].split()), ref_mel_err=f"{mel_err:.2e}",
        **{f"{k}_err": f"{v:.2e}" for k, v in errs.items()},
        tol="1e-3", mel_launches=launches["mel_spectrogram"],
        mrf_launches=launches["fused_mrf_blocks"],
        mrf_routes=gpu.vocoder.mrf_routes(frames))
    require(frames > 0, f"small {label}: no frames")
    require(mel_err <= 3e-3 and all(v <= 1e-3 for v in errs.values()),
            f"small {label}: card and CPU disagree {errs}")
    require(launches["mel_spectrogram"] == 1,
            f"small {label}: the mel kernel was not launched once")
    return launches


def phase_small(t0, torch, np, wav_np):
    """Small inputs, the card against the CPU: the tiny model; the ProDiff
    / FFT-denoiser / conv-pitch model with a ResBlock2 vocoder; a generator
    past the MRF kernel's reach; the mel kernel at n_fft 2048 and 1000."""
    from stylesinger_torch.config import tiny_test_config
    from stylesinger_torch.inference import init_random_
    from stylesinger_torch.kernels import mel as melk
    from stylesinger_torch.models.diffusion import Noise
    from stylesinger_torch.models.hifigan import HifiGanGenerator

    launches = small_pair(t0, torch, np, tiny_test_config(
        hop_size=64, mrf_block=64), wav_np, "input")
    require(launches["fused_mrf_blocks"] > 0,
            "small input: the MRF kernel was not launched")
    launches = small_pair(t0, torch, np, tiny_test_config(
        hop_size=64, mrf_block=64, f0_gen="conv", decoder="prodiff",
        diff_decoder_type="fft", resblock="2"), wav_np,
        "prodiff_fft_conv_resblock2")
    require(launches["fused_mrf_blocks"] == 0,
            "small ResBlock2: a stage went to the MRF kernel")

    # a generator with k = 11, d = 7 (reach 70 > 64): the resblock modules
    cfg = tiny_test_config(mrf_block=64, resblock_kernel_sizes=(3, 11),
                           resblock_dilation_sizes=((1, 3), (1, 7)))
    cpu = HifiGanGenerator(cfg)
    init_random_(cpu, torch.Generator().manual_seed(SEED), conv_std=0.05)
    gpu = HifiGanGenerator(cfg)
    gpu.load_state_dict(cpu.state_dict())
    gpu.to("cuda")
    mel = torch.randn((1, 40, cfg["audio_num_mel_bins"]),
                      generator=torch.Generator().manual_seed(SEED))
    f0 = torch.full((1, 40), 220.0)
    rec = _Recorder(SEED)
    ref = cpu(mel, f0, rec)
    for ctr in counters().values():
        ctr.reset()
    out = gpu(mel.cuda(), f0.cuda(), _Replay(rec.draws, "cuda")).cpu()
    err = float((out - ref).abs().max())
    say("small reach>64 generator", t0, reach=10 * 7,
        mrf_routes=gpu.mrf_routes(40), wav_err=f"{err:.2e}", tol="1e-5",
        mrf_launches=counters()["fused_mrf_blocks"].count)
    require(err <= 1e-5, f"reach>64 generator: card and CPU differ {err}")
    require(counters()["fused_mrf_blocks"].count == 0,
            "reach>64 generator: a stage went to the MRF kernel")

    dev = torch.device("cuda")
    wav = torch.as_tensor(wav_np, device=dev)
    for n_fft, hop in ((2048, 512), (1000, 250)):
        kw = dict(sample_rate=48000, n_fft=n_fft, hop_size=hop,
                  win_length=n_fft, n_mels=80, fmin=20.0, fmax=24000.0)
        consts = melk._constants(48000, n_fft, n_fft, 80, 20.0, 24000.0, dev)
        melk.counter.reset()
        out = melk.mel_spectrogram(wav, **kw)
        ref = melk.mel_spectrogram_plain(wav, *consts, hop, 1e-6)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        ok = bool(torch.allclose(out, ref, **MEL_TOL))
        say(f"small mel n_fft={n_fft}", t0, shape=tuple(out.shape),
            branch="fft" if n_fft & (n_fft - 1) == 0 else "dft",
            max_abs_err=f"{err:.3e}", tol="atol3e-3/rtol2e-3", ok=ok,
            mel_launches=melk.counter.count)
        require(ok and melk.counter.count == 1,
                f"mel kernel at n_fft {n_fft}: {err}")


def synthetic_items(np, n, frames, phones, mel_bins, vocab, seed):
    """Seeded training items: frames and phones drawn from the given
    ranges, each phone a run of frames, f0 around 150-250 Hz."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        t = int(rng.integers(*frames))
        tt = int(rng.integers(*phones))
        mel2ph = np.sort(rng.integers(1, tt + 1, t))
        mel2ph[:tt] = np.arange(1, tt + 1)
        items.append({
            "item_name": f"synthetic_{i}",
            "mel": (rng.standard_normal((t, mel_bins)) * 0.5 - 3).astype(
                np.float32),
            "mel2ph": np.sort(mel2ph),
            "f0": (150 + 100 * rng.uniform(size=t)).astype(np.float32),
            "ph_token": rng.integers(1, vocab, tt),
            "ep_pitches": rng.integers(40, 80, tt),
            "ep_notedurs": rng.uniform(0.1, 0.6, tt).astype(np.float32),
            "ep_types": np.ones(tt, np.int64),
            "spk_embed": rng.standard_normal(256).astype(np.float32),
            "emo_embed": rng.standard_normal(256).astype(np.float32),
        })
    return items


def collated(cfg, items):
    from stylesinger_torch.data.batching import collate_batch
    from stylesinger_torch.data.dataset import StyleSingerDataset

    ds = StyleSingerDataset(cfg, "train", items=items)
    return collate_batch([ds[i] for i in range(len(ds))],
                         cfg["frame_buckets"], cfg["token_buckets"])


def phase_train_small(t0, torch, np):
    """One train step of the tiny model, the card against the CPU."""
    from stylesinger_torch.config import tiny_test_config
    from stylesinger_torch.models.stylesinger import StyleSinger
    from stylesinger_torch.training import step as ts

    cfg = tiny_test_config()
    vocab = 20
    batch = collated(cfg, synthetic_items(np, 4, (16, 30), (3, 7), 16, vocab,
                                          SEED))
    phase = ts.Phase(use_rq=True, forcing=False, use_diff=True)
    cpu = ts.init_state(StyleSinger(cfg, vocab), cfg)
    model = StyleSinger(cfg, vocab)
    model.load_state_dict(cpu.model.state_dict())
    gpu = ts.TrainState(model.cuda(), ts.Optimizer(
        dict(model.named_parameters()), cfg))
    recs = {s: _Recorder(SEED + i) for i, s in enumerate(ts.STREAMS)}
    m_cpu = ts.train_step(cpu, ts.batch_to_device(batch, "cpu"), phase, cfg,
                          noise=recs)
    m_gpu = ts.train_step(gpu, ts.batch_to_device(batch, "cuda"), phase,
                          cfg, noise={s: _Replay(r.draws, "cuda")
                                      for s, r in recs.items()})
    torch.cuda.synchronize()
    errs = {k: abs(float(m_gpu[k]) - float(v)) / max(1.0, abs(float(v)))
            for k, v in m_cpu.items()}
    g_cpu = {k: p.grad for k, p in cpu.model.named_parameters()}
    g_max = max(float(g.abs().max()) for g in g_cpu.values()
                if g is not None)
    worst, worst_name = 0.0, ""
    for name, p in gpu.model.named_parameters():
        ref = g_cpu[name]
        if ref is None:
            require(p.grad is None or not p.grad.any(),
                    f"small train step: {name} has a gradient on the card "
                    "only")
            continue
        err = float((p.grad.cpu() - ref).abs().max())
        tol = 1e-3 * float(ref.abs().max()) + 1e-6 * g_max
        if err / tol > worst:
            worst, worst_name = err / tol, name
    buf_err = max(float((b.cpu() - cpu.model.state_dict()[k]).abs().max())
                  for k, b in gpu.model.state_dict().items()
                  if ".codebook_" in k)
    say("small train step", t0, losses=len(m_cpu) - 2,
        worst_loss_err=f"{max(errs.values()):.2e}", tol="1e-3",
        grad_norm=f"{float(m_cpu['grad_norm']):.4f}",
        worst_grad_err_over_tol=f"{worst:.3f}", at=worst_name,
        rq_buffer_err=f"{buf_err:.2e}")
    require(all(e <= 1e-3 for e in errs.values()),
            f"small train step: losses differ {errs}")
    require(worst <= 1.0, f"small train step: gradient {worst_name} "
            f"differs ({worst:.2f} x its tolerance)")


def phase_train_recipe(t0, torch, np):
    """Trainer.fit at the recipe's full width: 12 steps, 6 in each phase of
    the curriculum, validation, a checkpoint, and an exact restore.  Each
    phase's first step pays for its first run; its 5 warm steps give the
    phase's median and spread, and the last phase's warm steps the
    steps/s."""
    import tempfile

    from stylesinger_torch.config import load_config
    from stylesinger_torch.models.stylesinger import StyleSinger
    from stylesinger_torch.training import step as ts
    from stylesinger_torch.training import trainer as tr

    cfg = load_config(recipe="stylesinger", forcing=TRAIN_PHASE_STEPS,
                      rq_start=TRAIN_PHASE_STEPS - 1,
                      diff_start=TRAIN_PHASE_STEPS - 1, tb_log_interval=1,
                      val_check_interval=2 * TRAIN_PHASE_STEPS,
                      num_ckpt_keep=1)
    n_steps = 2 * TRAIN_PHASE_STEPS
    vocab = 64
    batch = collated(cfg, synthetic_items(
        np, 8, (600, 1001), (60, 121), cfg["audio_num_mel_bins"], vocab,
        SEED))
    require(batch["mels"].shape == (8, 1024, 80) and
            batch["txt_tokens"].shape == (8, 128),
            f"train recipe: buckets {batch['mels'].shape}")
    require(8 * batch["mels"].shape[1] <= cfg["max_tokens"],
            "train recipe: the batch exceeds max_tokens")
    steps, first = [], {}
    train_step = tr.train_step

    def timed_step(state, b, phase, c):
        if not first:
            first.update({k: v.detach().clone() for k, v in
                          state.model.state_dict().items()})
        torch.cuda.synchronize()
        tb = time.perf_counter()
        m = train_step(state, b, phase, c)
        torch.cuda.synchronize()
        steps.append((phase, time.perf_counter() - tb, m))
        return m

    for ctr in counters().values():
        ctr.reset()
    torch.cuda.reset_peak_memory_stats()
    tr.train_step = timed_step
    work = tempfile.TemporaryDirectory(prefix=".train_smoke_", dir=str(REPO))
    try:
        trainer = tr.Trainer(StyleSinger(cfg, vocab), cfg, work.name)
        state = trainer.fit([batch], lambda: [batch], max_updates=n_steps)
        tr.train_step = train_step
        peak = torch.cuda.max_memory_allocated()
        launches = {k: c.count for k, c in counters().items()}
        b_dev = ts.batch_to_device(batch, "cuda")
        last = ts.phase_for_step(n_steps - 1, cfg)
        torch.cuda.synchronize()
        te = time.perf_counter()
        ev = ts.eval_step(state, b_dev, last, cfg)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - te
        again = tr.Trainer(StyleSinger(cfg, vocab), cfg, work.name)
        restored = again.init_state()
        saved = state.model.state_dict()
        same = all(torch.equal(v, saved[k]) for k, v in
                   restored.model.state_dict().items())
        opt_a, opt_b = state.opt.state_dict(), restored.opt.state_dict()
        same_opt = opt_a["count"] == opt_b["count"] and all(
            torch.equal(opt_a[key][n], opt_b[key][n])
            for key in ("mu", "nu") for n in opt_a[key])
        ckpt_steps = trainer.ckpt.all_steps()
    finally:
        tr.train_step = train_step
        work.cleanup()
    n_params = sum(p.numel() for p in state.model.parameters())
    for i, (phase, sec, m) in enumerate(steps):
        say(f"train recipe step {i}", t0, flags="/".join(
            k for k, v in phase._asdict().items() if v) or "none",
            ms=f"{1e3 * sec:.1f}", total_loss=f"{float(m['total_loss']):.4f}",
            grad_norm=f"{float(m['grad_norm']):.4f}", losses=len(m) - 2)
    by_phase = {}
    for phase, sec, _ in steps:
        by_phase.setdefault(phase, []).append(1e3 * sec)
    per_phase = {}
    for ph, ms in by_phase.items():
        name = "_".join(k for k, v in ph._asdict().items() if v)
        warm = sorted(ms[1:])
        per_phase[f"{name}_first_ms"] = f"{ms[0]:.1f}"
        per_phase[f"{name}_warm_median_ms"] = f"{np.median(warm):.1f}"
        per_phase[f"{name}_warm_min_max_ms"] = f"{warm[0]:.1f}/{warm[-1]:.1f}"
    last_warm = by_phase[steps[-1][0]][1:]
    moved = {k: float((v.float() - first[k].float()).abs().max())
             for k, v in saved.items() if k in first}
    ema_moved = max(v for k, v in moved.items()
                    if k.endswith(("embed_ema", "cluster_size_ema")))
    param_moved = max(moved[k] for k, _ in state.model.named_parameters())
    say("train recipe", t0, params=n_params, batch=tuple(batch["mels"].shape),
        tokens=tuple(batch["txt_tokens"].shape), steps=len(steps),
        **per_phase,
        steps_per_s_last_phase_warm=(
            f"{1e3 * len(last_warm) / sum(last_warm):.3f}"),
        peak_mem_gib=f"{peak / 2 ** 30:.2f}",
        eval_ms=f"{1e3 * eval_s:.1f}",
        eval_total_loss=f"{float(ev['total_loss']):.4f}",
        param_moved=f"{param_moved:.3e}", ema_moved=f"{ema_moved:.3e}",
        ckpt_steps=ckpt_steps, restored_step=restored.step,
        restore_exact=same and same_opt, launches=launches,
        timer="host clock, cuda.synchronize")
    last_keys = {"diff", "gdiff1", "mdiff1", "gdiff2", "mdiff2", "gloss",
                 "rq_loss", "l1", "ssim", "pdur", "sdur"}
    require(len(steps) == n_steps and state.step == n_steps,
            f"train recipe: not {n_steps} steps")
    require([tuple(p) for p, _, _ in steps] ==
            [(False, True, False)] * TRAIN_PHASE_STEPS +
            [(True, False, True)] * TRAIN_PHASE_STEPS,
            "train recipe: the curriculum did not run its two phases")
    require(all(np.isfinite(float(v)) for _, _, m in steps
                for v in m.values()), "train recipe: a non-finite loss")
    require(last_keys <= set(steps[-1][2]),
            f"train recipe: losses missing {last_keys - set(steps[-1][2])}")
    require(param_moved > 0 and ema_moved > 0,
            "train recipe: parameters or codebook EMA buffers did not move")
    require(ckpt_steps == [n_steps] and restored.step == n_steps and same
            and same_opt,
            "train recipe: the restore does not equal the saved state")
    require(all(v == 0 for v in launches.values()),
            f"train recipe: a kernel launched on the training path "
            f"{launches}")


def main() -> int:
    t0 = time.perf_counter()
    if not (REPO / "stylesinger_torch" / "csrc").is_dir():
        print("chip_smoke: stylesinger_torch/ is not beside this script",
              file=sys.stderr)
        return 3
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    sys.path.insert(0, str(REPO))
    from stylesinger_torch.config import load_config

    try:
        smi = phase_env(t0, torch)
        cfg = load_config()
        recipe = load_config(recipe="stylesinger")
        wav_np = reference_clip(np, sr=cfg["audio_sample_rate"])
        mel, mel_timed = phase_mel(t0, torch, np, wav_np)
        mrf, mrf_timed = phase_mrf(t0, torch, np, cfg)
        mrf16, mrf16_timed = phase_mrf(t0, torch, np, recipe, bf16=True)
        kernels = [mel, mrf, mrf16]
        launches, infer, again = phase_requests(t0, torch, np, cfg, recipe,
                                                wav_np)
        phase_streaming(t0, torch, np, infer, wav_np)
        phase_small(t0, torch, np, wav_np)
        phase_train_small(t0, torch, np)
        phase_train_recipe(t0, torch, np)
        phase_device(t0, torch, mel_timed + mrf_timed + mrf16_timed)
        again(label="breakdown recipe request 0 after profiling")
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    for k in kernels:
        k["launches"] = launches[k["name"]]
    order = ["name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    say("total", t0, seconds=f"{time.perf_counter() - t0:.1f}")
    print(json.dumps({"kernels": [{k: e[k] for k in order}
                                  for e in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
