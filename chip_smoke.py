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
   f32 mode and its bf16 mode (with the blocks that fit on an SM), and
   the denoisers' residual-layer kernel over the F0 and mel nets' layers
   and one sampler step's 40 of them (``library_ms``: cuDNN's f32 convs
   of the same layers);
2. zero-shot requests through ``StyleSingerInfer.infer_once`` on
   flagship-width models with seeded random weights, path by path, each
   with every launch count and the denoiser-call counts set to 0 just
   before it and read just after:
   - ``defaults`` (``load_config()``, f32 vocoder): one request, which must
     launch the mel kernel once and the f32 MRF mode 27 times;
   - ``recipe`` (``load_config(recipe="stylesinger")``, the repo's recipe:
     bf16 vocoder, 100-step samplers): three requests, each 1 mel and 27
     bf16-mode MRF launches and 2 x 100 + 100 denoiser calls (every path
     also counts its residual-layer kernel launches: 10 per F0 and 20 per
     mel denoiser call, 4,000 a 100-step request);
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
     1024-frame / 128-token buckets, for 12 steps across a scaled-down
     curriculum (``forcing=6, rq_start=5, diff_start=5``: 6 forcing
     steps, then 6 with RQ and the mel diffusion), validation and a
     checkpoint at step 12, then a restore that resumes at step 12 and
     must equal the saved state exactly; it prints each step's time (host
     clock between ``torch.cuda.synchronize()`` calls), steps/s after the
     first step, the peak memory and one eval step's time, and it launches
     neither kernel;
   - ``train bf16``: the same run at ``compute_dtype=bfloat16`` (bf16
     activations at the JAX package's cast sites, f32 parameters), its
     warm step times per phase and its peak memory above what was
     allocated when it started, beside the f32 run's; then one bf16 step
     of the tiny model on the card against the CPU's bf16 step: every loss
     finite and within 1e-4 (relative, atol 1e-4), the gradients at cosine
     similarity above 0.9999 and within 1e-2 in relative L2; every compute
     layer of the card's step (the attention's ``qkv``, the FFN's
     ``Conv_0`` and WaveNet's ``in_0`` among them) returned bf16, and its
     gradient is more than 0.4 % (relative L2) from the CPU's f32 step's;
     no kernel;
   - ``train dispatch``: the ``train recipe`` run with
     ``steps_per_dispatch=6``, f32 and then bf16, under deterministic
     algorithms and an lr that warms up over 6 steps: two windows of 6
     steps, each phase's first step eager and the capture following it,
     the other 5 CUDA graph replays; each step's losses and grad norm,
     and each parameter, RQ codebook buffer and Adam moment after the 12
     steps, against 12 eager steps from the same weights, within 1e-6
     relative, the spread of two eager runs printed beside it; no kernel;
   - ``settings``: one tiny train step each with ``decoder: prodiff`` (on
     the WaveNet and on the FFT denoiser), ``use_spk_id``, ``rel_pos`` and
     ``pitch_type: ph``, on the card against the CPU at the ``small train
     step`` tolerances; no kernel;
   - ``data parallel``: one tiny step through ``init_distributed`` at world
     size 1 on NCCL against the plain step on the card; then two ranks on
     the one card as two processes over gloo (NCCL refuses two ranks on one
     device; the port's collectives are all ``all_reduce``, which gloo
     runs on CUDA tensors), with batches in different buckets (2 x 32
     frames, 4 x 64), against one process's step on the two batches padded
     and concatenated: losses within 1e-4, gradients within 1e-3 *
     max|g_leaf| + 1e-6 * max|g|, RQ buffers within 1e-5, both ranks'
     states equal; each rank has a 300 s timeout;
   - ``model parallel``: the ``model`` mesh axis, two ranks on the one
     card over gloo in a 1 x 2 grid (``make_mesh(1, 2)``), every
     ``TransformerFFN`` split over them (``shard_params``), one tiny step
     on the same 4 rows against one process's step at the ``data
     parallel`` tolerances on the gathered gradients and state, the
     replicated leaves equal on both ranks bit for bit; no kernel;
5. training the vocoder GAN on the card:
   - ``small vocoder gan step``: one discriminator + generator iteration of
     the tiny GAN on the card against the CPU (same weights, batch and
     draws, TF32 off): every loss within 1e-5, each gradient and updated
     parameter within the CPU tests' tolerances, 27 MRF launches in the
     discriminator step and none in the generator step;
   - ``vocoder gan``: ``fit_vocoder`` at the flagship vocoder's width
     (``load_config()``: NSF HiFi-GAN 512 -> 32 channels, 8·8·2·2,
     ``mrf_block`` 2048, f32, MPD + MSD, AdamW) on 16 x 64-frame crops of
     8 seeded harmonic items and their ``wav2spec`` mels: 6 iterations on
     host crops (1 warm-up, 5 warm), then 2 through the device loop; each
     step's time and MRF launches (27 per discriminator step, 0 per
     generator step), iterations/s, peak memory; then an exact restore of
     the saved state, the saved ``generator.pt`` through ``HifiGAN_NSF``'s
     ``vocoder_ckpt`` (the trainer's weights, its ``spec2wav`` of a
     512-frame item equal to the trainer's generator, 27 MRF launches), one
     iteration from the restored state against the unbroken one, the
     discriminator step's generator pass on one crop batch on the MRF
     kernel against the "blocks" route (1e-4 of max|y|), and the
     resynthesis mel L1 through ``wav2spec`` (the mel kernel, held against
     its plain twin on both wavs), finite, with no gate on random-start
     weights;
   - ``vocoder gan dispatch``: ``fit_vocoder(spd=10)`` at that width and
     those crops, under deterministic algorithms: one CUDA graph of the
     iteration (crops, discriminator step with the f32 MRF kernel in its
     generator pass, generator step), 9 replays; its losses and
     parameters against the same 10 iterations run eagerly, within 1e-6
     relative; the wrapper counts the eager iteration's 27 MRF launches
     and the 27 the capture records into the graph;
6. singing with what phases 4 and 5 trained, at the recipe's width (the
   ``train recipe`` work dir and the ``vocoder gan`` generator are kept
   in a temporary directory inside the checkout until then):
   - ``checkpoint infer``: ``StyleSingerInfer(recipe).load_params(work
     dir)`` with the trained ``generator.pt`` as ``vocoder_ckpt`` and two
     GE2E files of seeded weights in the reference's layout, each loaded
     tensor bit for bit what was saved; the example phrase's 27 / 12 / 6
     phones, each float output of the acoustic model (durations, mel,
     ...) and the wav of the whole mel (before the crop to the predicted
     length, which a 12-step model leaves short or empty) within 1e-5 of
     their max of an instance that holds the trainer's in-memory state,
     the cropped wavs of one length, 1 mel and 27 bf16 MRF launches each; then the phrase through ``run.py
     infer`` from the work dir (its wav within 1 LSB); ``load_params``
     seconds, latency, audio seconds and RTF are printed;
   - ``test split``: ``run.py test`` from the same work dir on a 4-item
     test split written with the port's shard writer, ``test_ids=[0, 2,
     3]`` and the fast samplers: 3 items with their ``_gt`` twins,
     ``meta.csv``, ``result_f0s.npy``, and 9 bf16 MRF launches per stage
     of each ``spec2wav`` that fits the kernel and holds two blocks (27
     per ground-truth mel, none for a generated one of a few frames); then
     ``evaluate_dir`` with the speaker encoder's file, 2 mel launches per
     pair, MCD / FFE / d-vector cosine finite, and the mel kernel against
     its plain twin on a generated wav; the trained vocoder on a
     ground-truth mel, each bf16 MRF stage and the wav against the plain
     bf16 twin within 2 bf16 ulps of max|y|; seconds per item and per
     pair;
7. ``data prep``: a raw corpus to training shards at the recipe's audio
   settings (48 kHz, fft 1024, hop 256, 80 mels, both GE2E encoders from
   seeded files, ``write_tsd``): 32 seeded 4-12 s PCM16 wavs by three
   singers (a harmonic voice on one MIDI note per phone, hanzi lyrics;
   one singer the test split, 3 items the valid split) through
   ``Preprocessor`` and ``StyleSingingBinarizer`` on the card, 1 mel launch
   per binarized item (35: the valid items are train items too), with
   items/s, audio seconds per second, each stage's seconds and the peak
   memory; 4 items binarized on the CPU against the card's (tokens,
   ``mel2ph`` and lengths exactly, the mel at the mel tolerance, voicing on
   >= 99.5 % of frames, voiced F0 within 1e-3 relative, d-vectors within
   1e-4); the mel kernel against its twin at the shortest and longest
   item, with its time per call there; every shard read back through the
   C++ TSD reader, and batch assembly timed with it and with the plain
   reader; ``run.py preprocess`` and ``run.py binarize`` in their own
   processes, their shards against the in-process ones; 4 steps of
   ``run.py train`` (``run.main``, in process, so that the launch counts
   can be read: none) on those shards, with a checkpoint and finite
   losses; then ``recipe file``: ``run.py train --config
   egs/stylesinger.yaml`` (the port's own YAML reader) in its own process
   for 2 steps of a small curriculum on those shards, its ``config.yaml``
   read back equal to the config it trained with;
9. the model families the main path does not run, f32 with TF32
   off, each after a tiny card-against-CPU check (same weights, inputs and
   noise or dropout draws; within 1e-4 of max(1, max|y|), gradient leaves
   within 1e-3 * max|g_leaf| + 1e-6 * max|g|), each launching neither
   kernel:
   - ``fs2``: ``FastSpeech2`` at ``load_config()``'s width (hidden 256,
     4 + 4 layers, d-vectors): one inference pass and 3 train steps
     (``training/fs2_task.py``) on 8 x 1024 frames x 128 phones;
   - ``pe``: the ``PitchExtractor`` at its defaults, 3 steps on those mels;
   - ``legacy vocoders``: the ``PWG`` (30 layers, 3 stacks, 64 / 128 / 64
     channels, scales 4·4·4·4) and ``MelGAN`` (512 base channels, 8·8·2·2)
     wrappers' ``spec2wav`` of the reference clip's mel, and ``PQMF``
     analysis then synthesis of the clip;
   - ``diffnet variants``: ``F0DiffNet`` / ``MDiffNet`` at 10 x 192, one
     forward over 1024 frames;
   - ``convert cli``: ``python -m stylesinger_torch.convert`` in its own
     process on a reference-layout ``.ckpt`` of a seeded tiny model
     (``tests/reference_layout.py``), ``load_params`` of the work dir it
     writes (within 1e-6 of the seeded weights) and one request on the
     card;
   - ``serving export dpm10_f0fast5`` (``serving/export.py``): the
     recipe's synthesizer with the fast samplers (50 denoiser calls
     unrolled) exported with ``torch.export`` on ``cuda`` at one bucket
     (batch 1, the example phrase's 64-token bucket, the 4 s clip's
     1024-frame bucket, ``max_frames`` 3000), saved, loaded and called on
     the draws of ``noise_from_seed(SEED)`` with TF32 off: wav, mel and F0
     within 1e-4 of the live ``make_synthesize_fn`` on the same draws,
     ``mel2ph`` equal, the mel within 1e-4 of ``forward_model`` with
     ``Noise(SEED)``, and 27 bf16 MRF launches per call, counted by the
     registered operator's CUDA implementation with every count set to 0
     just before the call; export, save and load seconds, the artifact's
     MB, first and warm call ms (the 100-step recipe's export is timed by
     ``serving_export_check.py``);
10. device time per call of each kernel and its twin at the shapes of
   phase 1 (``device_ms``: the durations of the CUDA kernels a call
   launches, from ``torch.profiler``), host gaps left out.  It runs last,
   so that no profiler session comes before the timed requests; the
   recipe's request 0 stage timing is then repeated, to show whether
   profiling slowed the process; then ``train dispatch timing``, on
   states of its own (a ``steps_per_dispatch=6`` fit to step 8, f32 and
   bf16): the capture time per phase, the draws a replay fills, warm ms
   per step graphed and eager in turns, peak memory, and the device's
   busy time and idle share of 3 graphed and 3 eager steps
   (``torch.profiler``); and ``vocoder gan timing`` (``fit_vocoder(spd=3)``
   at ``vocoder gan dispatch``'s shapes): ms per iteration graphed and
   eager in turns, and the MRF kernels ``torch.profiler`` sees in each
   of 2 replays (27, while the wrapper's count stays put).  The
   ``kernels`` line's launches are the requests' (phase 2).

It prints a JSON line with one entry per kernel, the ``nvidia-smi`` line,
and as its last line ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero.  Without a CUDA device, or without the package beside it, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 1234
# train recipe: steps per curriculum phase (the first pays the phase's
# first run)
TRAIN_PHASE_STEPS = 6
# train dispatch: steps per window (one window per curriculum phase)
DISPATCH_STEPS = TRAIN_PHASE_STEPS
# graphed against eager, under deterministic algorithms (relative, per
# metric, parameter, buffer or moment): the bound the card tests hold the
# tiny model to (tests/test_torch_cuda.py, where both agree bit for bit)
DISPATCH_REL_TOL = 1e-6
# the agreement runs' schedule: warm-up over one curriculum phase, so each
# step has its own lr (8.5e-5 up to 5.1e-4, then down to 3.6e-4) and a
# learning rate or bias correction frozen into a graph shows
DISPATCH_LR = dict(warmup_updates=TRAIN_PHASE_STEPS, lr=0.02)
PEAK_F32_FLOPS = 67e12   # H100 SXM, f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # H100 SXM, dense TF32 on the tensor cores
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores
PEAK_BYTES = 3.35e12     # H100 SXM HBM3
BUILD_LIMIT_S = 60.0
MEL_TOL = dict(atol=3e-3, rtol=2e-3)
MRF_REL_TOL = 1e-4       # of max|y|: the kernel sums in another order
DIFFNET_REL_TOL = 1e-5   # of max|y|: 3xTF32, summed in another order
TEST_IDS = (0, 2, 3)      # test split: the items run.py test synthesizes
MRF_BF16_ULPS = 2        # bf16 ulps of max|y|: an f32 sum in another order
                         # can land across a bf16 rounding
MIN_BF16_SPREAD = 4e-3   # a bf16 step's gradient off the f32 step's
                         # (relative L2; 1.2 % on the CPU at the tiny size)
# compute layers that must run in bf16 in a bf16 step
BF16_SITES = (".qkv", ".Conv_0", ".in_0", ".res_0.ln_0")

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


def phase_diffnet(t0, torch, cfg):
    """The denoisers' residual-layer kernel at the recipe's shapes (16 x
    ``max_frames`` rows; the F0 net's and the mel net's widths and layers,
    each layer with its own weights and conditioner projection at its
    dilation in the cycle).  Each dilation's layer against the plain twin
    (``DIFFNET_REL_TOL`` of max|y|, the output and the skip sum).  Timed
    with CUDA events around the whole call: each net's layers as one
    denoiser call runs them, and one sampler step of a request (``ms``:
    the layers of two F0 calls and one mel call, 40 launches, a hundredth
    of a 100-step request's), on the kernel, on the twin (``plain_ms``)
    and as cuDNN's f32 dilated and output convs of the same layers
    (``library_ms``, the yardstick; the port never calls them for this
    layer).  The conditioner projection is made once per chain on every
    side, so no side's time holds it.  The bound: the f32 products as
    3xTF32 at 495 / 3 TFLOP/s, or x, cp, out and skips (read and written)
    and the weights once at 3.35 TB/s."""
    import torch.nn.functional as F

    from stylesinger_torch.kernels import diffnet as dk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    b, t = 16, cfg["max_frames"]
    n, hidden = b * t, cfg["hidden_size"]
    worst_abs = worst_rel = 0.0
    timed, nets = [], {}

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    for net, c, n_layers, cycle in (
            ("f0", cfg["f0_residual_channels"], cfg["f0_residual_layers"],
             cfg["f0_dilation_cycle_length"]),
            ("mel", cfg["residual_channels"], cfg["residual_layers"],
             cfg["dilation_cycle_length"])):
        cond = r(b, t, hidden)
        layers = []
        for i in range(n_layers):
            w_dil, w_out = (r(2 * c, c, 3, scale=(3 * c) ** -0.5),
                            r(2 * c, c, 1, scale=c ** -0.5))
            b_dil, b_out = r(2 * c, scale=0.1), r(2 * c, scale=0.1)
            cp = dk.cond_projection(cond, r(2 * c, hidden, 1,
                                            scale=hidden ** -0.5),
                                    r(2 * c, scale=0.1), b_dil)
            layers.append(dict(cp=cp, w_dil=w_dil, w_out=w_out, b_dil=b_dil,
                               b_out=b_out, dilation=2 ** (i % cycle)))
        x, pstep, skips = r(b, t, c), r(b, c), r(b, t, c)
        net_abs = net_rel = 0.0
        for lay in layers[:cycle]:  # each dilation of the cycle once
            args = (x, pstep, lay["cp"], lay["w_dil"], lay["w_out"],
                    lay["b_out"])
            want_s, got_s = skips.clone(), skips.clone()
            want = dk.layer_plain(*args, want_s, dilation=lay["dilation"],
                                  first=False)
            before = dk.counter.count
            got = dk.diffnet_layer(*args, got_s, dilation=lay["dilation"],
                                   first=False)
            per_call = dk.counter.count - before
            torch.cuda.synchronize()
            errs = [((g - w).abs().max(), w.abs().max())
                    for g, w in ((got, want), (got_s, want_s))]
            err_abs = max(float(e) for e, _ in errs)
            err_rel = max(float(e / m) for e, m in errs)
            require(err_rel <= DIFFNET_REL_TOL and per_call == 1,
                    f"diffnet {net} d={lay['dilation']}: rel err "
                    f"{err_rel:.2e}, {per_call} launches")
            net_abs, net_rel = max(net_abs, err_abs), max(net_rel, err_rel)

        def stack(layer_fn, x=x, pstep=pstep, layers=layers, c=c):
            """The net's residual layers as one denoiser call runs them."""
            y, acc = x, torch.empty((b, t, c), device=dev)
            for i, lay in enumerate(layers):
                y = layer_fn(y, pstep, lay["cp"], lay["w_dil"],
                             lay["w_out"], lay["b_out"], acc,
                             dilation=lay["dilation"], first=i == 0)
            return y

        x_ncw, g_ncw = r(b, c, t), r(b, c, t)

        def library(layers=layers, x_ncw=x_ncw, g_ncw=g_ncw):
            for lay in layers:
                d = lay["dilation"]
                F.conv1d(x_ncw, lay["w_dil"], lay["b_dil"], padding=d,
                         dilation=d)
                F.conv1d(g_ncw, lay["w_out"], lay["b_out"])

        call = functools.partial(stack, dk.diffnet_layer)
        plain = functools.partial(stack, dk.layer_plain)
        ms, plain_ms, lib_ms = (time_ms(torch, call, 10),
                                time_ms(torch, plain, 10),
                                time_ms(torch, library, 10))
        flops = 2.0 * n * 4 * c * 2 * c * n_layers
        nbytes = 4.0 * n_layers * (n * c * 4 + n * 2 * c + 4 * c * 2 * c
                                   + 2 * c)
        b_ms, b_by = bound_ms(3 * flops, nbytes, PEAK_TF32_FLOPS)
        say(f"kernel diffnet {net} C={c}", t0, rows=n, layers=n_layers,
            dilations=",".join(str(lay["dilation"]) for lay in layers),
            max_abs_err=f"{net_abs:.3e}", rel_err=f"{net_rel:.2e}",
            tol=f"{DIFFNET_REL_TOL:g}*max|y|", launches_per_call=n_layers,
            ms=f"{ms:.4f}", ms_per_layer=f"{ms / n_layers:.4f}",
            plain_ms=f"{plain_ms:.4f}", library_ms=f"{lib_ms:.4f}",
            bound_ms=f"{b_ms:.4f}", bound_by=b_by, peak="3xTF32 495e12/3",
            flop=f"{flops:.3e}", tflops_f32=f"{flops / ms / 1e9:.2f}",
            share_of_bound=f"{b_ms / ms:.3f}",
            share_of_tf32_peak=f"{flops / PEAK_TF32_FLOPS * 1e3 / ms:.3f}")
        timed.append((f"diffnet {net} C={c}", call, plain))
        nets[net] = dict(call=call, plain=plain, library=library,
                         bound_ms=b_ms, flops=3 * flops, bytes=nbytes)
        worst_abs, worst_rel = max(worst_abs, net_abs), max(worst_rel,
                                                            net_rel)
    order = ("f0", "f0", "mel")  # one sampler step: two F0 calls, one mel

    def step(kind):
        return lambda: [nets[k][kind]() for k in order]

    call, plain = step("call"), step("plain")
    ms, plain_ms, lib_ms = (time_ms(torch, call, 10),
                            time_ms(torch, plain, 10),
                            time_ms(torch, step("library"), 10))
    b_ms = sum(nets[k]["bound_ms"] for k in order)
    _, by = bound_ms(sum(nets[k]["flops"] for k in order),
                     sum(nets[k]["bytes"] for k in order), PEAK_TF32_FLOPS)
    launches = sum({"f0": cfg["f0_residual_layers"],
                    "mel": cfg["residual_layers"]}[k] for k in order)
    say("kernel diffnet step", t0, calls="f0,f0,mel",
        launches_per_call=launches, max_abs_err=f"{worst_abs:.3e}",
        max_rel_err=f"{worst_rel:.2e}", ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", library_ms=f"{lib_ms:.4f}",
        bound_ms=f"{b_ms:.4f}", bound_by=by,
        share_of_bound=f"{b_ms / ms:.3f}")
    timed.append(("diffnet step", call, plain))
    entry = dict(name="diffnet_layer", route="cuda",
                 source="stylesinger_torch/csrc/diffnet.cu",
                 replaces="none (XLA: stylesinger_tpu/models/diffnet.py)",
                 max_abs_err=worst_abs, ms=ms, plain_ms=plain_ms,
                 bound_ms=b_ms, bound_by=by, library_ms=lib_ms)
    return entry, timed


def diffnet_launches(cfg):
    """Residual-layer kernel launches per request: every denoiser call
    runs its layers on the kernel when their widths are the kernel's."""
    from stylesinger_torch.kernels.diffnet import takes_layer

    f0, mel = expected_calls(cfg)
    cycle = [(cfg["f0_residual_channels"], cfg["f0_residual_layers"],
              cfg["f0_dilation_cycle_length"]),
             (cfg["residual_channels"], cfg["residual_layers"],
              cfg["dilation_cycle_length"])]
    per_call = [sum(takes_layer(c, 3, 2 ** (i % k)) for i in range(n))
                for c, n, k in cycle]
    return f0 * per_call[0] + mel * per_call[1]


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


def counters():
    from stylesinger_torch.kernels import mel as melk
    from stylesinger_torch.kernels import mrf as mrfk

    return {"mel_spectrogram": melk.counter,
            "fused_mrf_blocks": mrfk.counter,
            "fused_mrf_blocks_bf16": mrfk.counter_bf16}


def run_path(t0, torch, np, infer, label, requests, wav_np, expect):
    """Drives ``infer_once`` over ``requests``, with every launch count and
    the denoiser-call counters (``denoiser.f0`` / ``denoiser.mel`` of
    ``utils/profiling.py``) set to 0 just before and read just after.
    ``expect``: launches per request of each kernel.  Returns the path's
    launches."""
    from stylesinger_torch.kernels import diffnet as dk
    from stylesinger_torch.utils import profiling

    cfg = infer.cfg
    want_calls = expected_calls(cfg)
    want_layers = diffnet_launches(cfg)
    for ctr in counters().values():
        ctr.reset()
    dk.counter.reset()
    calls = ("denoiser.f0", "denoiser.mel")
    for name in calls:
        profiling.set_counter(name, 0)
    lat_total = audio_total = 0.0
    for n, req in enumerate(requests):
        req = dict(req, ref_audio=wav_np)
        before = {k: c.count for k, c in counters().items()}
        layers_before = dk.counter.count
        calls_before = [profiling.counter(name) for name in calls]
        torch.cuda.synchronize()
        tr = time.perf_counter()
        wav = infer.infer_once(req)
        torch.cuda.synchronize()
        lat = time.perf_counter() - tr
        launches = {k: c.count - before[k] for k, c in counters().items()}
        layers = dk.counter.count - layers_before
        n_calls = tuple(profiling.counter(name) - b
                        for name, b in zip(calls, calls_before))
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
            diffnet_launches=layers,
            denoiser_calls_f0=n_calls[0], denoiser_calls_mel=n_calls[1])
        require(finite and wav.ndim == 1 and wav.shape[0] > 0,
                f"request {label} {n}: bad output {wav.shape}")
        require(launches == expect,
                f"request {label} {n}: launches {launches}, expected "
                f"{expect}")
        require(n_calls == want_calls,
                f"request {label} {n}: denoiser calls {n_calls}, expected "
                f"{want_calls}")
        require(layers == want_layers,
                f"request {label} {n}: {layers} residual-layer launches, "
                f"expected {want_layers}")
        lat_total += lat
        audio_total += audio_s
    say(f"path {label}", t0, requests=len(requests),
        latency_s=f"{lat_total:.3f}", audio_s=f"{audio_total:.2f}",
        rtf=f"{lat_total / audio_total:.4f}",
        denoiser_calls_per_request=sum(want_calls))
    launches = {k: c.count for k, c in counters().items()}
    launches["diffnet_layer"] = dk.counter.count
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
    defaults = run_path(t0, torch, np, infer, "defaults",
                        requests[:1], wav_np,
                        dict(none, mel_spectrogram=1,
                             fused_mrf_blocks=stages))
    del infer

    infer = make_infer(recipe, phones, "cuda", SEED)
    say("model recipe", t0, vocoder_compute_dtype=recipe[
        "vocoder_compute_dtype"], mrf_routes=infer.vocoder.mrf_routes(
            recipe["max_frames"]))
    expect = dict(none, mel_spectrogram=1, fused_mrf_blocks_bf16=stages)
    launches = run_path(t0, torch, np, infer, "recipe", requests,
                        wav_np, expect)
    for label, fast in (("fast dpm10_f0fast5", dict(f0_speedup=5,
                                                    dpm_steps=10)),
                        ("fast fast_both", dict(f0_speedup=5,
                                                pndm_speedup=5))):
        saved = {k: infer.cfg[k] for k in fast}
        infer.cfg.update(fast)
        run_path(t0, torch, np, infer, label, requests, wav_np, expect)
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
    with torch.no_grad():  # inference, as infer_once runs it
        ret, t_model = timed(lambda: infer.model(**batch, noise=noise))
        _, t_voc = timed(lambda: infer.vocoder(ret["mel_out"],
                                               ret["f0_denorm"], noise))
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
    with torch.no_grad():
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


def cpu_small_step(np, cfg, spk_ids=None):
    """One train step of a tiny model on the CPU: seeded weights, a seeded
    batch (``spk_ids`` go into it, for ``use_spk_id``) and draws recorded
    from seeded CPU generators.  Returns (state, metrics, batch, phase,
    the weights before the step, the recorded draws)."""
    from stylesinger_torch.models.stylesinger import StyleSinger
    from stylesinger_torch.training import step as ts

    vocab = 20
    batch = collated(cfg, synthetic_items(np, 4, (16, 30), (3, 7), 16, vocab,
                                          SEED))
    if spk_ids is not None:
        batch["spk_id"] = np.asarray(spk_ids, np.int64)
    phase = ts.Phase(use_rq=True, forcing=False, use_diff=True)
    cpu = ts.init_state(StyleSinger(cfg, vocab), cfg)
    first = {k: v.clone() for k, v in cpu.model.state_dict().items()}
    recs = {s: _Recorder(SEED + i) for i, s in enumerate(ts.STREAMS)}
    m_cpu = ts.train_step(cpu, ts.batch_to_device(batch, "cpu"), phase, cfg,
                          noise=recs)
    return cpu, m_cpu, batch, phase, first, recs


def small_step_pair(torch, np, cfg, spk_ids=None, card_dtypes=None):
    """One train step of a tiny model on the CPU and on the card from the
    same weights and batch, the draws made on CPU generators and replayed
    on the card (:func:`cpu_small_step`).  ``card_dtypes`` (a dict)
    receives the output dtypes of the card model's compute layers.
    Returns (cpu state, card state, cpu metrics, card metrics, relative
    loss errors)."""
    import contextlib

    from stylesinger_torch.models import precision
    from stylesinger_torch.models.stylesinger import StyleSinger
    from stylesinger_torch.training import step as ts

    cpu, m_cpu, batch, phase, first, recs = cpu_small_step(np, cfg, spk_ids)
    model = StyleSinger(cfg, 20)
    model.load_state_dict(first)
    gpu = ts.TrainState(model.cuda(), ts.Optimizer(
        dict(model.named_parameters()), cfg))
    record = contextlib.nullcontext({}) if card_dtypes is None else \
        precision.compute_layer_dtypes(gpu.model)
    with record as seen:
        m_gpu = ts.train_step(gpu, ts.batch_to_device(batch, "cuda"), phase,
                              cfg, noise={s: _Replay(r.draws, "cuda")
                                          for s, r in recs.items()})
    torch.cuda.synchronize()
    if card_dtypes is not None:
        card_dtypes.update(seen)
    errs = {k: abs(float(m_gpu[k]) - float(v)) / max(1.0, abs(float(v)))
            for k, v in m_cpu.items()}
    return cpu, gpu, m_cpu, m_gpu, errs


def grad_err_over_tol(cpu, gpu):
    """The worst gradient leaf's error over its tolerance, 1e-3 *
    max|g_leaf| + 1e-6 * max|g| (leaves zero in exact arithmetic carry f32
    rounding), and its name; a gradient on the card alone fails."""
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
    return worst, worst_name


def phase_train_small(t0, torch, np):
    """One train step of the tiny model, the card against the CPU."""
    from stylesinger_torch.config import tiny_test_config

    cpu, gpu, m_cpu, m_gpu, errs = small_step_pair(torch, np,
                                                   tiny_test_config())
    worst, worst_name = grad_err_over_tol(cpu, gpu)
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


def phase_train_recipe(t0, torch, np, root: Path):
    """Trainer.fit at the recipe's full width: 12 steps, 6 in each phase of
    the curriculum, validation, a checkpoint, and an exact restore.  Each
    phase's first step pays for its first run; its 5 warm steps give the
    phase's median and spread, and the last phase's warm steps the
    steps/s.  The work dir ``<root>/train/recipe`` stays for the serving
    phases; returns the run: its config, final state, work dir and vocab
    size."""
    from stylesinger_torch.models.stylesinger import StyleSinger
    from stylesinger_torch.training import step as ts
    from stylesinger_torch.training import trainer as tr

    cfg, batch, vocab = recipe_training(np)
    n_steps = 2 * TRAIN_PHASE_STEPS
    work = root / "train" / "recipe"
    trainer, state, steps, first, peak, launches = timed_fit(
        torch, cfg, batch, vocab, work)
    b_dev = ts.batch_to_device(batch, "cuda")
    last = ts.phase_for_step(n_steps - 1, cfg)
    torch.cuda.synchronize()
    te = time.perf_counter()
    ev = ts.eval_step(state, b_dev, last, cfg)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - te
    again = tr.Trainer(StyleSinger(cfg, vocab), cfg, str(work))
    restored = again.init_state()
    saved = state.model.state_dict()
    same = all(torch.equal(v, saved[k]) for k, v in
               restored.model.state_dict().items())
    opt_a, opt_b = state.opt.state_dict(), restored.opt.state_dict()
    same_opt = opt_a["count"] == opt_b["count"] and all(
        torch.equal(opt_a[key][n], opt_b[key][n])
        for key in ("mu", "nu") for n in opt_a[key])
    ckpt_steps = trainer.ckpt.all_steps()
    n_params = sum(p.numel() for p in state.model.parameters())
    for i, (phase, sec, m) in enumerate(steps):
        say(f"train recipe step {i}", t0, flags="/".join(
            k for k, v in phase._asdict().items() if v) or "none",
            ms=f"{1e3 * sec:.1f}", total_loss=f"{float(m['total_loss']):.4f}",
            grad_norm=f"{float(m['grad_norm']):.4f}", losses=len(m) - 2)
    per_phase, last_warm = phase_times(np, steps)
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
        peak_mem_gib=f"{peak[0] / 2 ** 30:.2f}",
        peak_over_start_gib=f"{peak[1] / 2 ** 30:.3f}",
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
    return dict(cfg=cfg, state=state, work=work, vocab=vocab,
                per_phase=per_phase, peak=peak)


def phase_train_bf16(t0, torch, np, root: Path, f32_run):
    """``compute_dtype: bfloat16``: the ``train recipe`` run (same model,
    batch and scaled curriculum) with bf16 activations, its warm step
    times and peak memory beside the f32 run's; then one bf16 step of the
    tiny model on the card against the CPU's bf16 step."""
    from stylesinger_torch.config import tiny_test_config

    cfg, batch, vocab = recipe_training(np, compute_dtype="bfloat16")
    _, state, steps, first, peak, launches = timed_fit(
        torch, cfg, batch, vocab, root / "train" / "bf16")
    per_phase, last_warm = phase_times(np, steps)
    params = dict(state.model.named_parameters())
    moved = max(float((p.detach() - first[k]).abs().max())
                for k, p in params.items())
    say("train bf16", t0, steps=len(steps), **per_phase,
        **{f"f32_{k}": v for k, v in f32_run["per_phase"].items()},
        steps_per_s_last_phase_warm=(
            f"{1e3 * len(last_warm) / sum(last_warm):.3f}"),
        peak_mem_gib=f"{peak[0] / 2 ** 30:.2f}",
        peak_over_start_gib=f"{peak[1] / 2 ** 30:.3f}",
        f32_peak_over_start_gib=f"{f32_run['peak'][1] / 2 ** 30:.3f}",
        last_total_loss=f"{float(steps[-1][2]['total_loss']):.4f}",
        param_moved=f"{moved:.3e}", launches=launches,
        timer="host clock, cuda.synchronize")
    require(len(steps) == 2 * TRAIN_PHASE_STEPS,
            "train bf16: not all steps ran")
    require(all(np.isfinite(float(v)) for _, _, m in steps
                for v in m.values()), "train bf16: a non-finite loss")
    require(all(p.dtype == torch.float32 for p in params.values()),
            "train bf16: a parameter is not f32")
    require(moved > 0, "train bf16: the parameters did not move")
    require(not any(launches.values()),
            f"train bf16: a kernel launched {launches}")
    del state

    # the card's bf16 step against the CPU's: both round each op to bf16 at
    # the same sites, accumulating in other orders; the card ran in bf16:
    # its compute layers returned bf16 and its gradient is off the CPU's
    # f32 step's by more than a third of the 1.2 % that bf16 gives there
    seen = {}
    cpu, gpu, m_cpu, m_gpu, errs = small_step_pair(
        torch, np, tiny_test_config(compute_dtype="bfloat16"),
        card_dtypes=seen)
    cpu32 = cpu_small_step(np, tiny_test_config(compute_dtype="float32"))[0]
    names = [k for k, p in cpu.model.named_parameters()
             if p.grad is not None]

    def flat(state):
        params = dict(state.model.named_parameters())
        return torch.cat([params[k].grad.reshape(-1).cpu() for k in names])

    g_cpu, g_gpu, g32 = flat(cpu), flat(gpu), flat(cpu32)
    cos = float(torch.nn.functional.cosine_similarity(g_cpu, g_gpu, dim=0))
    rel = float((g_cpu - g_gpu).norm() / g_cpu.norm())
    spread = float((g_gpu - g32).norm() / g32.norm())
    sites = [s for s in BF16_SITES if any(n.endswith(s) for n in seen)]
    not_bf16 = sorted(n for n, d in seen.items() if d != {torch.bfloat16})
    say("train bf16 small step", t0, worst_loss_err=f"{max(errs.values()):.2e}",
        tol="1e-4", grad_cosine=f"{cos:.7f}", grad_rel_l2=f"{rel:.3e}",
        grad_tol="cos>0.9999,rel<1e-2", bf16_layers=len(seen),
        not_bf16=len(not_bf16), f32_spread=f"{spread:.3e}",
        spread_min=f"{MIN_BF16_SPREAD:g}")
    require(all(np.isfinite(float(v)) for v in m_gpu.values()),
            "train bf16 small step: a non-finite loss")
    require(all(e <= 1e-4 for e in errs.values()) and cos > 0.9999 and
            rel < 1e-2, f"train bf16 small step: card and CPU differ "
            f"({errs}, cosine {cos}, rel {rel})")
    require(sites == list(BF16_SITES) and not not_bf16,
            f"train bf16 small step: compute layers not in bf16 on the card "
            f"(sites seen {sites}, not bf16 {not_bf16[:5]})")
    require(spread > MIN_BF16_SPREAD,
            f"train bf16 small step: the card's gradient is {spread:.2e} "
            "from the f32 step's: not a bf16 step")


def phase_settings(t0, torch, np):
    """The settings ported in this slice, one small train step each on the
    card against the CPU (the ``small train step`` tolerances)."""
    from stylesinger_torch.config import tiny_test_config

    cases = (("prodiff", dict(decoder="prodiff"), None),
             ("prodiff_fft", dict(decoder="prodiff",
                                  diff_decoder_type="fft"), None),
             ("use_spk_id", dict(use_spk_id=True), [3, 7, 1, 150]),
             ("rel_pos", dict(rel_pos=True), None),
             ("pitch_type_ph", dict(pitch_type="ph"), None))
    for label, overrides, spk in cases:
        for ctr in counters().values():
            ctr.reset()
        cpu, gpu, m_cpu, m_gpu, errs = small_step_pair(
            torch, np, tiny_test_config(**overrides), spk)
        worst, worst_name = grad_err_over_tol(cpu, gpu)
        launches = {k: c.count for k, c in counters().items()}
        say(f"settings {label}", t0, losses=",".join(sorted(
            k for k in m_gpu if k not in ("total_loss", "grad_norm"))),
            total_loss=f"{float(m_gpu['total_loss']):.4f}",
            worst_loss_err=f"{max(errs.values()):.2e}", tol="1e-3",
            worst_grad_err_over_tol=f"{worst:.3f}", at=worst_name,
            launches=launches)
        require(all(np.isfinite(float(v)) for v in m_gpu.values()),
                f"settings {label}: a non-finite loss")
        require(all(e <= 1e-3 for e in errs.values()) and worst <= 1.0,
                f"settings {label}: card and CPU differ ({errs}, "
                f"{worst_name} {worst:.2f} x its tolerance)")
        require(not any(launches.values()),
                f"settings {label}: a kernel launched {launches}")


_DP_RANK = r"""
import os, sys
import numpy as np
import torch

from stylesinger_torch.config import tiny_test_config
from stylesinger_torch.models.diffusion import Noise
from stylesinger_torch.models.stylesinger import StyleSinger
from stylesinger_torch.parallel import mesh
from stylesinger_torch.training import step as ts

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
d, seed = sys.argv[1], int(sys.argv[2])
assert mesh.init_distributed("cuda", backend="gloo")
rank = mesh.rank()
cfg = tiny_test_config()
model = StyleSinger(cfg, 20)
model.load_state_dict(torch.load(os.path.join(d, "weights.pt")))
state = ts.TrainState(model.cuda(), ts.Optimizer(
    dict(model.named_parameters()), cfg))
batch = dict(np.load(os.path.join(d, f"batch{rank}.npz")))
m = ts.train_step(state, ts.batch_to_device(batch, "cuda"),
                  ts.Phase(True, False, True), cfg,
                  noise={s: Noise(seed + i, "cuda")
                         for i, s in enumerate(ts.STREAMS)})
out = {f"metric/{k}": v.cpu().numpy() for k, v in m.items()}
out.update({f"state/{k}": v.cpu().numpy()
            for k, v in model.state_dict().items()})
out.update({f"grad/{k}": p.grad.cpu().numpy()
            for k, p in model.named_parameters()})
np.savez(os.path.join(d, f"out{rank}.npz"), **out)
print(f"RANK_OK {rank}", flush=True)
"""


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _dp_compare(torch, np, ref_state, ref_m, rank_out, label):
    """A rank's step against the one-process step on the global batch:
    losses within 1e-4 (relative, atol 1e-4), gradients within 1e-3 *
    max|g_leaf| + 1e-6 * max|g|, RQ buffers within 1e-5.  Returns the
    worst loss error and gradient error over its tolerance."""
    loss_err = max(abs(float(rank_out[f"metric/{k}"]) - float(v)) /
                   max(1.0, abs(float(v))) for k, v in ref_m.items())
    grads = {k: torch.zeros(p.shape) if p.grad is None else p.grad.cpu()
             for k, p in ref_state.model.named_parameters()}
    g_max = max(float(g.abs().max()) for g in grads.values())
    worst = max(float((torch.as_tensor(rank_out[f"grad/{k}"]) - g).abs()
                      .max()) / (1e-3 * float(g.abs().max()) + 1e-6 * g_max)
                for k, g in grads.items())
    sd = ref_state.model.state_dict()
    buf = max(float((torch.as_tensor(rank_out[f"state/{k}"]) - v.cpu())
                    .abs().max()) for k, v in sd.items()
              if ".codebook_" in k)
    require(loss_err <= 1e-4 and worst <= 1.0 and buf <= 1e-5,
            f"{label}: differs from the one-process step (losses "
            f"{loss_err:.2e}, gradients {worst:.2f} x tol, RQ {buf:.2e})")
    return loss_err, worst, buf


def phase_data_parallel(t0, torch, np, root: Path):
    """Data parallel training: one step through ``init_distributed`` at
    world size 1 on NCCL against the plain step; then two ranks on this
    one card, two processes over gloo (NCCL refuses two ranks on one
    device) holding batches in different buckets, against one process's
    step on the concatenated global batch.  Draws from seeded generators
    on the card (each rank draws the global tensors and keeps its rows)."""
    import torch.distributed as dist

    from stylesinger_torch.config import tiny_test_config
    from stylesinger_torch.models.diffusion import Noise
    from stylesinger_torch.models.stylesinger import StyleSinger
    from stylesinger_torch.parallel import mesh
    from stylesinger_torch.training import step as ts

    cfg = tiny_test_config()
    phase = ts.Phase(use_rq=True, forcing=False, use_diff=True)
    init = ts.init_state(StyleSinger(cfg, 20), cfg).model.state_dict()

    def step(batch, seed=SEED):
        model = StyleSinger(cfg, 20)
        model.load_state_dict(init)
        state = ts.TrainState(model.cuda(), ts.Optimizer(
            dict(model.named_parameters()), cfg))
        m = ts.train_step(state, ts.batch_to_device(batch, "cuda"), phase,
                          cfg, noise={s: Noise(seed + i, "cuda")
                                      for i, s in enumerate(ts.STREAMS)})
        torch.cuda.synchronize()
        return state, m

    for ctr in counters().values():
        ctr.reset()
    batch = collated(cfg, synthetic_items(np, 4, (16, 30), (3, 7), 16, 20,
                                          SEED))
    plain_state, plain_m = step(batch)
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()))
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        require(mesh.init_distributed("cuda") and
                dist.get_backend() == "nccl",
                "data parallel: no NCCL group at world size 1")
        dp_state, dp_m = step(batch)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out = {f"metric/{k}": v.cpu().numpy() for k, v in dp_m.items()}
    out.update({f"state/{k}": v.cpu().numpy()
                for k, v in dp_state.model.state_dict().items()})
    out.update({f"grad/{k}": p.grad.cpu().numpy()
                for k, p in dp_state.model.named_parameters()})
    one = _dp_compare(torch, np, plain_state, plain_m, out,
                      "data parallel world 1")
    say("data parallel world 1", t0, backend="nccl",
        loss_err=f"{one[0]:.2e}", grad_err_over_tol=f"{one[1]:.3f}",
        rq_err=f"{one[2]:.2e}", tol="1e-4/1e-3*max|g|/1e-5")

    # two ranks, different buckets and rows: 2 items (32 frames / 8
    # phones) and 3 items in a 4-row batch (64 / 16)
    locals_ = [collated(cfg, synthetic_items(np, 2, (16, 30), (3, 7), 16,
                                             20, SEED + 1)),
               collated(cfg, synthetic_items(np, 3, (40, 60), (10, 15), 16,
                                             20, SEED + 2))]
    t_mel = max(b["mels"].shape[1] for b in locals_)
    t_txt = max(b["txt_tokens"].shape[1] for b in locals_)

    def pad(b):
        out = {}
        for k, v in b.items():
            if k == "nsamples":
                continue
            n = t_mel if k in mesh.FRAME_FIELDS else \
                t_txt if k in mesh.TOKEN_FIELDS else None
            if n is not None:
                v = np.pad(v, [(0, 0), (0, n - v.shape[1])] +
                           [(0, 0)] * (v.ndim - 2))
            out[k] = v
        return out

    padded = [pad(b) for b in locals_]
    global_batch = {k: np.concatenate([p[k] for p in padded])
                    for k in padded[0]}
    ref_state, ref_m = step(global_batch, SEED + 10)
    d = root / "data_parallel"
    d.mkdir()
    torch.save(init, d / "weights.pt")
    for r, b in enumerate(locals_):
        np.savez(d / f"batch{r}.npz", **{k: v for k, v in b.items()
                                          if k != "nsamples"})
    env = dict(os.environ, PYTHONPATH=str(REPO), WORLD_SIZE="2",
               MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               LOCAL_RANK="0")
    tp = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DP_RANK, str(d), str(SEED + 10)],
        cwd=str(REPO), env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    except subprocess.TimeoutExpired:
        outs.append("timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        require(p.returncode == 0 and r < len(outs) and
                f"RANK_OK {r}" in outs[r],
                f"data parallel: rank {r} failed: "
                f"{(outs[r] if r < len(outs) else '')[-2000:]}")
    ranks = [dict(np.load(d / f"out{r}.npz")) for r in range(2)]
    equal = all(np.array_equal(ranks[0][k], ranks[1][k]) for k in ranks[0])
    worst = [_dp_compare(torch, np, ref_state, ref_m, ranks[r],
                         f"data parallel rank {r}") for r in range(2)]
    launches = {k: c.count for k, c in counters().items()}
    say("data parallel 2 ranks", t0, backend="gloo (CUDA tensors)",
        buckets=[tuple(b["mels"].shape) for b in locals_],
        global_batch=tuple(global_batch["mels"].shape),
        loss_err=f"{max(w[0] for w in worst):.2e}",
        grad_err_over_tol=f"{max(w[1] for w in worst):.3f}",
        rq_err=f"{max(w[2] for w in worst):.2e}",
        ranks_equal=equal, seconds=f"{time.perf_counter() - tp:.2f}",
        launches=launches)
    require(equal, "data parallel: the two ranks' states differ")
    require(not any(launches.values()),
            f"data parallel: a kernel launched {launches}")


_MP_RANK = r"""
import os, sys
import numpy as np
import torch

from stylesinger_torch.config import tiny_test_config
from stylesinger_torch.models.diffusion import Noise
from stylesinger_torch.models.stylesinger import StyleSinger
from stylesinger_torch.parallel import mesh
from stylesinger_torch.training import step as ts

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
d, seed = sys.argv[1], int(sys.argv[2])
assert mesh.init_distributed("cuda", backend="gloo")
grid = mesh.make_mesh(n_data=1, n_model=2)
rank = mesh.rank()
cfg = tiny_test_config()
model = StyleSinger(cfg, 20)
model.load_state_dict(torch.load(os.path.join(d, "weights.pt")))
mesh.shard_params(model.cuda(), grid)
state = ts.TrainState(model, ts.Optimizer(
    dict(model.named_parameters()), cfg))
batch = dict(np.load(os.path.join(d, "batch.npz")))
m = ts.train_step(state, ts.batch_to_device(batch, "cuda"),
                  ts.Phase(True, False, True), cfg,
                  noise={s: Noise(seed + i, "cuda")
                         for i, s in enumerate(ts.STREAMS)})
split = mesh.split_dims(model)
out = {f"metric/{k}": v.cpu().numpy() for k, v in m.items()}
out.update({f"state/{k}": v.cpu().numpy() for k, v in
            mesh.full_tensors(model, model.state_dict()).items()})
out.update({f"grad/{k}": v.cpu().numpy() for k, v in mesh.full_tensors(
    model, {k: p.grad for k, p in model.named_parameters()}).items()})
out.update({f"replicated/{k}": v.cpu().numpy() for k, v in
            model.state_dict().items() if k not in split})
out["split"] = np.array(len(split))
np.savez(os.path.join(d, f"out{rank}.npz"), **out)
print(f"RANK_OK {rank}", flush=True)
"""


def phase_model_parallel(t0, torch, np, root: Path):
    """The ``model`` mesh axis: two ranks on this one card, two processes
    over gloo (NCCL refuses two ranks on one device), in a 1 x 2 grid
    (``make_mesh(1, 2)``), each ``TransformerFFN`` split over them
    (``shard_params``), one step of the tiny model on the same 4 rows,
    against one process's step (draws from seeded generators on the card,
    TF32 off), at the ``data parallel`` tolerances on the gathered
    gradients; the replicated leaves equal on both ranks, bit for bit."""
    from stylesinger_torch.config import tiny_test_config
    from stylesinger_torch.models.diffusion import Noise
    from stylesinger_torch.models.stylesinger import StyleSinger
    from stylesinger_torch.training import step as ts

    cfg = tiny_test_config()
    init = ts.init_state(StyleSinger(cfg, 20), cfg).model.state_dict()
    batch = collated(cfg, synthetic_items(np, 4, (16, 30), (3, 7), 16, 20,
                                          SEED + 3))
    batch = {k: v for k, v in batch.items() if k != "nsamples"}
    for ctr in counters().values():
        ctr.reset()
    model = StyleSinger(cfg, 20)
    model.load_state_dict(init)
    ref_state = ts.TrainState(model.cuda(), ts.Optimizer(
        dict(model.named_parameters()), cfg))
    ref_m = ts.train_step(ref_state, ts.batch_to_device(batch, "cuda"),
                          ts.Phase(use_rq=True, forcing=False,
                                   use_diff=True), cfg,
                          noise={s: Noise(SEED + 20 + i, "cuda")
                                 for i, s in enumerate(ts.STREAMS)})
    torch.cuda.synchronize()
    d = root / "model_parallel"
    d.mkdir()
    torch.save(init, d / "weights.pt")
    np.savez(d / "batch.npz", **batch)
    env = dict(os.environ, PYTHONPATH=str(REPO), WORLD_SIZE="2",
               MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               LOCAL_RANK="0")
    tp = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _MP_RANK, str(d), str(SEED + 20)],
        cwd=str(REPO), env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    except subprocess.TimeoutExpired:
        outs.append("timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        require(p.returncode == 0 and r < len(outs) and
                f"RANK_OK {r}" in outs[r],
                f"model parallel: rank {r} failed: "
                f"{(outs[r] if r < len(outs) else '')[-2000:]}")
    ranks = [dict(np.load(d / f"out{r}.npz")) for r in range(2)]
    differ = [k for k in ranks[0] if k.startswith(("replicated/", "state/"))
              and not np.array_equal(ranks[0][k], ranks[1][k])]
    equal = not differ
    worst = [_dp_compare(torch, np, ref_state, ref_m, ranks[r],
                         f"model parallel rank {r}") for r in range(2)]
    launches = {k: c.count for k, c in counters().items()}
    say("model parallel 1x2", t0, backend="gloo (CUDA tensors)",
        split_leaves=int(ranks[0]["split"]),
        rows=tuple(batch["mels"].shape),
        loss_err=f"{max(w[0] for w in worst):.2e}",
        grad_err_over_tol=f"{max(w[1] for w in worst):.3f}",
        rq_err=f"{max(w[2] for w in worst):.2e}",
        replicated_equal=equal, seconds=f"{time.perf_counter() - tp:.2f}",
        launches=launches)
    require(int(ranks[0]["split"]) > 0, "model parallel: nothing split")
    require(equal, f"model parallel: the ranks' replicated leaves differ: "
            f"{differ[:8]}")
    require(not any(launches.values()),
            f"model parallel: a kernel launched {launches}")


SERVE_TOL = 1e-4  # the artifact against the live function, TF32 off


def serving_bucket(np, torch, infer, wav_np):
    """The EXAMPLE phrase with the 4 s clip, padded as ``infer_batch`` pads
    to the config's token and frame buckets."""
    from stylesinger_torch.inference import _fit_bucket

    cfg = infer.cfg
    b = infer.preprocess_input(dict(EXAMPLE, ref_audio=wav_np))
    t_txt = _fit_bucket(b["txt_tokens"].shape[1], cfg["token_buckets"])
    t_ref = _fit_bucket(b["ref_mels"].shape[1], cfg["frame_buckets"])
    width = dict(txt_tokens=t_txt, note=t_txt, note_dur=t_txt,
                 note_type=t_txt, ref_mels=t_ref, ref_f0=t_ref)
    out = {}
    for k, v in b.items():
        if k in width:
            pad = [0, 0] * (v.ndim - 2) + [0, width[k] - v.shape[1]]
            v = torch.nn.functional.pad(v, pad)
        out[k] = v
    return out, t_txt, t_ref


def phase_serving_export(t0, torch, np, cfg, label, wav_np, root: Path):
    """``serving/export.py`` on the card: the synthesizer of ``cfg`` (random
    weights from SEED) exported with ``torch.export`` at one bucket (batch
    1, the EXAMPLE phrase's token bucket, the 4 s clip's frame bucket,
    ``max_frames``), saved, loaded and called on ``noise_from_seed(SEED)``
    with TF32 off: its wav, mel and F0 within SERVE_TOL of the live
    ``make_synthesize_fn`` on the same draws, ``mel2ph`` equal, and the
    mel within SERVE_TOL of ``forward_model`` with ``Noise(SEED)`` (the
    predicted frames); the call's MRF launches, counted by the operator's
    CUDA implementation, set to 0 just before it and read just after.
    Prints the export, save and load seconds, the artifact's MB and the
    first and warm call ms."""
    from stylesinger_torch.models.diffusion import Noise
    from stylesinger_torch.serving import (
        export_synthesizer, load_synthesizer, make_synthesize_fn,
        noise_from_seed, save_synthesizer, synthesize,
    )

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        phones = sorted(set(EXAMPLE["ph"].split()))
        infer = make_infer(cfg, phones, "cuda", SEED)
        vocab = len(infer.ph_encoder)
        params = {k: v.detach() for k, v in
                  infer.model.state_dict().items()}
        voc = {k: v.detach() for k, v in infer.vocoder.state_dict().items()}
        batch, t_txt, t_ref = serving_bucket(np, torch, infer, wav_np)
        frames = cfg["max_frames"]
        tx = time.perf_counter()
        ep = export_synthesizer(cfg, vocab, batch=1, t_txt=t_txt,
                                t_ref=t_ref, max_frames=frames,
                                device="cuda", variables=params,
                                voc_variables=voc)
        export_s = time.perf_counter() - tx
        nodes = sum(1 for n in ep.graph.nodes if n.op == "call_function")
        ops = sum(1 for n in ep.graph.nodes if n.op == "call_function" and
                  n.target == torch.ops.stylesinger.fused_mrf_blocks.default)
        path = root / f"synth_{label.replace(' ', '_')}.pt2"
        tx = time.perf_counter()
        save_synthesizer(ep, str(path))
        save_s = time.perf_counter() - tx
        del ep
        tx = time.perf_counter()
        loaded = load_synthesizer(str(path))
        load_s = time.perf_counter() - tx
        mb = path.stat().st_size / 2 ** 20
        say(f"serving export {label} artifact", t0,
            bucket=f"1x{t_txt}x{t_ref}->{frames}", graph_ops=nodes,
            mrf_op_nodes=ops, export_s=f"{export_s:.1f}",
            save_s=f"{save_s:.1f}", load_s=f"{load_s:.1f}",
            artifact_mb=f"{mb:.1f}")
        noise = noise_from_seed(loaded, SEED)
        stages = len(mrf_stages(cfg, np)) * sum(
            len(dl) for dl in cfg["resblock_dilation_sizes"])
        bf16 = cfg["vocoder_compute_dtype"] == "bfloat16"
        key = "fused_mrf_blocks_bf16" if bf16 else "fused_mrf_blocks"
        times, launches = [], None
        with torch.no_grad():
            for i in range(4):
                for ctr in counters().values():
                    ctr.reset()
                torch.cuda.synchronize()
                tx = time.perf_counter()
                # (the batch's keys in preprocess_input's order, not the
                # export's: synthesize puts them in the artifact's)
                out = synthesize(loaded, params, voc, batch, noise)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - tx))
                if i == 0:
                    launches = {k: c.count for k, c in counters().items()}
            live = make_synthesize_fn(cfg, vocab, frames)(params, voc, batch,
                                                          noise)
            ref = infer.forward_model(batch, max_frames=frames,
                                      noise=Noise(SEED, "cuda"))
        errs = [float((a.float() - b.float()).abs().max())
                for a, b in zip(out[:3], live[:3])]
        n = ref["mel"].shape[0]
        fm_err = float(np.abs(out[1][0, :n].cpu().numpy() -
                              ref["mel"]).max()) if n else 0.0
        same_mel2ph = bool(torch.equal(out[3], live[3]))
        finite = all(bool(torch.isfinite(a).all()) for a in out[:3])
        say(f"serving export {label}", t0, first_call_ms=f"{times[0]:.1f}",
            warm_call_ms=f"{sorted(times[1:])[1]:.1f}",
            warm_calls_ms=[round(t, 1) for t in times[1:]],
            draws=len(noise), wav_err=f"{errs[0]:.2e}",
            mel_err=f"{errs[1]:.2e}", f0_err=f"{errs[2]:.2e}",
            forward_model_mel_err=f"{fm_err:.2e}", predicted_frames=n,
            mel2ph_equal=same_mel2ph, finite=finite, tol=SERVE_TOL,
            launches=launches)
        require(finite and same_mel2ph and max(errs + [fm_err]) <= SERVE_TOL,
                f"serving export {label}: the artifact differs from the "
                f"live function (wav/mel/f0 {errs}, forward_model {fm_err})")
        want = {k: 0 for k in counters()}
        want[key] = stages
        require(launches == want, f"serving export {label}: launches "
                f"{launches}, expected {want}")
        path.unlink()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return dict(export_s=export_s, save_s=save_s, load_s=load_s,
                artifact_mb=mb, graph_ops=nodes, first_ms=times[0],
                warm_ms=sorted(times[1:])[1])


def phase_recipe_file(t0, torch, np, root: Path, binary: Path):
    """``run.py train --config egs/stylesinger.yaml`` (the port's YAML
    reader; no PyYAML here) for 2 steps of a small curriculum on the
    ``data prep`` shards, in its own process; the ``config.yaml`` it
    writes read back equal to the config it trained with."""
    from stylesinger_torch.config import load_config, load_work_dir_config

    hp = (f"binary_data_dir={binary},max_updates=2,forcing=1,rq_start=0,"
          "diff_start=0,tb_log_interval=1,val_check_interval=2,"
          "num_ckpt_keep=1")
    work = root / "recipe_file"
    tc = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "stylesinger_torch.run", "train", "--config",
         "egs/stylesinger.yaml", "--hparams", hp, "--exp_name", "yaml",
         "--work_dir_root", str(work), "--device", "cuda"], cwd=str(REPO),
        capture_output=True,
        text=True, timeout=600)
    seconds = time.perf_counter() - tc
    require(out.returncode == 0, f"recipe file: run.py train failed: "
            f"{out.stderr[-2000:]}")
    run_dir = work / "yaml"
    with open(run_dir / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    train_rows = [m for m in rows if m["prefix"] == "train"]
    saved = load_work_dir_config(str(run_dir))
    expected = load_config(str(REPO / "egs" / "stylesinger.yaml"), hp,
                           work_dir=str(run_dir))
    equal = json.loads(json.dumps(saved)) == json.loads(json.dumps(expected))
    say("recipe file", t0, steps=len(train_rows),
        step_ms=",".join(f"{1e3 / m['steps_per_sec']:.1f}"
                         for m in train_rows),
        total_loss=",".join(f"{m['total_loss']:.4f}" for m in train_rows),
        config_keys=len(saved), read_back_equal=equal,
        hidden=saved["hidden_size"], mesh_shape=saved["mesh_shape"],
        seconds=f"{seconds:.2f}")
    require(len(train_rows) == 2 and all(
        math.isfinite(v) for m in rows for k, v in m.items()
        if k not in ("step", "prefix")), "recipe file: not 2 finite steps")
    require(equal, "recipe file: config.yaml does not read back equal")


def recipe_training(np, **overrides):
    """The ``train recipe`` run's config (the recipe, the curriculum
    scaled to ``TRAIN_PHASE_STEPS``, and ``overrides``), its 8 x 1024-frame
    batch and vocabulary size."""
    from stylesinger_torch.config import load_config

    cfg = load_config(recipe="stylesinger", **{**dict(
        forcing=TRAIN_PHASE_STEPS, rq_start=TRAIN_PHASE_STEPS - 1,
        diff_start=TRAIN_PHASE_STEPS - 1, tb_log_interval=1,
        val_check_interval=2 * TRAIN_PHASE_STEPS, num_ckpt_keep=1),
        **overrides})
    vocab = 64
    batch = collated(cfg, synthetic_items(
        np, 8, (600, 1001), (60, 121), cfg["audio_num_mel_bins"], vocab,
        SEED))
    require(batch["mels"].shape == (8, 1024, 80) and
            batch["txt_tokens"].shape == (8, 128),
            f"train recipe: buckets {batch['mels'].shape}")
    require(8 * batch["mels"].shape[1] <= cfg["max_tokens"],
            "train recipe: the batch exceeds max_tokens")
    return cfg, batch, vocab


def timed_fit(torch, cfg, batch, vocab, work):
    """``Trainer.fit`` of the recipe's model on ``[batch]`` (validation on
    it too) for the two curriculum phases, each step timed on the host
    clock between synchronizes, the launch counts set to 0 before and read
    after.  Returns (trainer, state, steps as (phase, s, metrics), the
    weights before the first step, peak bytes, launches)."""
    from stylesinger_torch.models.stylesinger import StyleSinger
    from stylesinger_torch.training import trainer as tr

    steps, first = [], {}
    train_step = tr.train_step

    def timed_step(state, b, phase, c, **kw):
        if not first:
            first.update({k: v.detach().clone() for k, v in
                          state.model.state_dict().items()})
        torch.cuda.synchronize()
        tb = time.perf_counter()
        m = train_step(state, b, phase, c, **kw)
        torch.cuda.synchronize()
        steps.append((phase, time.perf_counter() - tb, m))
        return m

    for ctr in counters().values():
        ctr.reset()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    tr.train_step = timed_step
    try:
        trainer = tr.Trainer(StyleSinger(cfg, vocab), cfg, str(work))
        state = trainer.fit([batch], lambda: [batch],
                            max_updates=2 * TRAIN_PHASE_STEPS)
    finally:
        tr.train_step = train_step
    peak = torch.cuda.max_memory_allocated()
    launches = {k: c.count for k, c in counters().items()}
    return trainer, state, steps, first, (peak, peak - start), launches


def phase_times(np, steps):
    """Per curriculum phase: the first step's ms, the warm steps' median
    and min/max; and the last phase's warm step times."""
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
    return per_phase, by_phase[steps[-1][0]][1:]


def profile_busy(torch, fn, steps: int = 3):
    """``steps`` calls of ``fn`` under ``torch.profiler``: (wall ms per
    call on the host clock between synchronizes, the CUDA kernels' summed
    durations per call in ms, kernels per call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        tb = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - tb) / steps
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kernels) / steps / 1e3
    return wall, busy, len(kernels) / steps


def synced_ms(torch, fn) -> float:
    torch.cuda.synchronize()
    tb = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - tb)


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(1.0, abs(float(b)))


@contextlib.contextmanager
def deterministic(torch):
    """PyTorch's deterministic algorithms (a warning where an op has none,
    one per call site); yields the list that collects those warnings."""
    import warnings

    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("default")
            yield caught
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])


def _nondeterministic_ops(caught) -> list:
    """The op named at the head of each deterministic-mode warning."""
    return sorted({str(w.message).split(" ")[0][:60] for w in caught
                   if "deterministic" in str(w.message)})


def leaf_rel(a, b) -> float:
    """max |a - b| over max |b| (1e-30 at least)."""
    return float((a.float() - b.float()).abs().max()) / max(
        float(b.float().abs().max()), 1e-30)


def dispatch_fit(torch, np, dtype, n_steps, **overrides):
    """``Trainer.fit`` of the ``train recipe`` run (its batch, curriculum
    and ``overrides``) at ``steps_per_dispatch=6`` for ``n_steps``; the
    trainer's scan is wrapped to keep each window's metrics and host time.
    Returns the config, batch, state, scan (``scan.graphs``), windows as
    (phase, ms, metrics on the host), the stacked epoch, and the peak
    memory and the memory at the start in bytes."""
    from types import SimpleNamespace

    from stylesinger_torch.models.stylesinger import StyleSinger
    from stylesinger_torch.training import trainer as tr

    cfg, batch, vocab = recipe_training(
        np, compute_dtype=dtype, steps_per_dispatch=DISPATCH_STEPS,
        tb_log_interval=DISPATCH_STEPS, prefetch_batches=0, **overrides)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory(prefix=".dispatch_",
                                     dir=str(REPO)) as work:
        trainer = tr.Trainer(StyleSinger(cfg, vocab), cfg, work)
        scan, windows, seen = trainer.scan, [], {}

        def recorded(state, stacked, order, phase):
            tb = time.perf_counter()
            m = scan(state, stacked, order, phase)
            torch.cuda.synchronize()
            windows.append((phase, 1e3 * (time.perf_counter() - tb),
                            {k: v.cpu() for k, v in m.items()}))
            seen["stacked"] = stacked
            return m

        trainer.scan = recorded
        state = trainer.fit([batch], max_updates=n_steps)
    torch.cuda.synchronize()
    return SimpleNamespace(
        cfg=cfg, batch=batch, vocab=vocab, state=state, scan=scan,
        windows=windows, stacked=seen["stacked"],
        peak=torch.cuda.max_memory_allocated(), start=start)


def phase_train_dispatch(t0, torch, np, smi) -> None:
    """``steps_per_dispatch`` at the recipe's full width, f32 then bf16,
    under PyTorch's deterministic algorithms: ``Trainer.fit`` on the
    ``train recipe`` batch and curriculum for 12 steps in two windows of
    6 (one per curriculum phase; in each, the first step is eager and the
    capture follows it, the other five are replays of the phase's CUDA
    graph), against 12 eager ``train_step`` calls from the same seeded
    weights on the same batch, twice.  The learning rate warms up over 6
    steps (``DISPATCH_LR``), so each step has its own lr and bias
    corrections.  Every loss and the grad norm of each step, each
    parameter, RQ codebook buffer and Adam moment after the run, graphed
    against eager, within ``DISPATCH_REL_TOL``; the two eager runs'
    spread is printed beside it.  No kernel launches on this path.
    Everything is released at the end: :func:`phase_dispatch_timing`
    times the graphs on states of its own."""
    from stylesinger_torch.models.stylesinger import StyleSinger
    from stylesinger_torch.training import step as ts

    n_steps = 2 * TRAIN_PHASE_STEPS
    for dtype in ("float32", "bfloat16"):
        for ctr in counters().values():
            ctr.reset()
        with deterministic(torch) as caught:
            run = dispatch_fit(torch, np, dtype, n_steps, **DISPATCH_LR)
            launches = {k: c.count for k, c in counters().items()}
            cfg, graphed = run.cfg, run.state
            b_dev = ts.batch_to_device(run.batch, "cuda")
            eagers, e_metrics = [], []
            for _ in range(2):
                eager = ts.init_state(StyleSinger(cfg, run.vocab).cuda(),
                                      cfg)
                ms = []
                for i in range(n_steps):
                    m = ts.train_step(eager, b_dev,
                                      ts.phase_for_step(i, cfg), cfg)
                    ms.append({k: v.cpu() for k, v in m.items()})
                eagers.append(eager)
                e_metrics.append(ms)
            torch.cuda.synchronize()
        eager, again = eagers
        g_metrics = [{k: v[j] for k, v in m.items()}
                     for _, _, m in run.windows
                     for j in range(len(next(iter(m.values()))))]

        def metric_err(a, b, lo, hi):
            return max(_rel(x[k], y[k]) for x, y in zip(a[lo:hi], b[lo:hi])
                       for k in y)

        def state_err(a, b, codebook):
            bp = b.model.state_dict()
            return max(leaf_rel(v, bp[k])
                       for k, v in a.model.state_dict().items()
                       if (".codebook_" in k) == codebook)

        def moment_err(a, b):
            return max(leaf_rel(x, y) for xs, ys in (
                (a.opt.mu, b.opt.mu), (a.opt.nu, b.opt.nu))
                for x, y in zip(xs, ys))

        w = DISPATCH_STEPS
        errs = {
            "first_window_rel_err": (
                metric_err(g_metrics, e_metrics[0], 0, w),
                metric_err(e_metrics[1], e_metrics[0], 0, w)),
            "second_window_rel_err": (
                metric_err(g_metrics, e_metrics[0], w, n_steps),
                metric_err(e_metrics[1], e_metrics[0], w, n_steps)),
            "param_rel_err_after_12": (state_err(graphed, eager, False),
                                       state_err(again, eager, False)),
            "codebook_rel_err_after_12": (state_err(graphed, eager, True),
                                          state_err(again, eager, True)),
            "adam_moment_rel_err_after_12": (moment_err(graphed, eager),
                                             moment_err(again, eager)),
        }
        same_keys = len(g_metrics) == n_steps and all(
            set(g) == set(e) for g, e in zip(g_metrics, e_metrics[0]))
        finite = all(np.isfinite(float(v)) for m in g_metrics
                     for v in m.values())
        counts = (graphed.step, graphed.opt.count, eager.step,
                  eager.opt.count)
        lrs = [graphed.opt.schedule(i) for i in range(n_steps)]
        graphs = run.scan.graphs
        say("train dispatch", t0, gpu=repr(smi), compute_dtype=dtype,
            steps_per_dispatch=DISPATCH_STEPS,
            windows=[len(next(iter(m.values()))) for _, _, m in run.windows],
            captured=len(graphs.capture_seconds),
            lr_first_last=f"{lrs[0]:.3e}/{lrs[-1]:.3e}",
            **{k: f"{g:.2e}" for k, (g, _) in errs.items()},
            **{k.replace("rel_err", "eager_twice_rel_err"): f"{e:.2e}"
               for k, (_, e) in errs.items()},
            tol=DISPATCH_REL_TOL, steps_and_counts=counts,
            nondeterministic_ops=_nondeterministic_ops(caught),
            launches=launches, timer="deterministic algorithms")
        require(len(run.windows) == 2 and all(
            len(next(iter(m.values()))) == DISPATCH_STEPS
            for _, _, m in run.windows) and len(graphs.capture_seconds) == 2,
            f"train dispatch {dtype}: not two windows of {DISPATCH_STEPS} "
            "steps, each phase captured once")
        require(counts == (n_steps,) * 4,
                f"train dispatch {dtype}: steps and optimizer counts {counts}")
        require(same_keys and finite,
                f"train dispatch {dtype}: metrics differ in keys or are "
                "not finite")
        bad = {k: g for k, (g, _) in errs.items() if g > DISPATCH_REL_TOL}
        require(not bad, f"train dispatch {dtype}: graphed against eager "
                f"beyond {DISPATCH_REL_TOL} (relative): {bad}")
        require(all(v == 0 for v in launches.values()),
                f"train dispatch {dtype}: a kernel launched {launches}")
        del run, graphed, graphs, eager, again, eagers, b_dev
        torch.cuda.empty_cache()


def vocoder_dispatch_setup(np, torch):
    from stylesinger_torch.config import load_config

    cfg = load_config()
    items = harmonic_corpus(np, torch, cfg, 8, (128, 321), SEED)
    return cfg, items, 16, 64  # batch, crop frames


def recorded_vocoder_fit(torch, t0, cfg, items, n_iter, spd, batch, crop,
                         label):
    """``fit_vocoder(spd)`` for ``n_iter`` iterations with a scan of ours.
    Returns (state, history, scan, the device corpus, wrapper counts)."""
    from stylesinger_torch.training import vocoder_task as vt

    scan, corpus = vt.make_vocoder_scan(cfg, lambda m: say(
        label, t0, log=repr(m))), []

    def recorded(state, data, *rest, **kw):
        corpus.append(data)
        return scan(state, data, *rest, **kw)

    for ctr in counters().values():
        ctr.reset()
    with tempfile.TemporaryDirectory(prefix=".vocoder_dispatch_",
                                     dir=str(REPO)) as work:
        state, hist = vt.fit_vocoder(
            cfg, items, n_iter, work, batch=batch, crop_frames=crop,
            spd=spd, device="cuda", seed=SEED, scan=recorded,
            log=lambda m: say(label, t0, log=repr(m)))
    torch.cuda.synchronize()
    return state, hist, scan, corpus[0], {
        k: c.count for k, c in counters().items()}


def _eager_gan_iteration(cfg, corpus, batch, crop):
    from stylesinger_torch.training import vocoder_task as vt

    disc_body, gen_body = vt.make_vocoder_bodies(cfg)

    def iteration(st):
        n = st.step
        b = vt.device_crops(corpus, vt.vocoder_noise(SEED, n, "cuda", "crop"),
                            crop, batch, cfg["hop_size"])
        m = disc_body(st, b, vt.vocoder_noise(SEED, n, "cuda", "noise"))
        m.update(gen_body(st, b, vt.vocoder_noise(SEED, n, "cuda", "noise")))
        return m
    return iteration


def phase_vocoder_gan_dispatch(t0, torch, np, smi) -> None:
    """``fit_vocoder(spd=10)`` at the flagship vocoder's width
    (``load_config()``, f32) on 16 x 64-frame crops of the ``vocoder gan``
    corpus, under PyTorch's deterministic algorithms: one window of 10
    iterations, the first eager and the other 9 replays of one CUDA graph
    (the crops, the discriminator step with the MRF kernel in its
    generator pass, the generator step), against the same 10 iterations
    run eagerly from the same seeded state, twice: every loss of each
    iteration and each parameter after them within ``DISPATCH_REL_TOL``.
    The MRF wrapper counts 27 launches in the eager iteration and 27 in
    the capture; the replays' launches are counted by
    :func:`phase_dispatch_timing` from a profile."""
    from stylesinger_torch.training import vocoder_task as vt

    cfg, items, batch, crop = vocoder_dispatch_setup(np, torch)
    n_iter = 10
    with deterministic(torch) as caught:
        state, hist, scan, corpus, launches = recorded_vocoder_fit(
            torch, t0, cfg, items, n_iter, n_iter, batch, crop,
            "vocoder gan dispatch")
        iteration = _eager_gan_iteration(cfg, corpus, batch, crop)
        eager, again = (vt.init_vocoder_state(cfg, SEED, "cuda")
                        for _ in range(2))
        ref, ref2 = ([{k: v.cpu() for k, v in iteration(st).items()}
                      for _ in range(n_iter)] for st in (eager, again))
        torch.cuda.synchronize()
    loss_err = max(_rel(h[k], r[k]) for h, r in zip(hist, ref) for k in r)
    loss_err2 = max(_rel(h[k], r[k]) for h, r in zip(ref2, ref) for k in r)
    named = lambda st: {**dict(st.gen.named_parameters()),  # noqa: E731
                        **st.named_disc_params()}
    e_named = named(eager)
    param_err = max(leaf_rel(p.detach(), e_named[k].detach())
                    for k, p in named(state).items())
    param_err2 = max(leaf_rel(p.detach(), e_named[k].detach())
                     for k, p in named(again).items())
    graphs = scan.graphs
    say("vocoder gan dispatch", t0, gpu=repr(smi), spd=n_iter, batch=batch,
        crop_frames=crop, iterations=len(hist),
        captured=len(graphs.capture_seconds),
        loss_rel_err=f"{loss_err:.2e}",
        loss_eager_twice_rel_err=f"{loss_err2:.2e}",
        param_rel_err=f"{param_err:.2e}",
        param_eager_twice_rel_err=f"{param_err2:.2e}",
        tol=DISPATCH_REL_TOL, lr=cfg["vocoder_lr"],
        mrf_wrapper_launches_fit=launches["fused_mrf_blocks"],
        nondeterministic_ops=_nondeterministic_ops(caught),
        timer="deterministic algorithms")
    require(len(hist) == n_iter and state.step == n_iter and
            len(graphs.capture_seconds) == 1,
            "vocoder gan dispatch: not one graph over the iterations")
    require(launches["fused_mrf_blocks"] == 2 * 27,
            f"vocoder gan dispatch: the MRF wrapper counted {launches} in "
            "the fit (27 eager, 27 recorded into the graph)")
    require(launches["mel_spectrogram"] == 0,
            "vocoder gan dispatch: the mel kernel ran on the training path")
    require(loss_err <= DISPATCH_REL_TOL and param_err <= DISPATCH_REL_TOL,
            f"vocoder gan dispatch: graphed against eager iterations differ "
            f"by {loss_err:.2e} in the losses, {param_err:.2e} in the "
            f"parameters (relative; tolerance {DISPATCH_REL_TOL})")


def phase_dispatch_timing(t0, torch, np, smi) -> None:
    """The graphs' speed, on states of their own, after ``phase_device``
    (a profiler session that ran before the later phases left
    ``phase_device``'s own session without device events).  Per dtype: a
    ``Trainer.fit`` of the recipe at ``steps_per_dispatch=6`` to step 8
    (both curriculum phases captured), then warm ms per step graphed and
    eager in turns (5 each; the eager state has taken one step), the
    capture time per phase, the peak memory, and the device's busy time
    and idle share of 3 graphed and 3 eager steps (torch.profiler).  Then
    the GAN: ``fit_vocoder(spd=3)`` for 3 iterations (one eager, a
    capture, 2 replays), ms per iteration graphed and eager in turns, and
    the MRF kernels torch.profiler sees in 2 replays (27 each; the
    wrapper's count does not move)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stylesinger_torch.models.stylesinger import StyleSinger
    from stylesinger_torch.training import step as ts
    from stylesinger_torch.training import vocoder_task as vt

    for dtype in ("float32", "bfloat16"):
        for ctr in counters().values():
            ctr.reset()
        run = dispatch_fit(torch, np, dtype, DISPATCH_STEPS + 2)
        cfg, graphed, scan, stacked = run.cfg, run.state, run.scan, \
            run.stacked
        last = ts.phase_for_step(DISPATCH_STEPS, cfg)
        b_dev = ts.batch_to_device(run.batch, "cuda")
        eager = ts.init_state(StyleSinger(cfg, run.vocab).cuda(), cfg)
        ts.train_step(eager, b_dev, last, cfg)
        g_ms, e_ms = [], []
        for _ in range(5):  # in turns, one process
            e_ms.append(synced_ms(torch, lambda: ts.train_step(
                eager, b_dev, last, cfg)))
            g_ms.append(synced_ms(torch, lambda: scan(
                graphed, stacked, [0], last)))
        g_wall, g_busy, g_kernels = profile_busy(
            torch, lambda: scan(graphed, stacked, [0], last))
        e_wall, e_busy, e_kernels = profile_busy(
            torch, lambda: ts.train_step(eager, b_dev, last, cfg))
        launches = {k: c.count for k, c in counters().items()}
        graphs = scan.graphs
        say("train dispatch timing", t0, gpu=repr(smi), compute_dtype=dtype,
            steps_per_dispatch=DISPATCH_STEPS,
            windows=[(len(next(iter(m.values()))), round(ms, 1))
                     for _, ms, m in run.windows],
            capture_s={"/".join(k for k, v in key[0]._asdict().items()
                                if v) or "none": f"{s:.2f}"
                       for key, s in graphs.capture_seconds.items()},
            draws_per_replay=sorted(set(graphs.draws().values())),
            graphed_warm_ms=[round(v, 1) for v in g_ms],
            eager_warm_ms=[round(v, 1) for v in e_ms],
            graphed_median_ms=f"{np.median(g_ms):.1f}",
            eager_median_ms=f"{np.median(e_ms):.1f}",
            peak_mem_gib=f"{run.peak / 2 ** 30:.2f}",
            peak_over_start_gib=f"{(run.peak - run.start) / 2 ** 30:.3f}",
            graphed_profiled_ms=f"{g_wall:.1f}",
            graphed_device_busy_ms=f"{g_busy:.1f}",
            graphed_idle_share=f"{1 - g_busy / g_wall:.3f}",
            graphed_kernels_per_step=round(g_kernels),
            eager_profiled_ms=f"{e_wall:.1f}",
            eager_device_busy_ms=f"{e_busy:.1f}",
            eager_idle_share=f"{1 - e_busy / e_wall:.3f}",
            eager_kernels_per_step=round(e_kernels), launches=launches,
            timer="host clock, cuda.synchronize; torch.profiler")
        require(len(graphs.capture_seconds) == 2 and
                graphed.step == DISPATCH_STEPS + 2 + 5 + 3,
                f"train dispatch timing {dtype}: not both phases captured, "
                f"or step {graphed.step}")
        require(g_busy > 0 and e_busy > 0,
                f"train dispatch timing {dtype}: the profiler saw no device "
                "time")
        require(all(v == 0 for v in launches.values()),
                f"train dispatch timing {dtype}: a kernel launched "
                f"{launches}")
        del run, graphed, scan, stacked, graphs, eager, b_dev
        torch.cuda.empty_cache()

    cfg, items, batch, crop = vocoder_dispatch_setup(np, torch)
    torch.cuda.reset_peak_memory_stats()
    state, _, scan, corpus, _ = recorded_vocoder_fit(
        torch, t0, cfg, items, 3, 3, batch, crop, "vocoder gan timing")
    peak = torch.cuda.max_memory_allocated()
    iteration = _eager_gan_iteration(cfg, corpus, batch, crop)
    eager = vt.init_vocoder_state(cfg, SEED, "cuda")
    iteration(eager)
    g_ms, e_ms = [], []
    for _ in range(5):
        e_ms.append(synced_ms(torch, lambda: iteration(eager)))
        g_ms.append(synced_ms(torch, lambda: scan(state, corpus, SEED, 1,
                                                  crop, batch)))
    mrf = counters()["fused_mrf_blocks"]
    before = mrf.count
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        scan(state, corpus, SEED, 2, crop, batch)
        torch.cuda.synchronize()
    replayed = sum("mrf_step_kernel" in e.name for e in prof.events()
                   if e.device_type == DeviceType.CUDA) / 2
    say("vocoder gan timing", t0, gpu=repr(smi), batch=batch,
        crop_frames=crop, graphed_ms=[round(v, 1) for v in g_ms],
        eager_ms=[round(v, 1) for v in e_ms],
        graphed_median_ms=f"{np.median(g_ms):.1f}",
        eager_median_ms=f"{np.median(e_ms):.1f}",
        mrf_kernels_per_replay=replayed,
        mrf_wrapper_count_over_replays=mrf.count - before,
        peak_mem_gib=f"{peak / 2 ** 30:.2f}",
        timer="host clock, cuda.synchronize; torch.profiler")
    require(replayed == 27 and mrf.count == before,
            f"vocoder gan timing: {replayed} MRF kernels per replay in the "
            f"profile (27), the wrapper counted {mrf.count - before} (0)")


def _gan_check(torch, np, cpu, gpu, grads, lr):
    """Gradients and updated parameters of one GAN iteration, the card
    against the CPU: the worst gradient error over its tolerance (2e-3
    relative + 2e-4 x max|g_leaf| + 1e-7 x max|g|) and the worst parameter
    error where the CPU gradient is >= 1e-6, over 0.05 x lr."""
    from stylesinger_torch.training import vocoder_task as vt

    names = {"disc": list(cpu.named_disc_params()),
             "gen": [n for n, _ in cpu.gen.named_parameters()]}
    worst_g = worst_p = 0.0
    for side, (st_c, st_g) in (("disc", (cpu.disc_params(),
                                         gpu.disc_params())),
                               ("gen", (list(cpu.gen.parameters()),
                                        list(gpu.gen.parameters())))):
        g_cpu, g_gpu = grads["cpu"][side], grads["gpu"][side]
        g_max = max(float(g.abs().max()) for g in g_cpu)
        for n, a, b, pc, pg in zip(names[side], g_cpu, g_gpu, st_c, st_g):
            tol = 2e-3 * a.abs() + 2e-4 * a.abs().max() + 1e-7 * g_max
            worst_g = max(worst_g, float(((b - a).abs() / tol).max()))
            steady = a.abs() >= 1e-6
            if steady.any():
                diff = (pg.detach().cpu() - pc.detach()).abs()[steady]
                worst_p = max(worst_p, float(diff.max()) / (0.05 * lr))
    return worst_g, worst_p


def _recording_opt(opt, seen, side):
    step = opt.step

    def rec(params, g, *rest):
        seen[side] = [x.detach().cpu().clone() for x in g]
        step(params, g, *rest)
    opt.step = rec


def phase_vocoder_gan_small(t0, torch, np):
    """One discriminator + generator iteration of the tiny vocoder GAN on
    the card against the CPU (same weights, batch and draws, TF32 off)."""
    from stylesinger_torch.config import tiny_test_config
    from stylesinger_torch.training import vocoder_task as vt

    cfg = tiny_test_config(hop_size=64, fft_size=256, win_size=256,
                           fmax=8000, audio_sample_rate=16000, mrf_block=64)
    rng = np.random.default_rng(SEED)
    f0 = rng.uniform(150, 250, (2, 16)).astype(np.float32)
    f0[:, -3:] = 0.0
    batch = {"mels": rng.standard_normal((2, 16, 16)).astype(np.float32),
             "f0": f0,
             "wav": (0.3 * rng.standard_normal((2, 1024))).astype(
                 np.float32)}
    cpu = vt.init_vocoder_state(cfg, SEED, "cpu")
    gpu = vt.init_vocoder_state(cfg, SEED, "cuda")
    gpu.load_state_dict(cpu.state_dict())
    grads = {"cpu": {}, "gpu": {}}
    for name, st in (("cpu", cpu), ("gpu", gpu)):
        _recording_opt(st.disc_opt, grads[name], "disc")
        _recording_opt(st.gen_opt, grads[name], "gen")
    disc_step, gen_step = vt.make_vocoder_bodies(cfg)
    rec = [_Recorder(SEED), _Recorder(SEED)]
    b_cpu = vt.batch_to_device(batch, "cpu")
    m_cpu = disc_step(cpu, b_cpu, rec[0])
    m_cpu.update(gen_step(cpu, b_cpu, rec[1]))
    b_gpu = vt.batch_to_device(batch, "cuda")
    for ctr in counters().values():
        ctr.reset()
    m_gpu = disc_step(gpu, b_gpu, _Replay(rec[0].draws, "cuda"))
    disc_launches = counters()["fused_mrf_blocks"].count
    m_gpu.update(gen_step(gpu, b_gpu, _Replay(rec[1].draws, "cuda")))
    gen_launches = counters()["fused_mrf_blocks"].count - disc_launches
    torch.cuda.synchronize()
    errs = {k: abs(float(m_gpu[k]) - float(v)) / max(1.0, abs(float(v)))
            for k, v in m_cpu.items()}
    worst_g, worst_p = _gan_check(torch, np, cpu, gpu, grads,
                                  cfg["vocoder_lr"])
    say("small vocoder gan step", t0, losses=len(m_cpu),
        worst_loss_err=f"{max(errs.values()):.2e}", tol="1e-5",
        worst_grad_err_over_tol=f"{worst_g:.3f}",
        worst_param_err_over_tol=f"{worst_p:.3f}",
        mrf_launches_disc=disc_launches, mrf_launches_gen=gen_launches,
        mel_launches=counters()["mel_spectrogram"].count)
    require(set(m_gpu) == set(m_cpu) == {"disc_loss", "adv", "fm",
                                         "mel_l1", "gen_loss"},
            f"small vocoder gan step: metrics {sorted(m_gpu)}")
    require(all(e <= 1e-5 for e in errs.values()),
            f"small vocoder gan step: losses differ {errs}")
    require(worst_g <= 1.0 and worst_p <= 1.0,
            f"small vocoder gan step: gradients {worst_g:.2f} / parameters "
            f"{worst_p:.2f} x their tolerance")
    require(disc_launches == 27 and gen_launches == 0,
            f"small vocoder gan step: MRF launches {disc_launches} in the "
            f"disc step, {gen_launches} in the gen step (expected 27, 0)")


def harmonic_corpus(np, torch, cfg, n, frames, seed):
    """Seeded singing-like items: a harmonic tone with vibrato and an
    f0 glide per item, its frame f0 and its ``wav2spec`` mel (the mel
    kernel on the card)."""
    from stylesinger_torch.dsp.mel import wav2spec

    sr, hop = cfg["audio_sample_rate"], cfg["hop_size"]
    rng = np.random.default_rng(seed)
    items = []
    for _ in range(n):
        t_frames = int(rng.integers(*frames))
        t = np.arange(t_frames * hop) / sr
        base = rng.uniform(150.0, 450.0) * 2 ** (
            rng.uniform(-2, 2) / 12 * t / t[-1])
        f0 = base * (1 + 0.02 * np.sin(2 * np.pi * 5.5 * t))
        phase = 2 * np.pi * np.cumsum(f0) / sr
        amps = rng.uniform(0.2, 1.0, 8) / np.arange(1, 9)
        wav = sum(a * np.sin((h + 1) * phase) for h, a in enumerate(amps))
        env = np.minimum(1.0, np.minimum(t, t[-1] - t) / 0.05)
        wav = (0.3 * wav * env / np.abs(wav).max()).astype(np.float32)
        spec = wav2spec(wav, torch.device("cuda"), sample_rate=sr,
                        n_fft=cfg["fft_size"], hop_size=hop,
                        win_length=cfg["win_size"],
                        n_mels=cfg["audio_num_mel_bins"], fmin=cfg["fmin"],
                        fmax=cfg["fmax"])
        items.append({"mel": spec["mel"][:t_frames].cpu().numpy(),
                      "wav": wav, "f0": f0[::hop].astype(np.float32)})
    return items


def gan_iteration_flop(torch, state, batch, noise):
    """FLOP of one GAN iteration, from the shapes of its forward passes
    (``torch.utils.flop_counter``), a backward counted as twice its
    forward (weights and inputs): G, the generator on the resblock modules
    (a gradient is recorded, so the counter sees every conv), and D, MPD +
    MSD on one batch.  The discriminator step is G + 6 D (D forward on real
    and fake, then backward), the generator step 3 G + 3 D (D on real
    without a gradient, D on fake forward and backward to its input)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        state.gen(batch["mels"], batch["f0"], noise)
    g = fc.get_total_flops()
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        state.mpd(batch["wav"])
        state.msd(batch["wav"])
    d = fc.get_total_flops()
    return g + 6 * d, 3 * g + 3 * d


def phase_vocoder_gan(t0, torch, np, root: Path) -> Path:
    """The vocoder GAN at the flagship width: ``fit_vocoder`` 6 iterations
    on the host crops (1 warm-up + 5 warm), 2 more through the device loop
    (``spd`` 2), then an exact restore, ``HifiGAN_NSF`` on the saved
    ``vocoder_ckpt``, one iteration from the restored state against the
    unbroken state, the discriminator step's generator pass at the path's
    shapes on the MRF kernel against the "blocks" route, and the
    resynthesis mel L1 through ``wav2spec``, its mel kernel against the
    plain twin.  Returns the trained ``generator.pt``, copied to
    ``<root>`` for the serving phases."""
    import shutil
    import tempfile

    from stylesinger_torch.config import load_config
    from stylesinger_torch.dsp.mel import wav2spec
    from stylesinger_torch.models.diffusion import Noise
    from stylesinger_torch.training import vocoder_task as vt
    from stylesinger_torch.training.checkpoint import load_payload
    from stylesinger_torch.vocoder_infer import HifiGAN_NSF

    cfg = load_config()
    batch, crop, host_steps, scan_steps = 16, 64, 6, 2
    items = harmonic_corpus(np, torch, cfg, 8, (128, 321), SEED)
    held_out = harmonic_corpus(np, torch, cfg, 1, (512, 513), SEED + 1)[0]
    log = []
    make_steps, make_scan = vt.make_vocoder_steps, vt.make_vocoder_scan

    def timed(kind, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            before = counters()["fused_mrf_blocks"].count
            tb = time.perf_counter()
            m = fn(*args, **kwargs)
            torch.cuda.synchronize()
            log.append((kind, 1e3 * (time.perf_counter() - tb),
                        counters()["fused_mrf_blocks"].count - before, m))
            return m
        return run

    def timed_steps(cfg, seed=0):
        gen_step, disc_step = make_steps(cfg, seed)
        return timed("gen", gen_step), timed("disc", disc_step)

    def timed_scan(cfg, *args):
        return timed("scan", make_scan(cfg, *args))

    def say_fit(msg):
        say("vocoder gan fit", t0, log=repr(msg))

    for ctr in counters().values():
        ctr.reset()
    torch.cuda.reset_peak_memory_stats()
    work = tempfile.TemporaryDirectory(prefix=".vocoder_smoke_",
                                       dir=str(REPO))
    vt.make_vocoder_steps, vt.make_vocoder_scan = timed_steps, timed_scan
    try:
        state, hist = vt.fit_vocoder(cfg, items, host_steps, work.name,
                                     batch=batch, crop_frames=crop,
                                     device="cuda", seed=SEED, log=say_fit)
        host_launches = {k: c.count for k, c in counters().items()}
        state, hist2 = vt.fit_vocoder(cfg, items, host_steps + scan_steps,
                                      work.name, batch=batch,
                                      crop_frames=crop, spd=scan_steps,
                                      device="cuda", seed=SEED, log=say_fit)
        vt.make_vocoder_steps, vt.make_vocoder_scan = make_steps, make_scan
        launches = {k: c.count for k, c in counters().items()}
        peak = torch.cuda.max_memory_allocated()

        # an exact restore of the saved state
        restored = vt.init_vocoder_state(cfg, 0, "cuda")
        restored.load_state_dict(load_payload(
            str(Path(work.name) / vt.GAN_STATE_FILE), "cuda"))
        a, b = state.state_dict(), restored.state_dict()
        exact = a["step"] == b["step"] == host_steps + scan_steps and all(
            torch.equal(v, b[side][k]) for side in ("gen", "mpd", "msd")
            for k, v in a[side].items()) and all(
            a[o]["count"] == b[o]["count"] and all(
                torch.equal(v, b[o][key][k]) for key in ("mu", "nu")
                for k, v in a[o][key].items())
            for o in ("gen_opt", "disc_opt"))

        # the saved generator as vocoder_ckpt, against the trainer's
        voc = HifiGAN_NSF(cfg.replace(vocoder_ckpt=str(
            Path(work.name) / vt.GENERATOR_FILE)), device="cuda")
        same_weights = all(torch.equal(v, state.gen.state_dict()[k])
                           for k, v in voc.model.state_dict().items())
        mel = held_out["mel"][:512]
        f0 = held_out["f0"][:512]
        spec2wav_ms = []
        for _ in range(2):  # the first call meets these shapes first
            counters()["fused_mrf_blocks"].reset()
            torch.cuda.synchronize()
            tv = time.perf_counter()
            wav_gen = voc.spec2wav(mel, f0, noise=Noise(SEED, "cuda"))
            torch.cuda.synchronize()
            spec2wav_ms.append(1e3 * (time.perf_counter() - tv))
        voc_launches = counters()["fused_mrf_blocks"].count
        with torch.no_grad():
            direct = state.gen(torch.as_tensor(mel, device="cuda")[None],
                               torch.as_tensor(f0, device="cuda")[None],
                               Noise(SEED, "cuda"))[0].cpu().numpy()
        voc_err = float(np.abs(wav_gen - direct).max())

        # one iteration from the restored state and from the unbroken one
        crops = vt.crop_batch(items[:batch // 2] * 2, cfg,
                              np.random.default_rng(SEED), crop)
        b_dev = vt.batch_to_device(crops, "cuda")
        disc_step, gen_step = vt.make_vocoder_bodies(cfg)
        cont = []
        for st in (state, restored):
            m = disc_step(st, b_dev, vt.vocoder_noise(SEED, st.step, "cuda",
                                                      "noise"))
            m.update(gen_step(st, b_dev, vt.vocoder_noise(
                SEED, st.step, "cuda", "noise")))
            cont.append(m)
        # relative, as the small step's: a backward that sums in another
        # order from run to run moves a loss of ~100 by its f32 spacing
        cont_loss_err = max(abs(float(cont[0][k]) - float(cont[1][k])) /
                            max(1.0, abs(float(cont[0][k])))
                            for k in cont[0])
        flop_disc, flop_gen = gan_iteration_flop(
            torch, state, b_dev, vt.vocoder_noise(SEED, 0, "cuda", "noise"))
        cont_param_err = max(
            float((p - q).detach().abs().max()) for p, q in zip(
                list(state.gen.parameters()) + state.disc_params(),
                list(restored.gen.parameters()) + restored.disc_params()))

        # the discriminator step's generator pass at the path's own shapes
        # (16 x 64-frame crops: fewer blocks than SMs): the MRF kernel
        # against the "blocks" route that autograd takes, on the same
        # crops and noise
        mrf_ctr = counters()["fused_mrf_blocks"]
        before = mrf_ctr.count
        def disc_pass():
            return state.gen(b_dev["mels"], b_dev["f0"], vt.vocoder_noise(
                SEED, state.step, "cuda", "noise"))
        with torch.no_grad():
            fake_kernel = disc_pass()
        pass_launches = mrf_ctr.count - before
        fake_blocks = disc_pass().detach()
        blocks_launches = mrf_ctr.count - before - pass_launches
        pass_scale = float(fake_blocks.abs().max())
        pass_err = float((fake_kernel - fake_blocks).abs().max())
        pass_blocks = [b_dev["mels"].shape[0] * crop * int(np.prod(
            cfg["upsample_rates"][:i + 1])) // cfg["mrf_block"]
            for i, r in enumerate(state.gen.mrf_routes(crop)) if r == "kernel"]
        del fake_kernel, fake_blocks
        generator = root / vt.GENERATOR_FILE
        shutil.copy(Path(work.name) / vt.GENERATOR_FILE, generator)
    finally:
        vt.make_vocoder_steps, vt.make_vocoder_scan = make_steps, make_scan
        work.cleanup()

    # the resynthesis mel L1 through wav2spec (the mel kernel)
    counters()["mel_spectrogram"].reset()
    kw = dict(sample_rate=cfg["audio_sample_rate"], n_fft=cfg["fft_size"],
              hop_size=cfg["hop_size"], win_length=cfg["win_size"],
              n_mels=cfg["audio_num_mel_bins"], fmin=cfg["fmin"],
              fmax=cfg["fmax"])
    dev = torch.device("cuda")
    mg = wav2spec(wav_gen, dev, **kw)["mel"]
    mr = wav2spec(held_out["wav"][: 512 * cfg["hop_size"]], dev, **kw)["mel"]
    n = min(mg.shape[0], mr.shape[0])
    mel_l1 = float((mg[:n] - mr[:n]).abs().mean())
    resynth_mel_launches = counters()["mel_spectrogram"].count
    # the mel kernel against its plain twin on the same two wavs
    resynth_mel_err, resynth_mel_ok = 0.0, True
    for w, out in ((wav_gen, mg),
                   (held_out["wav"][: 512 * cfg["hop_size"]], mr)):
        ok, err = mel_against_plain(torch, np, cfg, w, out)
        resynth_mel_ok &= ok
        resynth_mel_err = max(resynth_mel_err, err)

    for i, (kind, ms, mrf, m) in enumerate(log):
        label = (f"{kind} step {i // 2}" if kind != "scan" else
                 f"scan steps {host_steps}-{host_steps + scan_steps - 1}")
        say(f"vocoder gan {label}", t0, ms=f"{ms:.1f}",
            mrf_launches=mrf, **{k: f"{float(v.float().mean()):.4f}"
                                 for k, v in m.items()})
    disc = [e for e in log if e[0] == "disc"]
    gen = [e for e in log if e[0] == "gen"]
    scan = [e for e in log if e[0] == "scan"]
    warm_d = sorted(e[1] for e in disc[1:])
    warm_g = sorted(e[1] for e in gen[1:])
    warm_iter_ms = sum(warm_d) + sum(warm_g)
    iter_bound, by = bound_ms(flop_disc + flop_gen, 0.0)
    warm_median_iter_ms = np.median(warm_d) + np.median(warm_g)
    n_gen = sum(p.numel() for p in state.gen.parameters())
    n_disc = sum(p.numel() for p in state.disc_params())
    losses = [float(v) for m in hist + hist2 + cont for v in m.values()]
    say("vocoder gan", t0, gen_params=n_gen, disc_params=n_disc,
        batch=batch, crop_frames=crop, crop_samples=crop * cfg["hop_size"],
        mrf_routes_disc=state.gen.mrf_routes(crop),
        mrf_routes_gen=state.gen.mrf_routes(crop, grad=True),
        disc_first_ms=f"{disc[0][1]:.1f}", gen_first_ms=f"{gen[0][1]:.1f}",
        disc_warm_median_ms=f"{np.median(warm_d):.1f}",
        disc_warm_min_max_ms=f"{warm_d[0]:.1f}/{warm_d[-1]:.1f}",
        gen_warm_median_ms=f"{np.median(warm_g):.1f}",
        gen_warm_min_max_ms=f"{warm_g[0]:.1f}/{warm_g[-1]:.1f}",
        iterations_per_s_warm=f"{1e3 * len(warm_d) / warm_iter_ms:.3f}",
        flop_disc_step=f"{flop_disc:.4e}", flop_gen_step=f"{flop_gen:.4e}",
        iteration_bound_ms=f"{iter_bound:.1f}", bound_by=by,
        peak="f32 67e12",
        share_of_bound=f"{iter_bound / warm_median_iter_ms:.3f}",
        scan_iterations=len(hist2),
        scan_ms_per_iteration=f"{scan[0][1] / scan_steps:.1f}",
        peak_mem_gib=f"{peak / 2 ** 30:.2f}",
        mrf_launches_per_disc_step=sorted({e[2] for e in disc}),
        mrf_launches_per_gen_step=sorted({e[2] for e in gen}),
        mrf_launches_fit=host_launches["fused_mrf_blocks"],
        mrf_launches_scan=launches["fused_mrf_blocks"] -
        host_launches["fused_mrf_blocks"],
        mel_launches_fit=launches["mel_spectrogram"],
        restore_exact=exact, vocoder_ckpt_same_weights=same_weights,
        spec2wav_frames=mel.shape[0],
        spec2wav_first_warm_ms=f"{spec2wav_ms[0]:.1f}/{spec2wav_ms[1]:.1f}",
        spec2wav_mrf_launches=voc_launches,
        spec2wav_vs_trainer_err=f"{voc_err:.2e}",
        continue_loss_err=f"{cont_loss_err:.2e}",
        continue_param_err=f"{cont_param_err:.2e}",
        resynth_mel_l1=f"{mel_l1:.4f}",
        resynth_mel_launches=resynth_mel_launches,
        resynth_mel_vs_plain_err=f"{resynth_mel_err:.3e}",
        resynth_mel_tol="atol3e-3/rtol2e-3",
        disc_pass_kernel_blocks=pass_blocks,
        disc_pass_kernel_vs_blocks_err=f"{pass_err:.3e}",
        disc_pass_max_abs_y=f"{pass_scale:.3e}",
        disc_pass_tol=f"{MRF_REL_TOL:g}*max|y|",
        timer="host clock, cuda.synchronize")
    require(len(disc) == len(gen) == host_steps and len(hist) == host_steps
            and len(hist2) == scan_steps and len(scan) == 1,
            f"vocoder gan: {len(disc)} / {len(gen)} host steps and "
            f"{len(hist2)} loop steps")
    require(all(e[2] == 27 for e in disc) and all(e[2] == 0 for e in gen),
            "vocoder gan: MRF launches per disc / gen step are not 27 / 0")
    require(scan[0][2] == 27 * scan_steps and launches["fused_mrf_blocks"]
            - host_launches["fused_mrf_blocks"] == 27 * scan_steps,
            "vocoder gan: the device loop's disc steps did not launch the "
            "MRF kernel 27 times each")
    require(launches["mel_spectrogram"] == 0,
            "vocoder gan: the mel kernel ran on the training path")
    require(all(np.isfinite(v) for v in losses),
            "vocoder gan: a non-finite loss")
    require(exact, "vocoder gan: the restore does not equal the saved state")
    require(same_weights and voc_err <= 1e-6 and voc_launches == 27,
            f"vocoder gan: HifiGAN_NSF on the saved vocoder_ckpt differs "
            f"({voc_err:.2e}, {voc_launches} MRF launches)")
    require(cont_loss_err <= 1e-5 and
            cont_param_err <= 0.05 * cfg["vocoder_lr"],
            f"vocoder gan: the restored state's next iteration differs "
            f"(loss {cont_loss_err:.2e}, parameters {cont_param_err:.2e})")
    require(np.isfinite(mel_l1) and resynth_mel_launches == 2,
            f"vocoder gan: resynthesis mel L1 {mel_l1}")
    require(resynth_mel_ok, f"vocoder gan: the mel kernel disagrees with its "
            f"plain twin on the resynthesis wavs ({resynth_mel_err:.3e})")
    require(pass_launches == 27 and blocks_launches == 0 and
            pass_err <= MRF_REL_TOL * pass_scale,
            f"vocoder gan: the disc step's generator pass on the MRF kernel "
            f"({pass_launches} launches) differs from the blocks route "
            f"({blocks_launches} launches) by {pass_err:.3e} of max|y| "
            f"{pass_scale:.3e}")
    return generator


def ge2e_file(torch, path: Path, seed: int) -> str:
    """A GE2E encoder checkpoint in the reference's layout, ``{"model_state":
    sd}`` of a 3-layer LSTM(40 -> 256) and a linear head, seeded weights."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for prefix, module in (("lstm", torch.nn.LSTM(40, 256, 3,
                                                  batch_first=True)),
                           ("linear", torch.nn.Linear(256, 256))):
        for k, v in module.state_dict().items():
            scale = 0.1 if k.startswith("bias") else v.shape[-1] ** -0.5
            sd[f"{prefix}.{k}"] = torch.randn(v.shape, generator=g) * scale
    torch.save({"model_state": sd, "step": 0}, path)
    return str(path)


def serve_inputs(torch, np, root: Path, train, generator: Path, wav_np):
    """What the serving phases read, under ``<root>/serve``: the corpus dir
    (a ``phone_set.json`` of the trained model's vocab, the example's phones
    among them, and a 4-item binarized test split written with the port's
    shard writer), two GE2E files, the reference clip as a wav; and the
    recipe's config naming them with ``--hparams``."""
    from stylesinger_torch.config import load_config
    from stylesinger_torch.data.indexed_dataset import IndexedDatasetBuilder
    from stylesinger_torch.dsp.mel import save_wav
    from stylesinger_torch.text import build_token_encoder

    serve = root / "serve"
    binary = serve / "binary"
    binary.mkdir(parents=True)
    phones = sorted(set(EXAMPLE["ph"].split()))
    phones += [f"p{i}" for i in range(train["vocab"] - 3 - len(phones))]
    require(len(build_token_encoder(phones)) == train["vocab"],
            "serve: the phone set does not give the trained vocab")
    (binary / "phone_set.json").write_text(json.dumps(phones))
    test_items = synthetic_items(np, 4, (200, 501), (30, 61),
                                 train["cfg"]["audio_num_mel_bins"],
                                 train["vocab"], SEED + 2)
    builder = IndexedDatasetBuilder(str(binary / "test"))
    for item in test_items:
        builder.add_item(item)
    builder.finalize()
    np.save(binary / "test_lengths.npy",
            np.asarray([len(it["mel"]) for it in test_items]))
    ref = serve / "ref.wav"
    save_wav(wav_np, str(ref), 48000)
    paths = dict(vocoder_ckpt=str(generator),
                 speaker_encoder_path=ge2e_file(torch, serve / "spk.pt",
                                                SEED + 3),
                 emotion_encoder_path=ge2e_file(torch, serve / "emo.pt",
                                                SEED + 4),
                 binary_data_dir=str(binary))
    return dict(cfg=load_config(recipe="stylesinger", **paths),
                hparams=",".join(f"{k}={v}" for k, v in paths.items()),
                ref=ref, serve=serve, test_items=test_items, **paths)


def _same_weights(torch, module, sd) -> bool:
    own = module.state_dict()
    return own.keys() == sd.keys() and all(
        torch.equal(v, sd[k].to(v.device)) for k, v in own.items())


def phase_checkpoint_infer(t0, torch, np, train, inputs, wav_np):
    """``StyleSingerInfer`` of the recipe with trained weights: the
    ``train recipe`` work dir through ``load_params`` (its latest
    checkpoint), the ``vocoder gan`` phase's ``generator.pt`` as
    ``vocoder_ckpt`` and the two GE2E files, each bit for bit what was
    saved; the example phrase's 27 / 12 / 6 phones against an instance
    that holds the trainer's in-memory state (same noise seed); then the
    phrase through ``run.py infer`` from the work dir."""
    import wave

    from stylesinger_torch import run
    from stylesinger_torch.convert import from_jax_params, load_ge2e_checkpoint
    from stylesinger_torch.inference import StyleSingerInfer
    from stylesinger_torch.models.diffusion import Noise
    from stylesinger_torch.vocoder_infer import read_generator_file

    cfg, state, work = inputs["cfg"], train["state"], train["work"]
    torch.cuda.synchronize()
    tb = time.perf_counter()
    infer = StyleSingerInfer(cfg, device="cuda")  # loads vocoder + GE2E
    torch.cuda.synchronize()
    tl = time.perf_counter()
    infer.load_params(str(work))
    torch.cuda.synchronize()
    load_s, build_s = time.perf_counter() - tl, tl - tb
    memory = StyleSingerInfer(cfg, device="cuda")
    memory.load_params(state)
    exact = dict(
        model=_same_weights(torch, infer.model, state.model.state_dict()),
        vocoder=_same_weights(torch, infer.vocoder, read_generator_file(
            inputs["vocoder_ckpt"])),
        spk_encoder=_same_weights(torch, infer.spk_encoder, from_jax_params(
            load_ge2e_checkpoint(inputs["speaker_encoder_path"]))),
        emo_encoder=_same_weights(torch, infer.emo_encoder, from_jax_params(
            load_ge2e_checkpoint(inputs["emotion_encoder_path"]))))
    say("checkpoint infer load", t0, step=state.step,
        load_params_s=f"{load_s:.3f}", build_with_vocoder_and_ge2e_s=(
            f"{build_s:.3f}"), bit_exact=exact)
    require(all(exact.values()), f"checkpoint infer: loaded weights differ "
            f"from what was saved {exact}")

    none = {k: 0 for k in counters()}
    expect = dict(none, mel_spectrogram=1, fused_mrf_blocks_bf16=27)
    hop = cfg["hop_size"]

    def untrimmed(m, req):
        """forward_model's draws and outputs before the crop to the
        predicted length: every float output of the acoustic model (the
        durations, the style, the decoder input, the mel [max_frames, M],
        ...), the wav the vocoder makes of the whole mel, and the
        predicted frames."""
        noise = Noise(cfg["seed"], "cuda")
        with torch.no_grad():
            ret = m.model(**m.preprocess_input(req), noise=noise)
            wav = m.vocoder(ret["mel_out"], ret["f0_denorm"], noise)[0]
        return ({k: v for k, v in ret.items()
                 if torch.is_tensor(v) and v.is_floating_point()},
                wav.cpu().numpy(), int((ret["mel2ph"] > 0).sum(-1).max()))

    requests = [cut(EXAMPLE, 27), cut(EXAMPLE, 12), cut(EXAMPLE, 6)]
    wants = []
    for n, req in enumerate(requests):
        req = dict(req, ref_audio=wav_np)
        for ctr in counters().values():
            ctr.reset()
        torch.cuda.synchronize()
        tr = time.perf_counter()
        wav = infer.infer_once(req)
        torch.cuda.synchronize()
        lat = time.perf_counter() - tr
        launches = {k: c.count for k, c in counters().items()}
        # a 12-step model predicts few frames (often none, and then the
        # mel is all zeros), so the cropped wav may be empty: compare every
        # acoustic output and the wav of the whole mel, then the crop
        out, full, frames = untrimmed(infer, req)
        out_m, full_m, frames_m = untrimmed(memory, req)
        want = full_m[: frames_m * hop]
        wants.append(want)
        errs = {k: float((v - out_m[k]).abs().max())
                if k in out_m and v.shape == out_m[k].shape else float("inf")
                for k, v in out.items()}
        scales = {k: float(v.abs().max()) for k, v in out_m.items()}
        acoustic_ok = out.keys() == out_m.keys() and scales["dur"] > 0 and \
            all(errs[k] <= 1e-5 * scales[k] for k in out)
        scale = float(np.abs(full_m).max()) if full_m.size else 0.0
        err = float(np.abs(full - full_m).max()) \
            if full.shape == full_m.shape and full_m.size else float("inf")
        audio_s = wav.shape[0] / cfg["audio_sample_rate"]
        say(f"checkpoint infer request {n}", t0,
            phones=len(req["ph"].split()), latency_s=f"{lat:.3f}",
            samples=wav.shape[0], audio_s=f"{audio_s:.3f}",
            rtf=f"{lat / audio_s:.4f}" if audio_s > 0 else "inf",
            untrimmed_samples=full_m.shape[0],
            untrimmed_vs_in_memory_err=f"{err:.3e}",
            max_abs_untrimmed_wav=f"{scale:.3e}",
            acoustic_outputs=sorted(out),
            acoustic_worst_err=f"{max(errs.values()):.3e}",
            dur_err=f"{errs['dur']:.3e}", max_abs_dur=f"{scales['dur']:.3e}",
            mel_err=f"{errs['mel_out']:.3e}",
            max_abs_mel=f"{scales['mel_out']:.3e}", tol="1e-5*max|.|",
            mel_launches=launches["mel_spectrogram"],
            mrf_bf16_launches=launches["fused_mrf_blocks_bf16"])
        require(full_m.size > 0 and scale > 0 and np.isfinite(full).all()
                and err <= 1e-5 * scale and acoustic_ok,
                f"checkpoint infer request {n}: differs from the in-memory "
                f"weights (wav {full.shape} vs {full_m.shape}, {err:.3e}; "
                f"acoustic outputs {errs} of {scales})")
        require(frames == frames_m and wav.shape == want.shape and
                np.isfinite(wav).all(), f"checkpoint infer request {n}: "
                f"{wav.shape} samples, the in-memory weights give "
                f"{want.shape}")
        require(launches == expect, f"checkpoint infer request {n}: "
                f"launches {launches}, expected {expect}")

    # the phrase through run.py's infer path, from the work dir
    out = inputs["serve"] / "infer_out" / "test.wav"
    for ctr in counters().values():
        ctr.reset()
    torch.cuda.synchronize()
    tr = time.perf_counter()
    rc = run.main(["infer", "--recipe", "stylesinger", "--hparams",
                   inputs["hparams"], "--exp_name", work.name,
                   "--work_dir_root", str(work.parent), "--ref_audio",
                   str(inputs["ref"]), "--out", str(out)])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - tr
    launches = {k: c.count for k, c in counters().items()}
    with wave.open(str(out), "rb") as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    want_pcm = (np.clip(wants[0], -1, 1) * 32767.0).astype(np.int16)
    pcm_err = int(np.abs(pcm.astype(np.int32) - want_pcm).max()) \
        if pcm.shape == want_pcm.shape and pcm.size else -1
    say("checkpoint infer run.py infer", t0, rc=rc, seconds=f"{cli_s:.3f}",
        samples=pcm.shape[0], vs_in_memory_lsb=pcm_err,
        mel_launches=launches["mel_spectrogram"],
        mrf_bf16_launches=launches["fused_mrf_blocks_bf16"])
    require(rc == 0 and pcm.shape == want_pcm.shape and pcm.size > 0 and
            0 <= pcm_err <= 1,
            f"checkpoint infer: run.py infer (rc {rc}) wrote {pcm.shape} "
            f"samples, {pcm_err} LSB from the in-memory wav")
    require(launches == expect, f"checkpoint infer: run.py infer launches "
            f"{launches}, expected {expect}")


def phase_test_split(t0, torch, np, train, inputs):
    """``run.py test`` from the ``train recipe`` work dir on the 4-item
    test split with ``test_ids=[0, 2, 3]`` and the fast samplers, then
    ``evaluate_dir`` of the generation dir with the speaker encoder's
    file, the mel kernel against its plain twin on a generated wav, and
    the bf16 MRF kernel against its plain twin on a ground-truth mel."""
    import csv

    from stylesinger_torch import run
    from stylesinger_torch.dsp.mel import load_wav, wav2spec
    from stylesinger_torch.eval.evaluate_gen import evaluate_dir

    cfg, work = inputs["cfg"], train["work"]
    fast = "test_ids=[{}],f0_speedup=5,dpm_steps=10".format(
        ",".join(map(str, TEST_IDS)))
    for ctr in counters().values():
        ctr.reset()
    torch.cuda.synchronize()
    ts = time.perf_counter()
    rc = run.main(["test", "--recipe", "stylesinger", "--hparams",
                   f"{inputs['hparams']},{fast}", "--exp_name", work.name,
                   "--work_dir_root", str(work.parent)])
    torch.cuda.synchronize()
    test_s = time.perf_counter() - ts
    launches = {k: c.count for k, c in counters().items()}
    gen = work / f"generated_{train['state'].step}"
    names = sorted(os.listdir(gen / "wavs")) if gen.is_dir() else []
    with open(gen / "meta.csv") as f:
        rows = list(csv.DictReader(f))
    f0s = np.load(gen / "result_f0s.npy", allow_pickle=True)
    # the recipe's MRF stages have C = 256 / 128 / 64 / 32 channels and a
    # widest reach of (11 - 1) * 5 = 50: stages 1-3 fit the kernel (C <=
    # 128, reach <= 64); each takes it with at least two 2048-sample blocks
    # and launches it once per dilation step (9).  So a ground-truth mel
    # (200-500 frames) launches it 27 times, a generated one of fewer than
    # 16 frames not at all.
    rates, block = cfg["upsample_rates"], cfg["mrf_block"]

    def mrf_launches(n):
        return 9 * sum(n * int(np.prod(rates[:i + 1])) >= 2 * block
                       for i in (1, 2, 3))

    gen_frames = [int(r["n_frames"]) for r in rows]
    gt = [inputs["test_items"][i] for i in TEST_IDS]
    gt_frames = [len(it["mel"]) for it in gt]
    want_gt = sum(map(mrf_launches, gt_frames))
    want_mrf = want_gt + sum(map(mrf_launches, gen_frames))
    say("test split run.py test", t0, rc=rc, items=len(rows),
        wavs=len(names), seconds=f"{test_s:.3f}",
        s_per_item=f"{test_s / max(len(rows), 1):.3f}",
        frames_generated=gen_frames, frames_gt=gt_frames,
        mrf_bf16_launches=launches["fused_mrf_blocks_bf16"],
        mrf_bf16_launches_expected=want_mrf,
        mel_launches=launches["mel_spectrogram"], samplers=fast)
    require(rc == 0 and len(rows) == 3 and len(f0s) == 3 and names == sorted(
        f"item_{i:04d}{s}.wav" for i in range(3) for s in ("", "_gt")),
            f"test split: run.py test (rc {rc}) wrote {names}")
    require(want_gt == 27 * len(TEST_IDS) and launches == dict(
        {k: 0 for k in counters()}, fused_mrf_blocks_bf16=want_mrf),
            f"test split: launches {launches}, expected {want_mrf} bf16 MRF")

    for ctr in counters().values():
        ctr.reset()
    torch.cuda.synchronize()
    te = time.perf_counter()
    summary = evaluate_dir(str(gen), sr=cfg["audio_sample_rate"], cfg=cfg,
                           spk_encoder_path=inputs["speaker_encoder_path"],
                           device="cuda")
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - te
    mel_launches = counters()["mel_spectrogram"].count
    with open(gen / "metrics.json") as f:
        items = json.load(f)["items"]
    finite = all(np.isfinite(r[k]) for r in items
                 for k in ("mcd", "ffe", "spk_cos"))
    wav = load_wav(str(gen / "wavs" / "item_0000.wav"),
                   cfg["audio_sample_rate"])
    mel = wav2spec(wav, torch.device("cuda"),
                   sample_rate=cfg["audio_sample_rate"],
                   n_fft=cfg["fft_size"], hop_size=cfg["hop_size"],
                   win_length=cfg["win_size"],
                   n_mels=cfg["audio_num_mel_bins"], fmin=cfg["fmin"],
                   fmax=cfg["fmax"])["mel"]
    mel_ok, mel_err = mel_against_plain(torch, np, cfg, wav, mel)
    say("test split evaluate_dir", t0, pairs=summary["n"],
        seconds=f"{eval_s:.3f}",
        s_per_pair=f"{eval_s / max(summary['n'], 1):.3f}",
        mcd_mean=f"{summary.get('mcd_mean', float('nan')):.4f}",
        ffe_mean=f"{summary.get('ffe_mean', float('nan')):.4f}",
        spk_cos_mean=f"{summary.get('spk_cos_mean', float('nan')):.6f}",
        mel_launches=mel_launches, mel_vs_plain_err=f"{mel_err:.3e}",
        mel_tol="atol3e-3/rtol2e-3", weights="12-step model, random GE2E")
    require(summary["n"] == 3 and mel_launches == 2 * 3,
            f"test split: {summary['n']} pairs, {mel_launches} mel launches")
    require(finite, f"test split: a metric is not finite {items}")
    require(mel_ok, f"test split: the mel kernel disagrees with its plain "
            f"twin on a generated wav ({mel_err:.3e})")

    # the bf16 MRF kernel at this path's own shapes (a ground-truth mel of
    # a few hundred frames: fewer blocks than SMs at stage 1)
    check = mrf_against_plain_bf16(torch, np, cfg, gt[0])
    say("test split gt vocoder vs plain bf16 twin", t0,
        frames=len(gt[0]["mel"]), stage_xb=[st[0] for st in check["stages"]],
        stage_err=[f"{st[1]:.3e}" for st in check["stages"]],
        stage_tol=[f"{st[2]:.3e}" for st in check["stages"]],
        wav_err=f"{check['err']:.3e}", max_abs_y=f"{check['scale']:.3e}",
        tol=f"{MRF_BF16_ULPS}ulp(max|y|)={check['tol']:.3e}")
    require(len(check["stages"]) == 3 and all(
        err <= tol for _, err, tol in check["stages"]),
        f"test split: the bf16 MRF kernel disagrees with its plain twin on "
        f"a ground-truth mel's stages {check['stages']}")
    require(check["err"] <= check["tol"], f"test split: the ground-truth "
            f"wav with the bf16 MRF kernel differs from the plain twin's by "
            f"{check['err']:.3e} > {check['tol']:.3e}")


# ------------------------------------------------------------- data prep

# common hanzi for the corpus's lyrics (each in the zh processor's table)
LYRIC_CHARS = ("我你他的是在了不有人这中大为上个国和地到以说时要就出会可也对"
               "生能而子那得于着下自之年过发后作里用道行所然家种事成方多经去"
               "法学如都同现当没动面起看定天分还进好小部其些主样理心她本前开"
               "但因只从想实日军者意无力它与长把机十民第公此已工使情明性知全"
               "三又关点正业外将两高间由问很最重并物手应战向头文体政美相见被"
               "月亮代表风花雪夜春秋歌唱梦光星海山河云雨爱情恋思念")
DATA_SINGERS = ("alto", "tenor", "soprano")   # soprano: the test singer
DATA_ITEMS = 32
DATA_VALID = ("alto_03", "tenor_04", "alto_09")  # valid_prefixes
F0_REL_TOL = 1e-3       # voiced F0, card against CPU (relative)
F0_VOICING_AGREE = 0.995
DVEC_TOL = 1e-4


def singing_corpus(np, root: Path, n: int, seed: int):
    """A raw corpus of ``n`` 48 kHz PCM16 mono items of 4-12 s by three
    singers under ``root/raw``: each a harmonic voice (8 partials,
    vibrato, note-wise envelope, a little noise) on a MIDI note (55-75)
    per phone, with hanzi ``txt`` and no ``ph``, whose ``ph_durs`` split
    the wav's length among the zh processor's phones, and GTSinger's MIDI
    streams.  Returns (raw dir, rows)."""
    from stylesinger_torch.dsp.mel import save_wav
    from stylesinger_torch.text_processors import get_txt_processor_cls

    rng = np.random.default_rng(seed)
    proc = get_txt_processor_cls("zh")
    sr = 48000
    raw = root / "raw"
    raw.mkdir(parents=True)
    rows = []
    for i in range(n):
        singer = DATA_SINGERS[i % 3]
        name = f"{singer}_{i:02d}"
        txt = "".join(rng.choice(list(LYRIC_CHARS),
                                 int(rng.integers(8, 25))))
        n_ph = len(proc.process(txt)[0])
        dur = float(rng.uniform(4.0, 12.0))
        w = rng.uniform(0.5, 1.5, n_ph)
        ph_durs = (w / w.sum() * dur).tolist()
        notes = rng.integers(55, 76, n_ph)
        t = np.arange(int(round(dur * sr))) / sr
        idx = np.minimum(np.searchsorted(np.cumsum(ph_durs), t,
                                         side="right"), n_ph - 1)
        f0 = 440.0 * 2 ** ((notes[idx] - 69) / 12) * (
            1 + 0.01 * np.sin(2 * np.pi * 5.5 * t))
        phase = 2 * np.pi * np.cumsum(f0) / sr
        amps = rng.uniform(0.2, 1.0, 8) / np.arange(1, 9)
        wav = sum(a * np.sin((h + 1) * phase) for h, a in enumerate(amps))
        onset = t - np.concatenate([[0.0], np.cumsum(ph_durs)])[idx]
        env = np.minimum(1.0, onset / 0.02) * np.minimum(
            1.0, np.minimum(t, dur - t) / 0.05)
        wav = 0.3 * wav * env / np.abs(wav).max() + \
            0.002 * rng.standard_normal(len(t))
        wav_fn = str(raw / f"{name}.wav")
        save_wav(wav.astype(np.float32), wav_fn, sr)
        rows.append(dict(item_name=name, txt=txt, wav_fn=wav_fn,
                         singer=singer, ph_durs=ph_durs,
                         ep_pitches=notes.tolist(), ep_notedurs=ph_durs,
                         ep_types=[2] * n_ph))
    with open(raw / "metadata.json", "w") as f:
        json.dump(rows, f, ensure_ascii=False)
    return raw, rows


def _shard_items(path):
    from stylesinger_torch.data.indexed_dataset import IndexedDataset

    ds = IndexedDataset(str(path))
    items = [ds[i] for i in range(len(ds))]
    ds.close()
    return items


def _float_diff(np, a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) -
                        np.asarray(b, np.float64)).max())


def phase_data_prep(t0, torch, np, root: Path):
    """Raw corpus -> ``metadata.json`` -> shards -> ``run.py train`` at the
    recipe's audio settings (48 kHz, fft 1024, hop 256, 80 mels, both GE2E
    encoders, ``with_wav`` / ``with_spk_embed`` / ``with_emotion`` /
    ``write_tsd`` on), with every check of the phase.  Returns the CLI's
    shard directory."""
    from stylesinger_torch import run
    from stylesinger_torch.config import load_config
    from stylesinger_torch.data import native_loader
    from stylesinger_torch.data.binarize import StyleSingingBinarizer
    from stylesinger_torch.data.preprocess import Preprocessor
    from stylesinger_torch.data.tsd_dataset import (
        PrefetchBatcher, TsdStyleSingerDataset,
    )
    from stylesinger_torch.dsp.mel import load_wav
    from stylesinger_torch.dsp.pitch import norm_interp_f0_np
    from stylesinger_torch.kernels import mel as melk

    data = root / "data"
    raw, rows = singing_corpus(np, data, DATA_ITEMS, SEED + 7)
    audio_s = sum(sum(r["ph_durs"]) for r in rows)
    keys = dict(
        raw_data_dir=str(raw),
        speaker_encoder_path=ge2e_file(torch, data / "pretrained.pt",
                                       SEED + 8),
        emotion_encoder_path=ge2e_file(torch, data / "global.pt", SEED + 9),
        test_prefixes=[DATA_SINGERS[2]], valid_prefixes=list(DATA_VALID))

    def cfg_for(side):
        return load_config(recipe="stylesinger", **keys,
                           processed_data_dir=str(data / side / "processed"),
                           binary_data_dir=str(data / side / "binary"))

    cfg = cfg_for("inproc")
    require(cfg["write_tsd"] and all(cfg["binarization_args"][k] for k in (
        "with_wav", "with_spk_embed", "with_emotion")),
        "data prep: the recipe's binarization switches are off")
    tb = time.perf_counter()
    native_loader.load_native()
    tsd_build_s = time.perf_counter() - tb
    say("data prep corpus", t0, items=len(rows), audio_s=f"{audio_s:.1f}",
        singers=len(DATA_SINGERS), test=DATA_SINGERS[2],
        valid=",".join(DATA_VALID), tsd_reader_build_s=f"{tsd_build_s:.2f}",
        built=native_loader.build_seconds() is not None)

    # -- preprocess and binarize in process, on the card
    tp = time.perf_counter()
    processed = Preprocessor(cfg).process(rows)
    pre_s = time.perf_counter() - tp
    for ctr in counters().values():
        ctr.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    tb = time.perf_counter()
    binarizer = StyleSingingBinarizer(cfg, device="cuda")
    binarizer.process()
    torch.cuda.synchronize()
    bin_s = time.perf_counter() - tb
    launches = {k: c.count for k, c in counters().items()}
    peak = torch.cuda.max_memory_allocated()
    binary = Path(cfg["binary_data_dir"])
    splits = {p: _shard_items(binary / p) for p in ("valid", "test", "train")}
    n_bin = sum(len(v) for v in splits.values())
    stages = {k: round(v, 3) for k, v in sorted(
        binarizer.stage_seconds.items())}
    say("data prep binarize", t0, preprocess_s=f"{pre_s:.2f}",
        binarize_s=f"{bin_s:.2f}", wavs=len(rows), items_binarized=n_bin,
        splits="/".join(f"{p}:{len(v)}" for p, v in splits.items()),
        items_per_s=f"{n_bin / bin_s:.3f}",
        audio_s_per_s=f"{sum(it['sec'] for v in splits.values() for it in v) / bin_s:.2f}",
        mel_launches=launches["mel_spectrogram"],
        mrf_launches=launches["fused_mrf_blocks"] +
        launches["fused_mrf_blocks_bf16"],
        peak_gib=f"{peak / 2 ** 30:.3f}",
        peak_above_start_gib=f"{(peak - before) / 2 ** 30:.3f}",
        stage_s=json.dumps(stages))
    # every item is binarized once per split it is in: the valid items are
    # in train too (train is every name not in test), as in JAX
    require(n_bin == len(rows) + len(DATA_VALID),
            f"data prep: {n_bin} items binarized")
    require(launches["mel_spectrogram"] == n_bin,
            f"data prep: {launches['mel_spectrogram']} mel launches for "
            f"{n_bin} items binarized")
    require(launches["fused_mrf_blocks"] + launches[
        "fused_mrf_blocks_bf16"] == 0, "data prep: the MRF kernel ran")
    for items in splits.values():
        for it in items:
            require(all(not isinstance(v, torch.Tensor) for v in it.values())
                    and it["mel"].shape == (it["len"], 80)
                    and it["mel"].dtype == np.float32
                    and it["mel2ph"].dtype == np.int64
                    and np.isfinite(it["mel"]).all()
                    and np.isfinite(it["f0"]).all()
                    and it["spk_embed"].shape == it["emo_embed"].shape
                    == (256,) and (it["f0"] > 0).mean() > 0.5
                    and it["mel2ph"].max() == len(it["ph_token"]),
                    f"data prep: item {it['item_name']} is malformed")

    # -- the card against the CPU on 4 items
    by_name = {it["item_name"]: it for it in splits["train"]}
    pick = sorted(by_name)[:4]
    cpu_cfg = cfg_for("cpu")
    cpu_cfg["test_prefixes"] = cpu_cfg["valid_prefixes"] = []
    cpu_processed = Path(cpu_cfg["processed_data_dir"])
    cpu_processed.mkdir(parents=True)
    with open(cpu_processed / "metadata.json", "w") as f:
        json.dump([r for r in processed if r["item_name"] in pick], f,
                  ensure_ascii=False)
    (cpu_processed / "phone_set.json").write_bytes(
        (Path(cfg["processed_data_dir"]) / "phone_set.json").read_bytes())
    tc = time.perf_counter()
    StyleSingingBinarizer(cpu_cfg, device="cpu").process()
    cpu_s = time.perf_counter() - tc
    worst = dict(mel=0.0, f0_rel=0.0, dvec=0.0, voicing=1.0)
    mel_ok = True
    for it in _shard_items(Path(cpu_cfg["binary_data_dir"]) / "train"):
        card = by_name[it["item_name"]]
        for k in ("ph_token", "mel2ph", "len", "wav", "sec"):
            require(np.array_equal(np.asarray(card[k]), np.asarray(it[k])),
                    f"data prep: {k} of {it['item_name']} differs on the "
                    "card")
        mel_ok &= bool(np.allclose(card["mel"], it["mel"], **MEL_TOL))
        worst["mel"] = max(worst["mel"], _float_diff(np, card["mel"],
                                                     it["mel"]))
        va, vb = card["f0"] > 0, it["f0"] > 0
        worst["voicing"] = min(worst["voicing"], float((va == vb).mean()))
        both = va & vb
        worst["f0_rel"] = max(worst["f0_rel"], float(np.max(
            np.abs(card["f0"][both] - it["f0"][both]) / it["f0"][both])))
        for k in ("spk_embed", "emo_embed"):
            worst["dvec"] = max(worst["dvec"], _float_diff(np, card[k],
                                                           it[k]))
    say("data prep card vs cpu", t0, items=len(pick), cpu_s=f"{cpu_s:.2f}",
        mel_err=f"{worst['mel']:.3e}", mel_tol="atol3e-3/rtol2e-3",
        voicing_agree=f"{worst['voicing']:.4f}",
        voicing_min=F0_VOICING_AGREE, f0_rel_err=f"{worst['f0_rel']:.3e}",
        f0_rel_tol=F0_REL_TOL, dvec_err=f"{worst['dvec']:.3e}",
        dvec_tol=DVEC_TOL)
    require(mel_ok, f"data prep: the card's mel differs from the CPU's by "
            f"{worst['mel']:.3e}")
    require(worst["voicing"] >= F0_VOICING_AGREE and
            worst["f0_rel"] <= F0_REL_TOL and worst["dvec"] <= DVEC_TOL,
            f"data prep: card against CPU {worst}")

    # -- the mel kernel against its twin at the corpus's shortest and
    #    longest items, with its time per call there
    lengths = sorted((sum(r["ph_durs"]), r["wav_fn"]) for r in rows)
    for label, (_, wav_fn) in (("shortest", lengths[0]),
                               ("longest", lengths[-1])):
        wav = torch.as_tensor(load_wav(wav_fn, 48000), device="cuda")
        consts = melk._constants(48000, 1024, 1024, 80, 20.0, 24000.0,
                                 wav.device)
        kw = dict(sample_rate=48000, n_fft=1024, hop_size=256,
                  win_length=1024, n_mels=80, fmin=20.0, fmax=24000.0)
        call = functools.partial(melk.mel_spectrogram, wav, **kw)
        plain = functools.partial(melk.mel_spectrogram_plain, wav, *consts,
                                  256, 1e-6)
        out, ref = call(), plain()
        err = float((out - ref).abs().max())
        ok = bool(torch.allclose(out, ref, **MEL_TOL))
        ms, plain_ms = time_ms(torch, call), time_ms(torch, plain)
        torch.cuda.synchronize()
        n_frames = out.shape[0]
        flops = n_frames * (2.5 * 1024 * math.log2(1024) + 2.0 * 513 * 80)
        nbytes = 4.0 * (wav.numel() + 1024 + 513 * 80 + n_frames * 80)
        b_ms, b_by = bound_ms(flops, nbytes)
        say(f"data prep mel {label}", t0, frames=n_frames,
            max_abs_err=f"{err:.3e}", ok=ok, ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", bound_ms=f"{b_ms:.5f}",
            bound_by=b_by)
        require(ok, f"data prep: the mel kernel disagrees at {n_frames} "
                f"frames ({err:.3e})")

    # -- TSD read-back through the C++ reader
    c = cfg
    for prefix, items in splits.items():
        reader = native_loader.TsdReader(str(binary / prefix))
        require(len(reader) == len(items), f"data prep: {prefix}.tsidx "
                f"holds {len(reader)} items")
        for i, it in enumerate(items):
            for k, v in it.items():
                # the writer stores a scalar as a 1-element array, as JAX's
                arr = np.atleast_1d(np.asarray(v))
                if arr.dtype.kind in "USO" or isinstance(v, bool):
                    continue
                require(np.array_equal(reader.field(i, k), arr),
                        f"data prep: TSD {prefix}[{i}].{k} differs")
            f0, uv = norm_interp_f0_np(it["f0"], pitch_norm=c["pitch_norm"],
                                       use_uv=c["use_uv"],
                                       f0_mean=c["f0_mean"],
                                       f0_std=c["f0_std"])
            require(np.array_equal(reader.field(i, "f0_norm"), f0) and
                    np.array_equal(reader.field(i, "uv"), uv),
                    f"data prep: TSD {prefix}[{i}] f0_norm / uv differ")
        reader.close()
    batch_ms = {}
    for plain in (False, True):
        ds = TsdStyleSingerDataset(c, str(binary / "train"), plain=plain)
        idx_batches = PrefetchBatcher(ds, c)._index_batches(0)
        ds.batch(idx_batches[0])
        tb = time.perf_counter()
        for _ in range(3):
            for idxs in idx_batches:
                ds.batch(idxs)
        batch_ms["plain" if plain else "cpp"] =             1e3 * (time.perf_counter() - tb) / (3 * len(idx_batches))
    th = time.perf_counter()
    n_batches = 0
    for batch in PrefetchBatcher(TsdStyleSingerDataset(
            c, str(binary / "train")), c, device="cuda").batches(0):
        require(all(v.is_cuda for v in batch.values()),
                "data prep: a prefetched batch is not on the card")
        n_batches += 1
    torch.cuda.synchronize()
    say("data prep tsd", t0, splits=len(splits), batches=len(idx_batches),
        batch_ms_cpp=f"{batch_ms['cpp']:.3f}",
        batch_ms_plain=f"{batch_ms['plain']:.3f}",
        epoch_to_card_ms=f"{1e3 * (time.perf_counter() - th):.1f}",
        epoch_batches=n_batches)

    # -- once through the CLI, into a second directory
    cli = cfg_for("cli")
    hp = ",".join(f"{k}={json.dumps(v) if isinstance(v, list) else v}"
                  for k, v in dict(keys, processed_data_dir=cli[
                      "processed_data_dir"], binary_data_dir=cli[
                      "binary_data_dir"]).items())
    for cmd in (["preprocess"], ["binarize", "--device", "cuda"]):
        tc = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "stylesinger_torch.run", *cmd,
             "--recipe", "stylesinger", "--hparams", hp], cwd=str(REPO),
            capture_output=True, text=True, timeout=600)
        require(out.returncode == 0, f"data prep: run.py {cmd[0]} failed: "
                f"{out.stderr[-2000:]}")
        say(f"data prep cli {cmd[0]}", t0,
            seconds=f"{time.perf_counter() - tc:.2f}")
    cli_binary = Path(cli["binary_data_dir"])
    require(sorted(os.listdir(cli_binary)) == sorted(os.listdir(binary)),
            "data prep: the CLI wrote other files")
    # the same device, weights and inputs: the floats should be bit for
    # bit; a last-bit difference would come from a library choosing
    # another algorithm per process, so they are held at 1e-5
    bit_exact, close, diffs = True, True, {}
    for prefix, items in splits.items():
        for a, b in zip(_shard_items(cli_binary / prefix), items):
            require(sorted(a) == sorted(b), "data prep: CLI item keys differ")
            for k in a:
                if k in ("mel", "f0", "spk_embed", "emo_embed"):
                    diffs[k] = max(diffs.get(k, 0.0),
                                   _float_diff(np, a[k], b[k]))
                    bit_exact &= bool(np.array_equal(a[k], b[k]))
                    close &= bool(np.allclose(a[k], b[k], rtol=1e-5,
                                              atol=1e-5))
                elif k != "wav_fn":
                    require(np.array_equal(np.asarray(a[k]),
                                           np.asarray(b[k])),
                            f"data prep: CLI {prefix} {k} differs")
    say("data prep cli vs in-process", t0, bit_exact=bit_exact,
        max_abs_diff=json.dumps({k: f"{v:.3e}" for k, v in diffs.items()}),
        tol="atol1e-5/rtol1e-5")
    require(close, f"data prep: the CLI's shards differ from the in-process "
            f"ones {diffs}")

    # -- train on the CLI's shards
    work = data / "work"
    for ctr in counters().values():
        ctr.reset()
    tt = time.perf_counter()
    rc = run.main(["train", "--recipe", "stylesinger", "--hparams",
                   f"binary_data_dir={cli_binary},max_updates=4,"
                   "tb_log_interval=1,val_check_interval=4",
                   "--exp_name", "port_shards", "--work_dir_root",
                   str(work)])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - tt
    train_launches = {k: v.count for k, v in counters().items()}
    with open(work / "port_shards" / "metrics.jsonl") as f:
        metrics = [json.loads(line) for line in f]
    train_rows = [m for m in metrics if m["prefix"] == "train"]
    losses = {k: v for m in metrics for k, v in m.items()
              if k not in ("step", "prefix", "steps_per_sec")}
    ckpts = sorted(os.listdir(work / "port_shards" / "ckpt"))
    say("data prep train", t0, rc=rc, steps=len(train_rows),
        step_ms=",".join(f"{1e3 / m['steps_per_sec']:.1f}"
                         for m in train_rows),
        total_loss=",".join(f"{m['total_loss']:.4f}" for m in train_rows),
        seconds=f"{train_s:.2f}", ckpt=",".join(ckpts),
        launches=json.dumps(train_launches),
        note="acoustic training launches neither kernel")
    require(rc == 0 and len(train_rows) == 4 and ckpts and
            all(math.isfinite(v) for v in losses.values()),
            f"data prep: training on the port's shards failed "
            f"(rc {rc}, {len(train_rows)} steps, {ckpts})")
    require(not any(train_launches.values()),
            f"data prep: training launched a kernel {train_launches}")
    return cli_binary


# ---------------------------------------------------------------------------
# 9. the other model families and the convert CLI
# ---------------------------------------------------------------------------

FAMILY_TOL = 1e-4   # card against CPU, of max(1, max|ref|): f32, TF32 off


def _rel_err(a, b) -> float:
    """max|a - b| over max(1, max|b|), on the CPU."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    if a.shape != b.shape:
        return float("inf")
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def fs2_batch(torch, np, cfg, n, frames, phones, device, seed=SEED):
    """A seeded FastSpeech2 / PitchExtractor batch on ``device``: phones of
    ``frames // phones`` frames each, the last phone and its frames of
    every second item padding, normalized log-f0, uv, energy, d-vectors
    and mels."""
    rng = np.random.default_rng(seed)
    m = cfg["audio_num_mel_bins"]
    txt = rng.integers(1, 60, (n, phones))
    txt[1::2, -1] = 0
    mel2ph = np.repeat(np.arange(1, phones + 1),
                       frames // phones)[None].repeat(n, 0)
    mel2ph[1::2][mel2ph[1::2] == phones] = 0
    frame = (mel2ph > 0).astype(np.float32)
    out = dict(
        txt_tokens=txt, mel2ph=mel2ph,
        spk_embed=rng.standard_normal((n, 256)).astype(np.float32),
        f0=rng.uniform(7.0, 8.5, (n, frames)).astype(np.float32),
        uv=(rng.uniform(size=(n, frames)) < 0.3).astype(np.float32) * frame,
        energy=rng.uniform(0.0, 3.99, (n, frames)).astype(np.float32),
        mels=((rng.standard_normal((n, frames, m)) * 0.5 - 3) *
              frame[..., None]).astype(np.float32),
        is_sil=(rng.uniform(size=(n, phones)) < 0.1).astype(np.float32))
    return {k: torch.as_tensor(v).to(device) for k, v in out.items()}


def family_step_pair(torch, np, cfg, build, make_step, batch):
    """One step of a tiny model (``build()``) on the CPU and on the card
    from the same weights and batch, the dropout drawn on the CPU and
    replayed on the card: (worst loss error, worst gradient leaf error
    over its tolerance, that leaf, the losses)."""
    from stylesinger_torch.training import fs2_task
    from stylesinger_torch.training.step import Optimizer, TrainState

    cpu = fs2_task.init_fs2_state(build(), cfg, seed=SEED)
    first = {k: v.clone() for k, v in cpu.model.state_dict().items()}
    rec = _Recorder(SEED)
    m_cpu = make_step(cfg)(cpu, batch, drop=rec)
    model = build()
    model.load_state_dict(first)
    gpu = TrainState(model.cuda(), Optimizer(dict(model.named_parameters()),
                                             cfg))
    m_gpu = make_step(cfg)(
        gpu, {k: v.cuda() for k, v in batch.items()},
        drop=_Replay(rec.draws, "cuda"))
    torch.cuda.synchronize()
    errs = [abs(float(m_gpu[k]) - float(v)) / max(1.0, abs(float(v)))
            for k, v in m_cpu.items()]
    worst, name = grad_err_over_tol(cpu, gpu)
    return max(errs), worst, name, m_cpu


def timed_steps(torch, step, state, batch, n):
    """``n`` steps, each timed on the host clock between synchronizes: ms
    per step and the last step's losses."""
    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        tb = time.perf_counter()
        m = step(state, batch)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - tb))
    return ms, m


def _reset_counts():
    for ctr in counters().values():
        ctr.reset()


def _no_kernel(phase):
    launches = {k: c.count for k, c in counters().items()}
    require(not any(launches.values()),
            f"{phase}: a kernel of the path was launched {launches}")
    return sum(launches.values())


def phase_fs2(t0, torch, np, smi):
    """FastSpeech2: the tiny model's inference pass and one train step on
    the card against the CPU; then at ``load_config()``'s width one
    inference pass (predicted durations, up to ``max_frames``) and 3
    train steps on 8 x 1024 frames x 128 phones."""
    from stylesinger_torch.config import load_config, tiny_test_config
    from stylesinger_torch.inference import init_random_
    from stylesinger_torch.models.fs2 import FastSpeech2
    from stylesinger_torch.training import fs2_task

    tiny = tiny_test_config(use_energy_embed=True)
    batch = fs2_batch(torch, np, tiny, 2, 32, 8, "cpu")

    def build():
        return FastSpeech2(tiny, 60, out_dims=tiny["audio_num_mel_bins"])

    cpu = build()
    init_random_(cpu, torch.Generator().manual_seed(SEED))
    gpu = build()
    gpu.load_state_dict(cpu.state_dict())
    gpu.cuda()
    with torch.no_grad():
        ref = cpu(batch["txt_tokens"], None, batch["spk_embed"], infer=True)
        out = gpu(batch["txt_tokens"].cuda(), None,
                  batch["spk_embed"].cuda(), infer=True)
    infer_err = max(_rel_err(out[k], ref[k]) for k in
                    ("mel_out", "dur", "f0_denorm", "energy_pred"))
    same_mel2ph = bool(torch.equal(out["mel2ph"].cpu(), ref["mel2ph"]))
    loss_err, worst, at, m = family_step_pair(
        torch, np, tiny, build, fs2_task.make_fs2_train_step, batch)
    say("fs2 small", t0, infer_err=f"{infer_err:.2e}", mel2ph_equal=
        same_mel2ph, frames=int((ref["mel2ph"] > 0).sum()),
        step_loss_err=f"{loss_err:.2e}", tol=f"{FAMILY_TOL:g}",
        losses=len(m) - 1, worst_grad_err_over_tol=f"{worst:.3f}", at=at)
    require(same_mel2ph and infer_err <= FAMILY_TOL,
            f"fs2 small: card and CPU differ ({infer_err})")
    require(loss_err <= FAMILY_TOL and worst <= 1.0,
            f"fs2 small: train step differs ({loss_err}, {worst} at {at})")

    cfg = load_config()
    big = fs2_batch(torch, np, cfg, 8, 1024, 128, "cuda")
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    model = FastSpeech2(cfg, 60, out_dims=cfg["audio_num_mel_bins"]).cuda()
    state = fs2_task.init_fs2_state(model, cfg, seed=SEED)
    model.eval()
    with torch.no_grad():
        infer_ms = time_ms(torch, lambda: model(
            big["txt_tokens"], None, big["spk_embed"], infer=True), iters=3)
    model.train()
    ms, m = timed_steps(torch, fs2_task.make_fs2_train_step(cfg),
                        state, big, 3)
    peak = torch.cuda.max_memory_allocated()
    params = sum(p.numel() for p in model.parameters())
    say("fs2", t0, gpu=repr(smi), params=params, batch="8x1024x128",
        infer_ms=f"{infer_ms:.2f}", step_ms=",".join(f"{x:.1f}" for x in ms),
        total_loss=f"{float(m['total_loss']):.4f}",
        peak_gib=f"{peak / 2 ** 30:.2f}", launches=_no_kernel("fs2"))
    require(all(math.isfinite(float(v)) for v in m.values()),
            "fs2: a non-finite loss")


def phase_pe(t0, torch, np, smi):
    """PitchExtractor: one tiny train step on the card against the CPU,
    then 3 steps at the default width (``predictor_layers`` 5) on the
    ``fs2`` phase's mels."""
    from stylesinger_torch.config import load_config, tiny_test_config
    from stylesinger_torch.models.pe import PitchExtractor
    from stylesinger_torch.training import fs2_task

    tiny = tiny_test_config()
    batch = fs2_batch(torch, np, tiny, 2, 32, 8, "cpu")
    batch = {k: batch[k] for k in ("mels", "f0", "uv")}
    loss_err, worst, at, m = family_step_pair(
        torch, np, tiny, lambda: PitchExtractor(tiny),
        fs2_task.make_pe_train_step, batch)
    say("pe small", t0, step_loss_err=f"{loss_err:.2e}",
        tol=f"{FAMILY_TOL:g}", worst_grad_err_over_tol=f"{worst:.3f}", at=at)
    require(loss_err <= FAMILY_TOL and worst <= 1.0,
            f"pe small: train step differs ({loss_err}, {worst} at {at})")

    cfg = load_config()
    big = fs2_batch(torch, np, cfg, 8, 1024, 128, "cuda")
    big = {k: big[k] for k in ("mels", "f0", "uv")}
    _reset_counts()
    model = PitchExtractor(cfg).cuda()
    state = fs2_task.init_fs2_state(model, cfg, seed=SEED)
    ms, m = timed_steps(torch, fs2_task.make_pe_train_step(cfg),
                        state, big, 3)
    say("pe", t0, gpu=repr(smi), batch="8x1024x80",
        layers=cfg["predictor_layers"],
        step_ms=",".join(f"{x:.1f}" for x in ms),
        total_loss=f"{float(m['total_loss']):.4f}",
        launches=_no_kernel("pe"))
    require(all(math.isfinite(float(v)) for v in m.values()),
            "pe: a non-finite loss")


def phase_legacy_vocoders(t0, torch, np, smi, wav_np):
    """PWG, MelGAN and PQMF: tiny generators and the filter bank on the
    card against the CPU (same weights and noise); then the wrappers at
    their defaults (PWG 30 layers / 3 stacks / 64-128-64 channels, scales
    4·4·4·4; MelGAN 512 base channels, 8·8·2·2) on the reference clip's
    mel, and PQMF analysis then synthesis of the clip."""
    from stylesinger_torch.config import load_config, tiny_test_config
    from stylesinger_torch.dsp.mel import wav2spec
    from stylesinger_torch.inference import init_random_
    from stylesinger_torch.models import legacy_vocoders as lv
    from stylesinger_torch.vocoder_infer import get_vocoder_cls

    tiny = tiny_test_config(pwg_upsample_scales=[4, 4],
                            melgan_upsample_scales=[4, 2])
    g = torch.Generator().manual_seed(SEED)
    mel = torch.randn((2, 12, tiny["audio_num_mel_bins"]), generator=g)
    noise = torch.randn((2, 12 * 16, 1), generator=g)
    pitch = torch.randint(1, 256, (2, 12), generator=g)
    errs = {}
    for name, build, args in (
            ("pwg", lambda: lv.ParallelWaveGANGenerator(
                tiny, layers=6, stacks=3, residual_channels=8,
                gate_channels=16, skip_channels=8), (mel, noise)),
            ("pwg_pitch", lambda: lv.ParallelWaveGANGenerator(
                tiny, layers=6, stacks=3, residual_channels=8,
                gate_channels=16, skip_channels=8, use_pitch_embed=True),
             (mel, noise, pitch)),
            ("melgan", lambda: lv.MelGANGenerator(tiny, base_channels=32),
             (mel,))):
        cpu = build()
        init_random_(cpu, torch.Generator().manual_seed(SEED), conv_std=0.1)
        gpu = build()
        gpu.load_state_dict(cpu.state_dict())
        with torch.no_grad():
            errs[name] = _rel_err(gpu.cuda()(*(a.cuda() for a in args)),
                                  cpu(*args))
    wav = torch.as_tensor(wav_np[:48000])[None]
    pq = lv.PQMF()
    pq_gpu = lv.PQMF().cuda()
    errs["pqmf_analysis"] = _rel_err(pq_gpu.analysis(wav.cuda()),
                                     pq.analysis(wav))
    errs["pqmf_synthesis"] = _rel_err(
        pq_gpu.synthesis(pq_gpu.analysis(wav.cuda())),
        pq.synthesis(pq.analysis(wav)))
    say("legacy vocoders small", t0, tol=f"{FAMILY_TOL:g}",
        **{f"{k}_err": f"{v:.2e}" for k, v in errs.items()})
    require(all(v <= FAMILY_TOL for v in errs.values()),
            f"legacy vocoders small: card and CPU differ {errs}")

    cfg = load_config()
    clip_mel = wav2spec(wav_np, "cuda", sample_rate=cfg["audio_sample_rate"],
                        n_fft=cfg["fft_size"], hop_size=cfg["hop_size"],
                        win_length=cfg["win_size"],
                        n_mels=cfg["audio_num_mel_bins"], fmin=cfg["fmin"],
                        fmax=cfg["fmax"])["mel"].cpu().numpy()
    frames = clip_mel.shape[0]
    f0 = np.full(frames, 220.0, np.float32)
    _reset_counts()
    fields = {}
    for name in ("PWG", "MelGAN"):
        c = load_config()
        c["vocoder"] = name
        voc = get_vocoder_cls(c)(c, device="cuda", seed=SEED)
        wav = voc.spec2wav(clip_mel, f0=f0)
        require(wav.shape == (frames * cfg["hop_size"],) and
                np.isfinite(wav).all(), f"{name}: wav {wav.shape}")
        ms = time_ms(torch, lambda: voc.spec2wav(clip_mel, f0=f0), iters=3)
        fields[f"{name.lower()}_ms"] = f"{ms:.2f}"
        fields[f"{name.lower()}_params"] = sum(
            p.numel() for p in voc.model.parameters())
    clip = torch.as_tensor(wav_np, device="cuda")[None]
    pq = lv.PQMF().cuda()
    back = pq.synthesis(pq.analysis(clip))
    n = clip.shape[1] // 4 * 4
    recon = float((back[:, 1000:n - 1000] - clip[:, 1000:n - 1000]).abs()
                  .max())
    ms = time_ms(torch, lambda: pq.synthesis(pq.analysis(clip)), iters=5)
    fields["pqmf_ms"] = f"{ms:.3f}"
    say("legacy vocoders", t0, gpu=repr(smi), frames=frames,
        samples=frames * cfg["hop_size"], pqmf_recon_err=f"{recon:.2e}",
        launches=_no_kernel("legacy vocoders"), **fields)
    require(recon < 0.05, f"PQMF does not reconstruct the clip ({recon})")


def phase_diffnet_variants(t0, torch, np, smi):
    """F0DiffNet and MDiffNet: tiny on the card against the CPU, then one
    forward each at 10 layers x 192 channels over 1024 frames, which runs
    each residual layer on the layer kernel (10 launches)."""
    from stylesinger_torch.inference import init_random_
    from stylesinger_torch.kernels import diffnet as dk
    from stylesinger_torch.models.diffnet import F0DiffNet, MDiffNet

    def inputs(device, t, cond_dim, uv, seed=SEED):
        g = torch.Generator().manual_seed(seed)
        x = torch.randint(0, 2, (2, t), generator=g) if uv else \
            torch.randn((2, t, 1), generator=g)
        cond = torch.randn((2, t, cond_dim), generator=g)
        mask = torch.ones((2, t))
        mask[1, -t // 4:] = 0
        return tuple(a.to(device) for a in (x, torch.tensor([3, 71]), cond,
                                            mask))

    errs, fields = {}, {}
    for name, cls in (("f0diffnet", F0DiffNet), ("mdiffnet", MDiffNet)):
        cpu = cls(cond_dim=12, residual_layers=3, residual_channels=8)
        init_random_(cpu, torch.Generator().manual_seed(SEED), conv_std=0.2)
        gpu = cls(cond_dim=12, residual_layers=3, residual_channels=8)
        gpu.load_state_dict(cpu.state_dict())
        uv = cls is MDiffNet
        with torch.no_grad():
            errs[name] = _rel_err(gpu.cuda()(*inputs("cuda", 24, 12, uv)),
                                  cpu(*inputs("cpu", 24, 12, uv)))
        big = cls(cond_dim=256, residual_layers=10,
                  residual_channels=192).cuda()
        init_random_(big, torch.Generator().manual_seed(SEED), conv_std=0.05)
        args = inputs("cuda", 1024, 256, uv)
        _reset_counts()
        dk.counter.reset()
        with torch.no_grad():
            out = big(*args)
            layers = dk.counter.count
            ms = time_ms(torch, lambda: big(*args), iters=10)
            fields[f"{name}_ms"] = f"{ms:.3f}"
            fields[f"{name}_diffnet_launches"] = layers
        require(bool(torch.isfinite(out).all()), f"{name}: non-finite")
        require(layers == 10, f"{name}: {layers} layer-kernel launches")
        _no_kernel(name)
    say("diffnet variants", t0, gpu=repr(smi), tol=f"{FAMILY_TOL:g}",
        frames=1024, **{f"{k}_small_err": f"{v:.2e}" for k, v in errs.items()},
        **fields)
    require(all(v <= FAMILY_TOL for v in errs.values()),
            f"diffnet variants: card and CPU differ {errs}")


def phase_convert_cli(t0, torch, np, root: Path, wav_np):
    """``python -m stylesinger_torch.convert`` on a reference-layout
    ``.ckpt`` of a seeded tiny model (written by
    ``tests/reference_layout.py``, which needs no JAX), in its own process;
    ``load_params`` of the work dir it writes on the card, against the
    seeded weights; one request on the card."""
    sys.path.insert(0, str(REPO / "tests"))
    from reference_layout import flax_tree, reference_stylesinger_sd

    from stylesinger_torch.config import save_config, tiny_test_config

    cfg = tiny_test_config(hop_size=64, mrf_block=64)
    phones = sorted(set(EXAMPLE["ph"].split()))
    src = make_infer(cfg, phones, "cpu", SEED, frames=6)
    ckpt = root / "reference" / "model_ckpt_steps_300.ckpt"
    ckpt.parent.mkdir()
    torch.save({"state_dict": {"model": reference_stylesinger_sd(
        flax_tree(src.model))}, "global_step": 300}, str(ckpt))
    cfg_path = save_config(cfg, str(root / "reference"))
    work = root / "converted"
    tc = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "stylesinger_torch.convert", str(ckpt),
         str(work), "--config", cfg_path], cwd=str(REPO),
        capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - tc
    require(out.returncode == 0,
            f"convert cli: failed: {out.stderr[-2000:]}")
    gpu = make_infer(cfg, phones, "cuda", SEED, frames=6)
    with torch.no_grad():
        for p in gpu.model.parameters():
            p.zero_()
    gpu.load_params(str(work))
    ref = src.model.state_dict()
    err = max(_rel_err(v, ref[k]) for k, v in gpu.model.state_dict().items())
    _reset_counts()
    wav = gpu.infer_once(dict(cut(EXAMPLE, 6), ref_audio=wav_np[:48000]))
    launches = {k: c.count for k, c in counters().items()}
    say("convert cli", t0, seconds=f"{seconds:.2f}",
        wrote=(work / "ckpt" / "model_ckpt_steps_300.pt").exists(),
        weight_err=f"{err:.2e}", tol="1e-6", wav_samples=len(wav),
        mel_launches=launches["mel_spectrogram"],
        mrf_launches=launches["fused_mrf_blocks"])
    require(err <= 1e-6, f"convert cli: loaded weights differ ({err})")
    require(len(wav) > 0 and np.isfinite(wav).all(),
            "convert cli: the request gave no finite wav")
    require(launches["mel_spectrogram"] == 1,
            "convert cli: the request did not launch the mel kernel once")


def mrf_against_plain_bf16(torch, np, cfg, item):
    """The trained generator (``vocoder_ckpt``, bf16) on ``item``'s mel
    and f0, on the card, twice: through the MRF kernel, recording each
    kernel-routed stage's inputs and output, and with the plain bf16 twin
    in the kernel's place.  Returns each stage's (xb shape, max abs error
    against the twin on the same inputs, 2 bf16 ulps of the twin's
    max|y|), and the two wavs' max abs difference, max|y| and tolerance."""
    from stylesinger_torch.kernels import mrf as mrfk
    from stylesinger_torch.models import hifigan
    from stylesinger_torch.vocoder_infer import get_vocoder_cls

    voc = get_vocoder_cls(cfg)(cfg, device="cuda")
    stages = []

    def recorded(xb, mask, weights, **kw):
        out = mrfk.fused_mrf_blocks(xb, mask, weights, **kw)
        stages.append((xb, mask, weights, kw, out))
        return out

    def twin(xb, mask, weights, compute_dtype, **kw):
        return mrfk.mrf_blocks_plain_bf16(xb, mask, weights, **kw)

    try:
        hifigan.fused_mrf_blocks = recorded
        y = voc.spec2wav(item["mel"], f0=item["f0"])
        hifigan.fused_mrf_blocks = twin
        y_twin = voc.spec2wav(item["mel"], f0=item["f0"])
    finally:
        hifigan.fused_mrf_blocks = mrfk.fused_mrf_blocks
    per_stage = []
    for xb, mask, weights, kw, out in stages:
        kw = {k: v for k, v in kw.items() if k != "compute_dtype"}
        with torch.no_grad():
            ref = mrfk.mrf_blocks_plain_bf16(xb, mask, weights, **kw).float()
        err = float((out.float() - ref).abs().max())
        per_stage.append((tuple(xb.shape), err, MRF_BF16_ULPS * ulp_bf16(
            float(ref.abs().max()))))
    scale = float(np.abs(y_twin).max())
    return dict(stages=per_stage, err=float(np.abs(y - y_twin).max()),
                scale=scale, tol=MRF_BF16_ULPS * ulp_bf16(scale))


def mel_against_plain(torch, np, cfg, wav, mel):
    """(agrees, max abs error) of ``mel``, the mel kernel's log-mel of
    ``wav`` on the card, against the plain twin on the same wav, at the
    mel tolerance."""
    from stylesinger_torch.kernels import mel as melk

    dev = mel.device
    consts = melk._constants(cfg["audio_sample_rate"], cfg["fft_size"],
                             cfg["win_size"], cfg["audio_num_mel_bins"],
                             cfg["fmin"], cfg["fmax"], dev)
    ref = melk.mel_spectrogram_plain(
        torch.as_tensor(np.asarray(wav, np.float32), device=dev), *consts,
        cfg["hop_size"], 1e-6)
    if mel.shape != ref.shape:
        return False, float("inf")
    return (bool(torch.allclose(mel, ref, **MEL_TOL)),
            float((mel - ref).abs().max()))


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
        diffnet, diffnet_timed = phase_diffnet(t0, torch, recipe)
        kernels = [mel, mrf, mrf16, diffnet]
        launches, infer, again = phase_requests(t0, torch, np, cfg, recipe,
                                                wav_np)
        phase_streaming(t0, torch, np, infer, wav_np)
        phase_small(t0, torch, np, wav_np)
        phase_train_small(t0, torch, np)
        with tempfile.TemporaryDirectory(prefix=".chip_smoke_",
                                         dir=str(REPO)) as tmp:
            root = Path(tmp)
            train = phase_train_recipe(t0, torch, np, root)
            phase_train_bf16(t0, torch, np, root, train)
            phase_train_dispatch(t0, torch, np, smi)
            phase_settings(t0, torch, np)
            phase_data_parallel(t0, torch, np, root)
            phase_model_parallel(t0, torch, np, root)
            phase_vocoder_gan_small(t0, torch, np)
            generator = phase_vocoder_gan(t0, torch, np, root)
            phase_vocoder_gan_dispatch(t0, torch, np, smi)
            inputs = serve_inputs(torch, np, root, train, generator, wav_np)
            phase_checkpoint_infer(t0, torch, np, train, inputs, wav_np)
            phase_test_split(t0, torch, np, train, inputs)
            del train
            binary = phase_data_prep(t0, torch, np, root)
            phase_recipe_file(t0, torch, np, root, binary)
            phase_fs2(t0, torch, np, smi)
            phase_pe(t0, torch, np, smi)
            phase_legacy_vocoders(t0, torch, np, smi, wav_np)
            phase_diffnet_variants(t0, torch, np, smi)
            phase_convert_cli(t0, torch, np, root, wav_np)
            phase_serving_export(t0, torch, np, dict(
                recipe, f0_speedup=5, dpm_steps=10), "dpm10_f0fast5",
                wav_np, root)
        phase_device(t0, torch, mel_timed + mrf_timed + mrf16_timed +
                     diffnet_timed)
        again(label="breakdown recipe request 0 after profiling")
        phase_dispatch_timing(t0, torch, np, smi)
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    for k in kernels:  # the requests' launches
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
