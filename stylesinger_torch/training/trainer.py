"""The training loop (port of ``stylesinger_tpu/training/trainer.py``).

:meth:`Trainer.fit` runs optimizer steps to ``max_updates`` through the
curriculum: every ``tb_log_interval`` steps it writes the window's mean
losses, steps/s and the host's resident memory to
``<work_dir>/metrics.jsonl`` (and to TensorBoard when ``tensorboardX`` is
importable) and stops on a non-finite loss; every ``val_check_interval``
steps it validates, saves a checkpoint and, every
``valid_infer_interval`` steps, renders the first validation batch's
inference (``valid_plots/``).  It resumes from the latest checkpoint, can
warm-start from another run's weights (``load_ckpt``, a non-strict merge),
and on Ctrl-C finishes the step (or window) it is in, saves a checkpoint
and raises ``KeyboardInterrupt``: a step changes the model's codebook
buffers and the optimizer's state in place, so a checkpoint is only taken
between steps.

Two ways to dispatch steps, as in JAX:

- ``steps_per_dispatch`` 1 (or ``profile_step`` >= 0): one step per batch
  of the stream, the next ``prefetch_batches`` batches made ready by a
  thread (:class:`BatchPrefetcher`); ``profile_step`` traces a window of
  ``profile_n_steps`` steps with ``torch.profiler`` into
  ``<work_dir>/profile`` and prints a per-op table;
- ``steps_per_dispatch`` > 1: one epoch is padded to a common shape and
  put on the device (:meth:`Trainer._stack_batches`, within
  ``device_data_budget_mb``, else the stream per step), visited in the
  order of a permutation seeded per epoch (:func:`batch_index`), in
  windows that stop at every log, validation and curriculum boundary
  (:meth:`Trainer._window_len`), each window through
  ``step.make_train_scan``: a CUDA graph replay per step on the card, the
  same step eagerly on the CPU.

``debug_nans`` traps the first non-finite value (:func:`trap_nans`).  The
host-RSS watchdog (``max_host_rss_gb`` > 0) checkpoints and raises
:class:`HostMemoryExceeded` at a log boundary; ``run.py train`` exits 75
on it and ``run.py train --supervise`` restarts.  JAX arms it by itself
(``max_host_rss_gb`` 0) only on a remote-PJRT backend, which the port has
not, so 0 is off here.

Under a process group (``parallel/mesh.py``, one process per device) each
step is one step on the global batch; rank 0 alone writes metrics and
checkpoints and runs validation (on the whole valid split, as JAX's
``BucketBatcher`` without a rank split gives it).  ``steps_per_dispatch``
> 1 is refused there.

Of the JAX trainer only the ``model`` mesh axis is not ported.
"""

from __future__ import annotations

import contextlib
import json
import os
import queue
import signal
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from stylesinger_torch.inference import resolve_device
from stylesinger_torch.models import precision
from stylesinger_torch.models.diffusion import Noise
from stylesinger_torch.parallel import mesh
from stylesinger_torch.training.checkpoint import (
    CheckpointManager, latest_checkpoint, load_payload,
)
from stylesinger_torch.training.schedules import check_diff_start_lr
from stylesinger_torch.training.step import (
    Phase, TrainState, batch_to_device, eval_step, init_state,
    make_train_scan, phase_boundaries, phase_for_step, train_step,
)


class HostMemoryExceeded(RuntimeError):
    """Host RSS crossed ``max_host_rss_gb``; a checkpoint was saved first,
    so that the caller can exit with a restartable status (``run.py
    train`` exits 75 and ``--supervise`` restarts and resumes) instead of
    being killed by the kernel mid-save."""


def host_rss_gb() -> float:
    """Resident-set size of this process in GB (Linux; 0.0 if unknown)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / (1024 * 1024)
    except OSError:
        pass
    return 0.0


def resolve_rss_limit_gb(cfg_value: Optional[float]) -> float:
    """``max_host_rss_gb``: > 0 a GB ceiling; otherwise off (inf).  JAX's
    0 arms at 85 % of MemTotal on a remote-PJRT backend only; the port
    has none."""
    if cfg_value is None or cfg_value <= 0:
        return float("inf")
    return float(cfg_value)


def warm_start_params(model: nn.Module, load_path: str) -> List[str]:
    """Copy into ``model`` every tensor of another run whose name and shape
    match (its parameters and RQ buffers; the reference's non-strict
    ``load_ckpt``).  ``load_path`` is a checkpoint file or a work dir
    (its latest checkpoint).  Returns what was dropped."""
    if os.path.isdir(load_path):
        latest = latest_checkpoint(load_path)
        if latest is None:
            raise FileNotFoundError(
                f"load_ckpt: no checkpoint under {load_path}/ckpt")
        load_path = latest[1]
    loaded = load_payload(load_path)["model"]
    target = model.state_dict()
    merged, dropped = {}, []
    for k, v in loaded.items():
        if k not in target:
            dropped.append(f"{k} (unknown key)")
        elif tuple(v.shape) != tuple(target[k].shape):
            dropped.append(f"{k} (shape {tuple(v.shape)} vs "
                           f"{tuple(target[k].shape)})")
        else:
            merged[k] = v
    model.load_state_dict(merged, strict=False)
    print(f"| warm-start from {load_path}: {len(merged)}/{len(loaded)} "
          "tensors loaded")
    for d in dropped[:20]:
        print(f"|   dropped {d}")
    if len(dropped) > 20:
        print(f"|   ... and {len(dropped) - 20} more")
    return dropped


def numeric(batch: Dict) -> Dict:
    """The array fields of a collated batch, ``nsamples`` left out."""
    return {k: v for k, v in batch.items()
            if isinstance(v, (np.ndarray, torch.Tensor)) and k != "nsamples"}


class _BatchStream:
    """The batches of ``train_batches`` as tensors on ``device``, epoch
    after epoch (re-iterated at its end)."""

    def __init__(self, train_batches: Iterable[Dict], device: torch.device):
        self._source = train_batches
        self._it = iter(train_batches)
        self.device = device

    def _next_host(self) -> Dict:
        try:
            return next(self._it)
        except StopIteration:
            self._it = iter(self._source)
            batch = next(self._it, None)
            if batch is None:
                raise ValueError(
                    f"rank {mesh.rank()}: an epoch gives no batch (fewer "
                    f"batches than the {mesh.world_size()} process(es))")
            return batch

    def next(self) -> Dict[str, torch.Tensor]:
        return batch_to_device(self._next_host(), self.device)

    def close(self) -> None:
        pass


class BatchPrefetcher(_BatchStream):
    """A thread that makes the next ``depth`` batches ready while the step
    runs (JAX's ``_BatchPrefetcher``; the reference's DataLoader workers):
    the host batch to tensors and, on the card, pinned and copied to the
    device on a side stream, which the consumer's stream waits for.  The
    same batches in the same order as :class:`_BatchStream`."""

    def __init__(self, train_batches: Iterable[Dict], device: torch.device,
                 depth: int = 2):
        super().__init__(train_batches, device)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stream = torch.cuda.Stream(device) if device.type == "cuda" \
            else None
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _prep(self, batch: Dict) -> Tuple[Dict[str, torch.Tensor], Any]:
        host = batch_to_device(batch, "cpu")
        if self._stream is None:
            return host, None
        with torch.cuda.stream(self._stream):
            out = {k: v.pin_memory().to(self.device, non_blocking=True)
                   for k, v in host.items()}
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return out, ready

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                self._q.put(self._prep(self._next_host()))
        except BaseException as e:  # raised on the consumer's side
            self._err = e
            self._q.put(None)

    def next(self) -> Dict[str, torch.Tensor]:
        item = self._q.get()
        if item is None:
            raise self._err  # type: ignore[misc]
        out, ready = item
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for v in out.values():
                v.record_stream(stream)
        return out

    def close(self) -> None:
        self._stop.set()
        while self._t.is_alive():  # unblock a producer on a full queue
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._t.join(timeout=0.05)


def batch_index(t: int, n_b: int, seed: int,
                cache: Optional[Dict[int, np.ndarray]] = None) -> int:
    """The batch of the device-resident epoch that global step ``t``
    trains on: epoch ``t // n_b`` visits the ``n_b`` batches in the order
    of ``default_rng(seed + epoch).permutation(n_b)`` (JAX's
    ``batch_index``), so a resumed run lands on the same stream.
    ``cache`` keeps the current epoch's permutation."""
    cache = {} if cache is None else cache
    epoch = t // n_b
    if epoch not in cache:
        cache.clear()
        cache[epoch] = np.random.default_rng(seed + epoch).permutation(n_b)
    return int(cache[epoch][t % n_b])


def _tensors(out: Any):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)
    elif isinstance(out, dict):
        for o in out.values():
            yield from _tensors(o)


@contextlib.contextmanager
def trap_nans(model: nn.Module, on: bool = True):
    """``debug_nans`` (JAX's ``jax_debug_nans``): while active, every
    module of ``model`` checks its floating outputs and raises
    ``FloatingPointError`` at the first non-finite value, naming the
    module, and autograd's anomaly mode raises at a backward that returns
    one.  Each check reads the device from the host."""
    if not on:
        yield
        return

    def check(name, module, inputs, output):
        for t in _tensors(output):
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                raise FloatingPointError(
                    f"debug_nans: a non-finite value in the output of "
                    f"{name or type(module).__name__} "
                    f"({type(module).__name__})")

    handles = [m.register_forward_hook(
        lambda mod, i, o, name=name: check(name, mod, i, o))
        for name, m in model.named_modules()]
    try:
        with torch.autograd.set_detect_anomaly(True):
            yield
    finally:
        for h in handles:
            h.remove()


class MetricsWriter:
    """Rows of ``{"step", "prefix", <metric>: value}`` appended to
    ``<work_dir>/metrics.jsonl``, and scalars, images and audio to
    TensorBoard (``<work_dir>/tb``) when ``tensorboardX`` is importable;
    on ranks other than 0 it writes nothing."""

    def __init__(self, work_dir: str):
        self._f = None
        self._tb = None
        if mesh.rank() != 0:
            return
        os.makedirs(work_dir, exist_ok=True)
        self._f = open(os.path.join(work_dir, "metrics.jsonl"), "a")
        try:  # optional, as in JAX
            from tensorboardX import SummaryWriter  # type: ignore
            self._tb = SummaryWriter(os.path.join(work_dir, "tb"))
        except Exception:
            pass

    def write(self, step: int, metrics: Dict[str, Any],
              prefix: str = "train") -> None:
        if self._f is None:
            return
        row = {"step": step, "prefix": prefix,
               **{k: float(v) for k, v in metrics.items()}}
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(f"{prefix}/{k}", float(v), step)

    def write_image(self, tag: str, image, step: int) -> None:
        """image: [H, W, C] uint8 or float array."""
        if self._tb is not None and image is not None:
            try:
                self._tb.add_image(tag, np.asarray(image), step,
                                   dataformats="HWC")
            except Exception:
                pass

    def write_audio(self, tag: str, wav, step: int,
                    sample_rate: int) -> None:
        """wav: 1-D float array in [-1, 1], encoded as 16-bit WAV with the
        standard library (tensorboardX's own ``add_audio`` needs
        soundfile)."""
        if self._tb is None or wav is None:
            return
        try:
            import io
            import wave

            from tensorboardX.proto.summary_pb2 import Summary

            pcm = (np.clip(np.asarray(wav, np.float32), -1.0, 1.0) *
                   32767.0).astype("<i2")
            buf = io.BytesIO()
            with wave.open(buf, "wb") as f:
                f.setnchannels(1)
                f.setsampwidth(2)
                f.setframerate(sample_rate)
                f.writeframes(pcm.tobytes())
            audio = Summary.Audio(
                sample_rate=sample_rate, num_channels=1,
                length_frames=len(pcm), encoded_audio_string=buf.getvalue(),
                content_type="audio/wav")
            self._tb._get_file_writer().add_summary(
                Summary(value=[Summary.Value(tag=tag, audio=audio)]), step)
        except Exception:
            pass

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
        if self._tb is not None:
            self._tb.close()


class Trainer:
    """Drives :func:`train_step` for a model on ``device`` (``cuda`` unless
    the caller asks for the CPU; raises when CUDA is asked for and absent;
    ``cuda:LOCAL_RANK`` under a process group).  Raises on a
    ``compute_dtype`` other than float32 / bfloat16 and on a
    ``mesh_shape`` with a ``model`` axis.  ``mesh`` (``parallel.mesh.
    make_mesh``) becomes the process's mesh, as JAX's ``Trainer(mesh=)``:
    the batch splits over its ``data`` axis (the caller's ``EpochBatches``
    split by ``mesh.data_rank()``), the model is replicated (a model split
    by ``shard_params`` raises).  ``vocoder`` (an object with
    ``spec2wav(mel, f0=...)``) adds the validation dump's audio;
    ``noise_fn(step)`` replaces each training step's noise sources
    (``step.step_noise``), on both dispatch paths.  ``scan``
    (``step.make_train_scan``) runs the windows of ``steps_per_dispatch``
    > 1 and keeps the last fit's graphs and device epoch (``scan.graphs``)
    until a fit binds it to another state."""

    def __init__(self, model: nn.Module, cfg: Any, work_dir: str,
                 device: Any = "cuda", vocoder: Optional[Any] = None,
                 noise_fn: Optional[Callable[[int], Dict[str, Any]]] = None,
                 mesh: Optional[Any] = None):
        from stylesinger_torch.parallel import mesh as _mesh  # the argument

        self.model = model
        self.cfg = cfg
        self.work_dir = work_dir
        self.device = _mesh.local_device(resolve_device(device))
        precision.parse(cfg.get("compute_dtype", "float32"))
        if mesh is not None:
            _mesh.use_mesh(mesh)
        if _mesh.split_dims(model):
            raise ValueError(
                "Trainer: the model is split over a model axis "
                "(shard_params); the trainer shards the batch over the data "
                "axis only, as the JAX package's does: step a split model "
                "with training.step.train_step")
        _mesh.check_mesh_shape(cfg.get("mesh_shape"))
        self.ckpt = CheckpointManager(
            work_dir, keep=cfg["num_ckpt_keep"], save_best=cfg["save_best"],
            milestone_interval=cfg.get("milestone_interval", 0))
        self.metrics = MetricsWriter(work_dir)
        self.vocoder = vocoder
        self.noise_fn = noise_fn
        self.state: Optional[TrainState] = None
        self.scan = make_train_scan(cfg, noise_fn)

    def init_state(self) -> TrainState:
        """Seeded weights, then the latest checkpoint if there is one, else
        the ``load_ckpt`` warm start."""
        state = init_state(self.model.to(self.device), self.cfg)
        state, start = self.ckpt.restore(state)
        if start == 0 and self.cfg.get("load_ckpt", ""):
            warm_start_params(state.model, self.cfg["load_ckpt"])
        return state

    def fit(self, train_batches: Iterable[Dict],
            valid_batches_fn: Optional[Callable[[], Iterable[Dict]]] = None,
            max_updates: Optional[int] = None) -> TrainState:
        """Train to ``max_updates`` (default ``cfg["max_updates"]``).
        ``train_batches`` is re-iterated at the end of each epoch (with
        ``steps_per_dispatch`` > 1, one epoch of it is put on the device);
        ``valid_batches_fn()`` gives a fresh validation iterator."""
        c = self.cfg
        max_updates = max_updates or c["max_updates"]
        check_diff_start_lr(c)
        state = self.state = self.init_state()
        self._stop = False
        previous = None
        if threading.current_thread() is threading.main_thread():
            previous = signal.signal(signal.SIGINT, self._on_sigint)
        try:
            with trap_nans(state.model, c.get("debug_nans", False)):
                self._train_loop(train_batches, state, max_updates,
                                 valid_batches_fn)
        finally:
            if previous is not None:
                signal.signal(signal.SIGINT, previous)
        return state

    def _on_sigint(self, signum, frame) -> None:
        self._stop = True

    def _check_stop(self, state: TrainState) -> None:
        if self._stop:
            print(f"| KeyboardInterrupt: saving checkpoint at step "
                  f"{state.step}")
            if mesh.rank() == 0:
                self.ckpt.save(state.step, state)
            raise KeyboardInterrupt

    def _noise(self, step: int) -> Optional[Dict[str, Any]]:
        return None if self.noise_fn is None else self.noise_fn(step)

    def _train_loop(self, train_batches, state: TrainState,
                    max_updates: int, valid_batches_fn) -> None:
        c = self.cfg
        if c.get("steps_per_dispatch", 1) > 1 and \
                c.get("profile_step", -1) < 0:
            if mesh.distributed():
                raise ValueError(
                    "steps_per_dispatch > 1 under a process group: each "
                    "rank would put its own epoch on its device and index "
                    "it by one schedule, which is not one global batch "
                    "per step (the JAX package's multi-process device_put "
                    "of per-process arrays has the same fault); use "
                    "steps_per_dispatch=1")
            if c.get("debug_nans", False) and self.device.type == "cuda":
                raise ValueError(
                    "debug_nans reads every module's output on the host, "
                    "which a CUDA graph cannot; use steps_per_dispatch=1")
            stacked = self._stack_batches(train_batches)
            if stacked is not None:
                self._train_loop_scan(stacked, state, max_updates,
                                      valid_batches_fn)
                return
        default_prefetch = 2 if (os.cpu_count() or 1) > 1 else 0
        depth = c.get("prefetch_batches", default_prefetch)
        batches = BatchPrefetcher(train_batches, self.device, depth) \
            if depth > 0 else _BatchStream(train_batches, self.device)
        try:
            self._train_loop_steps(batches, state, max_updates,
                                   valid_batches_fn)
        finally:
            batches.close()

    def _train_loop_steps(self, batches: _BatchStream, state: TrainState,
                          max_updates: int, valid_batches_fn) -> None:
        c = self.cfg
        profile_at = c.get("profile_step", -1)
        n_profiled = c.get("profile_n_steps", 5)
        rss_limit = resolve_rss_limit_gb(c.get("max_host_rss_gb", 0.0))
        window: Dict[str, list] = {}
        prof = None
        t0 = time.time()
        try:
            while state.step < max_updates:
                self._check_stop(state)
                batch = batches.next()
                step = state.step
                phase = phase_for_step(step, c)
                if step == profile_at:
                    prof = self._start_profile()
                m = train_step(state, batch, phase, c,
                               noise=self._noise(step))
                if prof is not None and step == profile_at + n_profiled:
                    self._stop_profile(prof, n_profiled)
                    prof = None
                for k, v in m.items():
                    window.setdefault(k, []).append(v)
                t0 = self._log_val_save(state, phase, window, t0, rss_limit,
                                        valid_batches_fn)
        finally:
            if prof is not None:
                prof.stop()

    def _start_profile(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        return prof

    def _stop_profile(self, prof, n_steps: int) -> None:
        """Stop the traced window (JAX's: from ``profile_step`` to
        ``profile_step + profile_n_steps``, both included), write its
        trace to ``<work_dir>/profile`` and print the per-op table, time
        per step over ``profile_n_steps``, then the device's idle seconds
        by span (``train.forward`` / ``backward`` / ``optimizer``)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        trace_dir = os.path.join(self.work_dir, "profile")
        try:
            from stylesinger_torch.utils.profiling import (
                export_trace, format_idle, format_table, idle_by_span,
                latest_trace, parse_trace,
            )
            export_trace(prof, trace_dir)
            tf = latest_trace(trace_dir)
            if tf:
                rows = parse_trace(tf)
                for r in rows:
                    r["per_iter_us"] = r["total_us"] / n_steps
                print(format_table(rows, top=15))
                print(format_idle(idle_by_span(tf)))
        except Exception as e:  # never break training over a trace
            print(f"| profile table unavailable: {e}")

    def _log_val_save(self, state: TrainState, phase: Phase,
                      window: Dict[str, list], t0: float, rss_limit: float,
                      valid_batches_fn) -> float:
        """Per boundary, for both dispatch paths: the window's metrics and
        steps/s, the host-RSS watchdog, the non-finite-loss trap, and
        validation with a checkpoint at the validation cadence.  ``phase``
        is the just-completed step's (a scan window never crosses a
        curriculum boundary).  Returns the (possibly reset) window start
        time."""
        c = self.cfg
        step = state.step
        if step % c["tb_log_interval"] == 0:
            logged = self._drain_window(window)
            logged["steps_per_sec"] = c["tb_log_interval"] / max(
                time.time() - t0, 1e-9)
            rss = host_rss_gb()
            logged["host_rss_gb"] = rss
            t0 = time.time()
            self.metrics.write(step, logged, "train")
            window.clear()
            if not np.isfinite(logged.get("total_loss", 0.0)):
                raise FloatingPointError(
                    f"non-finite loss at step {step}: {logged}")
            if rss > rss_limit:
                print(f"| host RSS {rss:.1f} GB > limit {rss_limit:.1f} GB: "
                      f"checkpointing at step {step} and exiting for "
                      "restart")
                if mesh.rank() == 0:
                    self.ckpt.save(step, state)
                raise HostMemoryExceeded(
                    f"host RSS {rss:.1f} GB exceeded {rss_limit:.1f} GB at "
                    f"step {step} (checkpoint saved; resume-safe)")
        if step % c["val_check_interval"] == 0 and mesh.rank() == 0:
            val_loss = None
            if valid_batches_fn is not None:
                val_loss = self.validate(state, valid_batches_fn(), step,
                                         phase)
            self.ckpt.save(step, state, val_loss)
        return t0

    # ------------------------------------------------ multi-step dispatch
    def _stack_batches(self, train_batches
                       ) -> Optional[Tuple[Dict[str, torch.Tensor], int]]:
        """One epoch of ``train_batches`` on the device as one batch dict
        with a leading batch-index axis (JAX's ``_stack_batches``): each
        field zero-padded to the epoch's largest size in each dimension
        (padded sentences are all-zero rows, masked downstream by
        ``txt_tokens == 0`` / ``mel2ph == 0``), the batch dimension rounded
        up to a multiple of the processes (1: the path refuses a process
        group).  Returns None, to stream per step, when the epoch exceeds
        ``device_data_budget_mb`` (checked while it is read, so that an
        endless source stops early) or has a scalar field."""
        budget = float(self.cfg.get("device_data_budget_mb", 1024))
        batches, got_bytes = [], 0
        for b in iter(train_batches):
            b = numeric(b)
            batches.append(b)
            got_bytes += sum(np.asarray(v).nbytes for v in b.values())
            if got_bytes / 1e6 > budget:
                print(f"| steps_per_dispatch: epoch exceeds "
                      f"device_data_budget_mb {budget:.0f} after "
                      f"{len(batches)} batches; streaming per-step")
                return None
        if not batches:
            return None
        keys = sorted(set.intersection(*(set(b) for b in batches)))
        if any(np.asarray(b[k]).ndim == 0 for b in batches for k in keys):
            return None  # scalar fields: the per-step path
        dims: Dict[str, list] = {}
        for b in batches:
            for k in keys:
                a = np.asarray(b[k])
                dims.setdefault(k, [0] * a.ndim)
                dims[k] = [max(m, s) for m, s in zip(dims[k], a.shape)]
        n_dev = mesh.world_size()
        dims = {k: [v[0] + (-v[0]) % n_dev] + v[1:] for k, v in dims.items()}
        total_mb = sum(
            len(batches) * int(np.prod(d)) *
            np.asarray(batches[0][k]).dtype.itemsize
            for k, d in dims.items()) / 1e6
        if total_mb > budget:
            print(f"| steps_per_dispatch: epoch is {total_mb:.0f} MB > "
                  f"device_data_budget_mb {budget:.0f}; streaming per-step")
            return None

        def pad_to(a, shape):
            widths = [(0, t - s) for s, t in zip(a.shape, shape)]
            return np.pad(a, widths) if any(w for _, w in widths) else a

        stacked = batch_to_device(
            {k: np.stack([pad_to(np.asarray(b[k]), dims[k])
                          for b in batches]) for k in keys}, self.device)
        print(f"| steps_per_dispatch="
              f"{self.cfg.get('steps_per_dispatch', 1)}: {len(batches)} "
              f"batches ({total_mb:.0f} MB) device-resident")
        return stacked, len(batches)

    def _window_len(self, step: int, max_updates: int) -> int:
        """The longest window from ``step`` that stays inside one
        curriculum phase and ends on the log and validation boundaries."""
        c = self.cfg
        w = min(int(c.get("steps_per_dispatch", 1)), max_updates - step)
        for interval in (c["tb_log_interval"], c["val_check_interval"]):
            w = min(w, interval - step % interval)
        for b in phase_boundaries(c):
            if b > step:
                w = min(w, b - step)
        return max(w, 1)

    def _train_loop_scan(self, stacked_n, state: TrainState,
                         max_updates: int, valid_batches_fn) -> None:
        """Windows of steps over the device-resident epoch
        (``self.scan``, ``step.make_train_scan``); the batch schedule is a
        function of the global step (:func:`batch_index`), so resume lands
        on the same stream."""
        c = self.cfg
        stacked, n_b = stacked_n
        rss_limit = resolve_rss_limit_gb(c.get("max_host_rss_gb", 0.0))
        perm_cache: Dict[int, np.ndarray] = {}
        window: Dict[str, list] = {}
        t0 = time.time()
        while state.step < max_updates:
            self._check_stop(state)
            w = self._window_len(state.step, max_updates)
            order = [batch_index(t, n_b, c["seed"], perm_cache)
                     for t in range(state.step, state.step + w)]
            phase = phase_for_step(state.step, c)
            m = self.scan(state, stacked, order, phase)
            for k, v in m.items():
                window.setdefault(k, []).append(v)
            t0 = self._log_val_save(state, phase, window, t0, rss_limit,
                                    valid_batches_fn)

    @staticmethod
    def _drain_window(window: Dict[str, list]) -> Dict[str, float]:
        """The mean of each metric over the window, with one copy from the
        device; an entry is a step's scalar or a scan window's [W]
        vector."""
        keys = sorted(window)
        flat = [v.float().reshape(-1) for k in keys for v in window[k]]
        if not flat:
            return {}
        vals = torch.cat(flat).cpu().numpy()
        logged, i = {}, 0
        for k in keys:
            n = sum(int(v.numel()) for v in window[k])
            logged[k] = float(vals[i:i + n].mean())
            i += n
        return logged

    def validate(self, state: TrainState, batches: Iterable[Dict],
                 step: int, phase: Phase) -> float:
        """The mean validation losses, written to ``metrics.jsonl``;
        every ``valid_infer_interval`` steps also the first batch's
        inference dump (a failure there is printed, not raised).  Returns
        the mean ``total_loss``."""
        sums: Dict[str, float] = {}
        n = 0
        first = None
        for batch in batches:
            batch = batch_to_device(batch, self.device)
            if first is None:
                first = batch
            losses = eval_step(state, batch, phase, self.cfg)
            for k, v in losses.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
        avg = {k: v / max(n, 1) for k, v in sums.items()}
        self.metrics.write(step, avg, "valid")
        if first is not None and \
                step % self.cfg.get("valid_infer_interval", 5000) == 0:
            try:
                self._dump_valid_artifacts(state, first, step)
            except Exception as e:  # plots must never stop training
                print(f"| valid plot failed: {e}")
        return avg.get("total_loss", 0.0)

    def _dump_valid_artifacts(self, state: TrainState,
                              batch: Dict[str, torch.Tensor],
                              step: int) -> None:
        """The first validation item's inference (the config's samplers,
        draws seeded from ``seed``) as a mel figure, ``valid_plots/
        mel_<step>.png`` (``.npy`` without matplotlib's image writer), an
        f0 figure to TensorBoard and, with a vocoder,
        ``valid_plots/wav_<step>.wav`` (JAX's ``_dump_valid_artifacts``,
        the reference's media summaries)."""
        from stylesinger_torch.dsp.mel import save_wav
        from stylesinger_torch.utils.plot import (
            f0_to_figure, figure_to_image, spec_to_figure,
        )

        out_dir = os.path.join(self.work_dir, "valid_plots")
        os.makedirs(out_dir, exist_ok=True)
        spk = batch["spk_id"] if "spk_id" in batch else batch["spk_embed"]
        with torch.no_grad():
            ret = state.model(
                batch["txt_tokens"], spk, batch.get("emo_embed"),
                batch["mels"], batch["f0"], batch["notes"],
                batch["note_durs"], batch["note_types"],
                Noise(self.cfg["seed"], self.device),
                max_frames=int(batch["mels"].shape[1]), infer=True,
                use_diff=True)
        mel = ret["mel_out"][0].float().cpu().numpy()
        f0 = ret["f0_denorm"][0].float().cpu().numpy()
        n = int((ret["mel2ph"][0] > 0).sum())
        img = figure_to_image(spec_to_figure(mel[: max(n, 1)],
                                             title=f"step {step}"))
        try:
            import matplotlib.pyplot as plt  # noqa: F401
            import imageio  # type: ignore
            imageio.imwrite(os.path.join(out_dir, f"mel_{step}.png"), img)
        except Exception:
            np.save(os.path.join(out_dir, f"mel_{step}.npy"),
                    mel[: max(n, 1)])
        self.metrics.write_image("valid/mel", img, step)
        f0_img = figure_to_image(f0_to_figure(f0[: max(n, 1)]))
        self.metrics.write_image("valid/f0", f0_img, step)
        if self.vocoder is not None and n > 0:
            wav = self.vocoder.spec2wav(mel[:n], f0=f0[:n])
            save_wav(wav, os.path.join(out_dir, f"wav_{step}.wav"),
                     self.cfg["audio_sample_rate"])
            self.metrics.write_audio("valid/wav", wav, step,
                                     self.cfg["audio_sample_rate"])
        self.metrics.flush()
