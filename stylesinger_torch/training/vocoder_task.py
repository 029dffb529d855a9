"""NSF HiFi-GAN vocoder training: the adversarial discriminator and
generator steps (port of ``stylesinger_tpu/training/vocoder_task.py`` and
of the training loop of ``tools/validate_vocoder.py``).

- :class:`VocoderState`: the generator, the MPD and MSD discriminators,
  one optimizer for each side (optax's ``adamw`` or ``radam`` at
  ``vocoder_lr``, ``vocoder_adam_b1``, ``vocoder_adam_b2``) and the step;
- :func:`make_vocoder_bodies`: ``disc_step`` (the generator's wav without a
  gradient, the LSGAN discriminator loss on MPD + MSD) and ``gen_step``
  (adversarial + ``lambda_fm`` x feature matching + ``lambda_mel`` x the
  mel L1 of :func:`~stylesinger_torch.dsp.mel.wav2mel_batch`, + the PWG
  multi-resolution STFT loss when ``lambda_ms_stft`` > 0);
- randomness: both passes of step n draw the generator's NSF noise from
  their own ``Noise`` seeded from (seed, n, "noise"), so they see the same
  noise, as JAX gives both the same key; the on-device crops draw from
  (seed, n, "crop");
- :func:`make_vocoder_scan`: several iterations over a device-resident
  corpus (:func:`stack_corpus`) with the crops drawn on the device, each a
  replay of one CUDA graph on the card; :func:`crop_batch`: the host
  crops, numpy, as JAX's;
- :func:`fit_vocoder`: the loop that trains, resumes, saves the state and
  writes the trained generator for ``vocoder_ckpt``.

Under autograd the generator runs every MRF group on the resblock modules
(the MRF kernel has no backward); the discriminator step's generator pass
runs without a gradient, so on the card it launches the MRF kernel, as an
inference request does.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from stylesinger_torch.dsp.mel import wav2mel_batch
from stylesinger_torch.inference import init_random_, resolve_device
from stylesinger_torch.models.diffusion import Noise
from stylesinger_torch.models.hifigan import (
    HifiGanGenerator, MultiPeriodDiscriminator, MultiScaleDiscriminator,
    discriminator_loss, feature_matching_loss, generator_adv_loss,
)
from stylesinger_torch.training.checkpoint import _save, load_payload
from stylesinger_torch.training.graphs import GraphedSteps, stack_steps
from stylesinger_torch.training.losses import multi_resolution_stft_loss
from stylesinger_torch.training.step import (
    DeviceScalars, adam_direction, adam_moments_, apply_update_,
    bias_corrections, stream_seed, write_scalars,
)
from stylesinger_torch.vocoder_infer import GAN_STATE_FILE, GENERATOR_FILE

NOISE_STREAMS = ("noise", "crop")
ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default, on every parameter
RADAM_THRESHOLD = 5.0
LOG_INTERVAL = 500    # fit_vocoder's, as tools/validate_vocoder.py's
SAVE_INTERVAL = 5000


class GanOptimizer:
    """optax ``adamw(lr, b1, b2)`` (eps 1e-8, eps_root 0, weight decay 1e-4)
    or ``radam(lr, b1, b2)`` (eps 1e-8 after the bias correction, the
    rectified step where rho >= 5, else the bias-corrected momentum), at a
    constant learning rate, with no clipping.  A parameter without a
    gradient counts as a zero gradient.  The moments are updated in place;
    an update's host scalars (:meth:`scalars`) reach the device as a
    tensor (``step.DeviceScalars``), or in a buffer the caller writes,
    which a CUDA graph of the step reads; RAdam's branch on rho stays on
    the host (:meth:`graph_key`)."""

    def __init__(self, named_params: Dict[str, nn.Parameter], cfg: Any):
        self.kind = cfg["vocoder_optimizer"]
        if self.kind not in ("adamw", "radam"):
            raise ValueError(f"vocoder_optimizer {self.kind!r}: adamw or "
                             "radam")
        self.names = list(named_params)
        self.lr = float(cfg["vocoder_lr"])
        self.b1 = float(cfg["vocoder_adam_b1"])
        self.b2 = float(cfg["vocoder_adam_b2"])
        self.eps = 1e-8
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in named_params.values()]
        self.nu = [torch.zeros_like(p) for p in named_params.values()]
        self._scalars = DeviceScalars(3)

    def _rho(self, count: int):
        """RAdam's rho at ``count`` and its rectification term, in f32 as
        optax's ``scale_by_radam`` computes them (the term is 0.0 below the
        threshold, where the step is the bias-corrected momentum)."""
        f32 = np.float32
        ro_inf = 2.0 / (1.0 - self.b2) - 1.0
        b2t = f32(self.b2) ** f32(count)
        ro = f32(ro_inf) - f32(2 * count) * b2t / (f32(1.0) - b2t)
        if ro < RADAM_THRESHOLD:
            return ro, 0.0
        return ro, float(np.sqrt((ro - f32(4.0)) * (ro - f32(2.0)) * f32(
            ro_inf) / (f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro)))

    def scalars(self) -> tuple:
        """(c1, c2, RAdam's rectification term) of the next update, as
        Python floats."""
        count = self.count + 1
        return bias_corrections(count, self.b1, self.b2) + (
            self._rho(count)[1] if self.kind == "radam" else 0.0,)

    def graph_key(self) -> tuple:
        """What the next update branches on on the host: RAdam's rho
        against the threshold."""
        return (self.kind == "radam"
                and self._rho(self.count + 1)[0] >= RADAM_THRESHOLD,)

    @torch.no_grad()
    def step(self, params: List[torch.Tensor],
             grads: Sequence[Optional[torch.Tensor]],
             scalars: Optional[torch.Tensor] = None) -> None:
        """Updates ``params`` in place.  ``scalars``: a [3] device buffer
        holding :meth:`scalars`, written by the caller (a captured step);
        None: written here."""
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        (rectified,) = self.graph_key()
        if scalars is None:
            scalars = self._scalars.write(self.scalars(), params[0].device)
        c1, c2, r = scalars.unbind()
        self.count += 1
        adam_moments_(self.mu, self.nu, grads, self.b1, self.b2)
        if self.kind == "adamw":
            upd = adam_direction(self.mu, self.nu, c1, c2, self.eps)
            apply_update_(params, upd, self.lr, ADAMW_WEIGHT_DECAY)
            return
        mu_hat = torch._foreach_div(self.mu, c1)
        if rectified:
            mu_hat = torch._foreach_div(
                torch._foreach_mul(mu_hat, r),
                torch._foreach_add(torch._foreach_sqrt(
                    torch._foreach_div(self.nu, c2)), self.eps))
        apply_update_(params, mu_hat, self.lr)

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.count = int(sd["count"])
        for key in ("mu", "nu"):
            setattr(self, key, [sd[key][n].to(t.device, t.dtype).clone()
                                for n, t in zip(self.names,
                                                getattr(self, key))])


def _disc_named(mpd: nn.Module, msd: nn.Module) -> Dict[str, nn.Parameter]:
    return {**{f"mpd.{k}": v for k, v in mpd.named_parameters()},
            **{f"msd.{k}": v for k, v in msd.named_parameters()}}


@dataclass
class VocoderState:
    """Both sides of the GAN, their optimizers and the number of
    iterations taken (each a discriminator step and a generator step)."""
    gen: HifiGanGenerator
    mpd: MultiPeriodDiscriminator
    msd: MultiScaleDiscriminator
    gen_opt: GanOptimizer
    disc_opt: GanOptimizer
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.gen.parameters()).device

    def named_disc_params(self) -> Dict[str, nn.Parameter]:
        """MPD's and MSD's parameters, named ``mpd.*`` and ``msd.*``."""
        return _disc_named(self.mpd, self.msd)

    def disc_params(self) -> List[nn.Parameter]:
        return list(self.named_disc_params().values())

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "gen": self.gen.state_dict(),
                "mpd": self.mpd.state_dict(), "msd": self.msd.state_dict(),
                "gen_opt": self.gen_opt.state_dict(),
                "disc_opt": self.disc_opt.state_dict()}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        for name in ("gen", "mpd", "msd", "gen_opt", "disc_opt"):
            getattr(self, name).load_state_dict(sd[name])
        self.step = int(sd["step"])


def make_vocoder_models(cfg: Any):
    return (HifiGanGenerator(cfg), MultiPeriodDiscriminator(),
            MultiScaleDiscriminator())


def init_vocoder_state(cfg: Any, seed: int = 0,
                       device: Union[str, torch.device] = "cuda"
                       ) -> VocoderState:
    """Seeded random weights on ``device`` (``cuda`` unless the caller asks
    for the CPU): the generator's conv kernels N(0, 0.01), as its flax
    init; every other matrix N(0, 1/fan_in); biases 0."""
    device = resolve_device(device)
    gen, mpd, msd = make_vocoder_models(cfg)
    g = torch.Generator().manual_seed(int(seed))
    init_random_(gen, g, conv_std=0.01)
    init_random_(mpd, g)
    init_random_(msd, g)
    for m in (gen, mpd, msd):
        m.to(device).train()
    return VocoderState(gen, mpd, msd,
                        GanOptimizer(dict(gen.named_parameters()), cfg),
                        GanOptimizer(_disc_named(mpd, msd), cfg))


def vocoder_noise(seed: int, step: int, device: Union[str, torch.device],
                  stream: str) -> Noise:
    """A fresh noise source of iteration ``step``: ``"noise"`` (the
    generator's NSF draws; each pass of the iteration builds its own, so
    both draw the same) or ``"crop"`` (the on-device crops)."""
    return Noise(stream_seed(seed, step, NOISE_STREAMS.index(stream)),
                 device)


def make_vocoder_bodies(cfg: Any):
    """(disc_step, gen_step), each ``(state, batch, noise, scalars=None) ->
    metrics``: a batch of tensors ``mels`` [B, T, M], ``f0`` [B, T], ``wav``
    [B, T * hop] on the state's device; ``noise`` the generator's noise
    source; ``scalars`` its side's optimizer scalars in a device buffer
    (``GanOptimizer.step``).  Each updates its side in place; ``gen_step``
    advances ``state.step``."""
    lambda_fm = float(cfg["lambda_fm"])
    lambda_mel = float(cfg["lambda_mel"])
    lambda_ms_stft = float(cfg["lambda_ms_stft"])
    mel_kw = dict(sample_rate=cfg["audio_sample_rate"], n_fft=cfg["fft_size"],
                  hop_size=cfg["hop_size"], win_length=cfg["win_size"],
                  n_mels=cfg["audio_num_mel_bins"], fmin=cfg["fmin"],
                  fmax=cfg["fmax"])

    def disc_step(state: VocoderState, batch: Dict[str, torch.Tensor],
                  noise, scalars: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            fake = state.gen(batch["mels"], batch["f0"], noise)
        real = batch["wav"]
        rp, _ = state.mpd(real)
        fp, _ = state.mpd(fake)
        rs, _ = state.msd(real)
        fs, _ = state.msd(fake)
        loss = discriminator_loss(rp, fp) + discriminator_loss(rs, fs)
        params = state.disc_params()
        state.disc_opt.step(params, torch.autograd.grad(loss, params),
                            scalars)
        return {"disc_loss": loss.detach()}

    def gen_step(state: VocoderState, batch: Dict[str, torch.Tensor],
                 noise, scalars: Optional[torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
        real = batch["wav"]
        fake = state.gen(batch["mels"], batch["f0"], noise)
        with torch.no_grad():  # the real side carries no gradient
            _, rfp = state.mpd(real)
            _, rfs = state.msd(real)
            real_mel = wav2mel_batch(real, **mel_kw)
        fp, ffp = state.mpd(fake)
        fs, ffs = state.msd(fake)
        adv = generator_adv_loss(fp) + generator_adv_loss(fs)
        fm = feature_matching_loss(rfp, ffp) + feature_matching_loss(rfs, ffs)
        mel_l1 = torch.abs(wav2mel_batch(fake, **mel_kw) - real_mel).mean()
        total = adv + lambda_fm * fm + lambda_mel * mel_l1
        parts = {"adv": adv, "fm": fm, "mel_l1": mel_l1}
        if lambda_ms_stft > 0:
            sc, mag = multi_resolution_stft_loss(fake, real)
            parts["ms_stft"] = sc + mag
            total = total + lambda_ms_stft * (sc + mag)
        params = list(state.gen.parameters())
        state.gen_opt.step(params, torch.autograd.grad(
            total, params, allow_unused=True), scalars)
        state.step += 1
        metrics = {k: v.detach() for k, v in parts.items()}
        metrics["gen_loss"] = total.detach()
        return metrics

    return disc_step, gen_step


def make_vocoder_steps(cfg: Any, seed: int = 0):
    """(gen_step, disc_step), each ``(state, batch) -> metrics``, drawing
    the noise of iteration ``state.step`` (:func:`vocoder_noise`): run
    ``disc_step`` then ``gen_step`` for one iteration."""
    disc_body, gen_body = make_vocoder_bodies(cfg)

    def noise(state):
        return vocoder_noise(seed, state.step, state.device, "noise")

    return (lambda state, batch: gen_body(state, batch, noise(state)),
            lambda state, batch: disc_body(state, batch, noise(state)))


def stack_corpus(items, cfg: Any, max_frames: int) -> Dict[str, np.ndarray]:
    """A whole (small) corpus padded to one [N, T(, ...)] signature: mel and
    f0 to ``max_frames`` frames, wav to ``max_frames * hop`` samples, and
    each item's frame count."""
    hop = cfg["hop_size"]
    n_mels = cfg["audio_num_mel_bins"]
    mels = np.zeros((len(items), max_frames, n_mels), np.float32)
    wavs = np.zeros((len(items), max_frames * hop), np.float32)
    f0s = np.zeros((len(items), max_frames), np.float32)
    lens = np.zeros((len(items),), np.int32)
    for i, it in enumerate(items):
        t = min(int(it["mel"].shape[0]), max_frames)
        mels[i, :t] = it["mel"][:t]
        f0s[i, :t] = it["f0"][:t]
        w = np.asarray(it["wav"])[: t * hop]
        wavs[i, : len(w)] = w
        lens[i] = t
    return {"mels": mels, "wav": wavs, "f0": f0s, "lens": lens}


def corpus_to_device(data: Dict[str, np.ndarray],
                     device: Union[str, torch.device]
                     ) -> Dict[str, torch.Tensor]:
    """:func:`stack_corpus`'s arrays as tensors on ``device`` (``lens`` as
    int64, for indexing)."""
    out = {k: torch.as_tensor(v, device=device) for k, v in data.items()}
    out["lens"] = out["lens"].long()
    return out


def device_crops(data: Dict[str, torch.Tensor], noise, crop_frames: int,
                 batch_size: int, hop: int) -> Dict[str, torch.Tensor]:
    """``batch_size`` random crops of ``crop_frames`` frames from a device
    corpus: items ``randint(0, N)``, offsets ``randint(0, 2^30) % max(len -
    crop_frames, 1)`` (JAX's draws, in its order), clamped into the padded
    corpus as ``lax.dynamic_slice`` clamps; all on the device."""
    n_items, t_max = data["mels"].shape[:2]
    idx = noise.randint((batch_size,), 0, n_items)
    span = torch.clamp_min(data["lens"][idx] - crop_frames, 1)
    off = noise.randint((batch_size,), 0, 1 << 30) % span
    off = torch.clamp_max(off, t_max - crop_frames)
    frames = off[:, None] + torch.arange(crop_frames, device=off.device)
    samples = off[:, None] * hop + torch.arange(crop_frames * hop,
                                                device=off.device)
    rows = idx[:, None]
    return {"mels": data["mels"][rows, frames], "f0": data["f0"][rows, frames],
            "wav": data["wav"][rows, samples]}


def make_vocoder_scan(cfg: Any, log: Callable[[str], None] = print
                      ) -> "VocoderScan":
    """Several GAN iterations over a device-resident corpus
    (:func:`corpus_to_device` of :func:`stack_corpus`), the crops drawn on
    the device (JAX's ``make_vocoder_scan``).

    Returns a :class:`VocoderScan`, ``scan(state, data, seed, n_steps,
    crop_frames, batch_size, noise=vocoder_noise) -> metrics`` (each
    [n_steps], on the device).  Iteration n draws from ``noise(seed, n,
    device, stream)``, so the stream continues across calls and resumes.

    On the card each iteration is a replay of one CUDA graph of the
    crops, the discriminator step and the generator step at the crop
    shape (one graph per RAdam branch and crop shape; the first iteration
    of each is eager and the capture follows it, ``training/graphs.py``;
    ``scan.graphs``): the discriminator step's generator pass launches the
    MRF kernel inside the graph.  On the CPU each iteration runs eagerly
    through the same code."""
    return VocoderScan(cfg, log)


class VocoderScan:
    """:func:`make_vocoder_scan`'s windows; ``graphs`` holds the graphs of
    the last (state, corpus) it ran on."""

    def __init__(self, cfg: Any, log: Callable[[str], None] = print):
        self.cfg = cfg
        self.disc_body, self.gen_body = make_vocoder_bodies(cfg)
        self.graphs = GraphedSteps(
            lambda st: ((st, "step"), (st.gen_opt, "count"),
                        (st.disc_opt, "count")), log)

    def __call__(self, state: VocoderState, data: Dict[str, torch.Tensor],
                 seed: int, n_steps: int, crop_frames: int, batch_size: int,
                 noise: Callable = vocoder_noise) -> Dict[str, torch.Tensor]:
        device, hop, graphs = state.device, self.cfg["hop_size"], self.graphs
        graphs.bind(state, data)
        scalars = graphs.buffer("scalars", (2, 3))

        def body(src):
            batch = device_crops(data, src["crop"], crop_frames, batch_size,
                                 hop)
            metrics = self.disc_body(state, batch, src["disc"], scalars[0])
            metrics.update(self.gen_body(state, batch, src["gen"],
                                         scalars[1]))
            return metrics

        def steps():
            for _ in range(n_steps):
                n = state.step
                write_scalars(scalars[0], state.disc_opt.scalars())
                write_scalars(scalars[1], state.gen_opt.scalars())
                src = {"crop": noise(seed, n, device, "crop"),
                       "disc": noise(seed, n, device, "noise"),
                       "gen": noise(seed, n, device, "noise")}
                yield graphs.run(state.disc_opt.graph_key() +
                                 state.gen_opt.graph_key() +
                                 (crop_frames, batch_size), body, src)

        return stack_steps(steps())


def crop_batch(items, cfg: Any, rng: np.random.Generator,
               crop_frames: int = 32) -> Dict[str, np.ndarray]:
    """Random fixed-size mel/wav/f0 crops of ``items``, zero-padded at the
    end of a short item (``tasks/vocoder/dataset_utils.py``)."""
    hop = cfg["hop_size"]
    mels, wavs, f0s = [], [], []
    for it in items:
        t = it["mel"].shape[0]
        s = int(rng.integers(0, max(t - crop_frames, 1)))
        e = s + crop_frames
        mel = it["mel"][s:e]
        if mel.shape[0] < crop_frames:
            mel = np.pad(mel, ((0, crop_frames - mel.shape[0]), (0, 0)))
        wav = it["wav"][s * hop: e * hop]
        if len(wav) < crop_frames * hop:
            wav = np.pad(wav, (0, crop_frames * hop - len(wav)))
        f0 = it["f0"][s:e]
        if len(f0) < crop_frames:
            f0 = np.pad(f0, (0, crop_frames - len(f0)))
        mels.append(mel)
        wavs.append(wav)
        f0s.append(f0)
    return {"mels": np.stack(mels).astype(np.float32),
            "wav": np.stack(wavs).astype(np.float32),
            "f0": np.stack(f0s).astype(np.float32)}


def batch_to_device(batch: Dict[str, np.ndarray],
                    device: Union[str, torch.device]
                    ) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def fit_vocoder(cfg: Any, items: Sequence[Dict[str, np.ndarray]],
                steps: int, work_dir: str, *, batch: int = 16,
                crop_frames: int = 64, spd: int = 1,
                device: Union[str, torch.device] = "cuda", seed: int = 0,
                log: Callable[[str], None] = print,
                scan: Optional["VocoderScan"] = None
                ) -> Tuple[VocoderState, List[Dict[str, torch.Tensor]]]:
    """Train the GAN to ``steps`` iterations on ``items`` (dicts of ``mel``
    [T, M], ``f0`` [T], ``wav`` [T * hop]), as ``tools/validate_vocoder.py``
    does: resume from ``<work_dir>/gan_state.pt`` when it exists, log every
    500 iterations, save the state every 5000 and at the end, and write the
    trained generator to ``<work_dir>/generator.pt`` (a ``vocoder_ckpt``).

    ``spd`` 1: host crops (:func:`crop_batch`, a numpy generator seeded 0
    whose state the saved state carries, so a resumed run crops as an
    unbroken one) and one dispatch per step; ``spd`` > 1: the corpus on the
    device, crops drawn there from the ``crop`` stream (so not the crops
    of ``spd`` 1), and windows of up to ``spd`` iterations that stop at
    the log interval (:func:`make_vocoder_scan`, or ``scan`` when given:
    each iteration a CUDA graph replay on the card, eager on the CPU).
    Returns the state and each iteration's metrics (tensors on the device).
    """
    device = resolve_device(device)
    os.makedirs(work_dir, exist_ok=True)
    rng = np.random.default_rng(0)

    def sample_items():
        return [items[int(j)] for j in rng.integers(0, len(items), batch)]

    # the tool crops one batch to size its init: drawn here too, so that
    # the crops that follow are the tool's
    crop_batch(sample_items(), cfg, rng, crop_frames=crop_frames)
    state = init_vocoder_state(cfg, seed, device)
    state_fn = os.path.join(work_dir, GAN_STATE_FILE)
    if os.path.exists(state_fn):
        payload = load_payload(state_fn, device)
        state.load_state_dict(payload)
        rng.bit_generator.state = payload["crop_rng"]
        log(f"| resumed GAN state at step {state.step}")

    def save_state():
        _save({**state.state_dict(), "crop_rng": rng.bit_generator.state},
              state_fn)

    history: List[Dict[str, torch.Tensor]] = []
    t0 = time.time()
    start = i = state.step
    if spd > 1:
        data = corpus_to_device(stack_corpus(items, cfg, max(
            int(it["mel"].shape[0]) for it in items)), device)
        scan = scan or make_vocoder_scan(cfg, log)
        while i < steps:
            w = min(spd, steps - i, LOG_INTERVAL - i % LOG_INTERVAL)
            m = scan(state, data, seed, w, crop_frames, batch)
            history += [{k: v[j] for k, v in m.items()} for j in range(w)]
            i += w
            if i % LOG_INTERVAL == 0 or i >= steps:
                log(f"| step {i}: " + str({k: round(float(v.mean()), 4)
                                           for k, v in m.items()}))
            if i % SAVE_INTERVAL == 0:
                save_state()
    else:
        gen_step, disc_step = make_vocoder_steps(cfg, seed)
        for i in range(start, steps):
            b = batch_to_device(crop_batch(sample_items(), cfg, rng,
                                           crop_frames=crop_frames), device)
            m = disc_step(state, b)
            m.update(gen_step(state, b))
            history.append(m)
            if (i + 1) % LOG_INTERVAL == 0 or i == 0:
                log(f"| step {i + 1}: " + str({k: round(float(v), 4)
                                               for k, v in m.items()}))
            if (i + 1) % SAVE_INTERVAL == 0:
                save_state()
    save_state()
    _save(state.gen.state_dict(), os.path.join(work_dir, GENERATOR_FILE))
    log(f"| trained to step {state.step} in {time.time() - t0:.0f}s "
        f"({state.step - start} steps)")
    return state, history
