"""Diffusion math and the samplers (frozen from the port's
``models/diffusion.py``): schedules, Gaussian and log-space
multinomial steps, the dual joint f0 + uv sampler (ancestral, or strided
with ``speedup > 1``), the shallow mel samplers (ancestral, PLMS and
DPM-Solver++(2M)) and the ProDiff sampler.

The samplers and the training losses (:func:`gm_mixed_loss`,
:func:`shallow_p_losses`) take their randomness from a noise source
(:class:`Noise`, or any object with its methods), drawn in the order each
docstring states.  That order is the order of the JAX package's draws, so
a test can hand the port JAX's own numbers.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from .local import (
    global_mean, global_numel, global_sum,
)

_FIELDS = (
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
    "sqrt_recipm1_alphas_cumprod", "posterior_variance",
    "posterior_log_variance_clipped", "posterior_mean_coef1",
    "posterior_mean_coef2", "log_alpha", "log_1_min_alpha",
    "log_cumprod_alpha", "log_1_min_cumprod_alpha")


class Noise:
    """Standard-normal, uniform, integer and Bernoulli draws from a seeded
    ``torch.Generator`` on ``device``.  Each method can draw into ``out``
    (a tensor of the draw's shape and dtype), as a captured step's static
    buffers take them (``training/graphs.py``); the values are the same."""

    def __init__(self, seed: int, device: Union[str, torch.device]):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    @staticmethod
    def _out(out: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
        if tuple(out.shape) != tuple(shape):
            raise ValueError(f"Noise: out is {tuple(out.shape)}, the draw "
                             f"{tuple(shape)}")
        return out

    def normal(self, shape: Sequence[int],
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
        if out is not None:
            return self._out(out, shape).normal_(generator=self.generator)
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.device)

    def uniform(self, shape: Sequence[int],
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
        if out is not None:
            return self._out(out, shape).uniform_(generator=self.generator)
        return torch.rand(tuple(shape), generator=self.generator,
                          device=self.device)

    def randint(self, shape: Sequence[int], low: int, high: int,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Integers in [low, high), as ``jax.random.randint``."""
        if out is not None:
            return self._out(out, shape).random_(low, high,
                                                 generator=self.generator)
        return torch.randint(low, high, tuple(shape), generator=self.generator,
                             device=self.device)

    def bernoulli(self, p: float, shape: Sequence[int] = (),
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A bool mask, True with probability ``p`` (``jax.random.bernoulli``
        is ``uniform < p`` too)."""
        if out is not None:
            return torch.lt(self.uniform(shape), p,
                            out=self._out(out, shape))
        return self.uniform(shape) < p


class TensorNoise:
    """A noise source that hands out ``values``, one tensor per draw, in the
    order the model asks for them, and raises when a draw's shape is not
    the next tensor's.  It makes the draws arguments of a function,
    which ``torch.export`` needs (it takes no ``torch.Generator``;
    ``serving/export.py``).  ``draws``, the (method, arguments, dtype) of
    each draw as ``training/graphs.py::RecordingNoise`` lists them, also
    checks each draw's method and arguments."""

    def __init__(self, values: Sequence[torch.Tensor],
                 draws: Optional[Sequence[tuple]] = None):
        self.values = list(values)
        self.draws = None if draws is None else list(draws)
        self._next = 0

    def rewind(self) -> None:
        self._next = 0

    def done(self) -> bool:
        return self._next == len(self.values)

    def _take(self, kind: str, shape: tuple, *args) -> torch.Tensor:
        i = self._next
        if self.draws is not None and (
                i >= len(self.draws) or self.draws[i][:2] != (kind, args)):
            want = self.draws[i][:2] if i < len(self.draws) else "none"
            raise RuntimeError(f"TensorNoise: draw {i} is {kind}{args}, the "
                               f"recorded run drew {want}")
        if i >= len(self.values):
            raise RuntimeError(f"TensorNoise: draw {i} ({kind}{args}) is "
                               f"past the {len(self.values)} tensors given")
        out = self.values[i]
        if tuple(out.shape) != shape:
            raise RuntimeError(f"TensorNoise: draw {i} is {kind} {shape}, "
                               f"tensor {i} is {tuple(out.shape)}")
        self._next += 1
        return out

    def normal(self, shape):
        shape = tuple(shape)
        return self._take("normal", shape, shape)

    def uniform(self, shape):
        shape = tuple(shape)
        return self._take("uniform", shape, shape)

    def randint(self, shape, low, high):
        shape = tuple(shape)
        return self._take("randint", shape, shape, low, high)

    def bernoulli(self, p, shape=()):
        shape = tuple(shape)
        return self._take("bernoulli", shape, p, shape)


def draw_values(draws: Sequence[tuple], source) -> Tuple[torch.Tensor, ...]:
    """The values ``source`` (a :class:`Noise`) draws for ``draws``, the
    (method, arguments, dtype) of each draw in order: what the same
    source would hand a model that draws them."""
    return tuple(getattr(source, kind)(*args) for kind, args, _ in draws)


def linear_beta_schedule(timesteps: int, max_beta: float) -> np.ndarray:
    return np.linspace(1e-4, max_beta, timesteps)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    steps = timesteps + 1
    x = np.linspace(0, steps, steps)
    ac = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    ac = ac / ac[0]
    return np.clip(1 - (ac[1:] / ac[:-1]), 0, 0.999)


class Schedule(nn.Module):
    """Diffusion schedule buffers (f32) of ``betas``, moved with the owning
    model."""

    def __init__(self, betas: np.ndarray):
        super().__init__()
        betas = np.asarray(betas, np.float64)
        alphas = 1.0 - betas
        ac = np.cumprod(alphas)
        ac_prev = np.append(1.0, ac[:-1])
        post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
        log_alpha = np.log(alphas)
        log_cumprod_alpha = np.cumsum(log_alpha)

        def log_1_min_a(a):
            return np.log(1 - np.exp(a) + 1e-40)

        values = dict(
            betas=betas, alphas_cumprod=ac, alphas_cumprod_prev=ac_prev,
            sqrt_alphas_cumprod=np.sqrt(ac),
            sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - ac),
            sqrt_recip_alphas_cumprod=np.sqrt(1.0 / ac),
            sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / ac - 1),
            posterior_variance=post_var,
            posterior_log_variance_clipped=np.log(
                np.maximum(post_var, 1e-20)),
            posterior_mean_coef1=betas * np.sqrt(ac_prev) / (1.0 - ac),
            posterior_mean_coef2=(1.0 - ac_prev) * np.sqrt(alphas) /
            (1.0 - ac),
            log_alpha=log_alpha, log_1_min_alpha=log_1_min_a(log_alpha),
            log_cumprod_alpha=log_cumprod_alpha,
            log_1_min_cumprod_alpha=log_1_min_a(log_cumprod_alpha))
        for name in _FIELDS:
            self.register_buffer(name, torch.as_tensor(
                values[name].astype(np.float32)), persistent=False)
        # the f32 buffer's values on the host, for the samplers' grids
        self.alphas_cumprod_host = values["alphas_cumprod"].astype(
            np.float32)

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])


def make_schedule(timesteps: int, max_beta: float,
                  schedule_type: str = "linear") -> Schedule:
    if schedule_type == "linear":
        return Schedule(linear_beta_schedule(timesteps, max_beta))
    if schedule_type == "cosine":
        return Schedule(cosine_beta_schedule(timesteps))
    raise ValueError(schedule_type)


def vpsde_beta_t(t: int, big_t: int, min_beta: float,
                 max_beta: float) -> float:
    t_coef = (2 * t - 1) / (big_t ** 2)
    return 1.0 - np.exp(-min_beta / big_t -
                        0.5 * (max_beta - min_beta) * t_coef)


def prodiff_betas(timesteps: int, schedule_mode: str = "vpsde",
                  min_beta: float = 0.1, max_beta: float = 40.0,
                  s: float = 0.008) -> np.ndarray:
    """The ProDiff teacher's noise schedules."""
    if schedule_mode == "linear":
        return np.linspace(1e-6, 0.01, timesteps)
    if schedule_mode == "cosine":
        return cosine_beta_schedule(timesteps, s)
    if schedule_mode == "vpsde":
        return np.array([vpsde_beta_t(t, timesteps, min_beta, max_beta)
                         for t in range(1, timesteps + 1)])
    raise ValueError(schedule_mode)


def make_prodiff_schedule(timesteps: int,
                          schedule_mode: str = "vpsde") -> Schedule:
    """ProDiff's schedule, with ``timesteps + 1`` entries as in JAX."""
    return Schedule(prodiff_betas(timesteps + 1, schedule_mode))


def _extract(buf: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    out = buf[t]
    return out.reshape(out.shape + (1,) * (ndim - 1))


# ---------------------------------------------------------------------------
# Gaussian half
# ---------------------------------------------------------------------------

def gaussian_q_sample(sched: Schedule, x_start, t, noise_t):
    return (_extract(sched.sqrt_alphas_cumprod, t, x_start.ndim) * x_start +
            _extract(sched.sqrt_one_minus_alphas_cumprod, t, x_start.ndim)
            * noise_t)


def predict_start_from_noise(sched: Schedule, x_t, t, noise_pred):
    return (_extract(sched.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t -
            _extract(sched.sqrt_recipm1_alphas_cumprod, t, x_t.ndim)
            * noise_pred)


def q_posterior(sched: Schedule, x_start, x_t, t):
    mean = (_extract(sched.posterior_mean_coef1, t, x_t.ndim) * x_start +
            _extract(sched.posterior_mean_coef2, t, x_t.ndim) * x_t)
    return mean, _extract(sched.posterior_log_variance_clipped, t, x_t.ndim)


def gaussian_p_sample(sched: Schedule, x: torch.Tensor, t: torch.Tensor,
                      noise_pred: torch.Tensor, noise,
                      clip: Optional[Tuple] = (-1.0, 1.0)) -> torch.Tensor:
    """One reverse step x_t -> x_{t-1} with x0 clipping; draws one
    ``normal(x.shape)`` (also at t = 0, where it is multiplied by 0)."""
    x_recon = predict_start_from_noise(sched, x, t, noise_pred)
    if clip is not None:
        x_recon = torch.clamp(x_recon, clip[0], clip[1])
    mean, log_var = q_posterior(sched, x_recon, x, t)
    z = noise.normal(x.shape)
    nonzero = (t > 0).to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
    return mean + nonzero * torch.exp(0.5 * log_var) * z


# ---------------------------------------------------------------------------
# Multinomial half (log space, class axis 1)
# ---------------------------------------------------------------------------

def index_to_log_onehot(x: torch.Tensor, num_classes: int) -> torch.Tensor:
    """int [B, T] -> log-onehot [B, K, T]."""
    oh = torch.nn.functional.one_hot(x, num_classes).to(torch.float32)
    return torch.log(torch.clamp_min(oh.transpose(1, 2), 1e-30))


def log_onehot_to_index(log_x: torch.Tensor) -> torch.Tensor:
    return torch.argmax(log_x, dim=1)


def log_add_exp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(a, b)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m))


def cat_q_pred_one_timestep(sched, log_x_t, t, num_classes):
    return log_add_exp(
        log_x_t + _extract(sched.log_alpha, t, log_x_t.ndim),
        _extract(sched.log_1_min_alpha, t, log_x_t.ndim) -
        np.log(num_classes))


def cat_q_pred(sched, log_x_start, t, num_classes):
    return log_add_exp(
        log_x_start + _extract(sched.log_cumprod_alpha, t, log_x_start.ndim),
        _extract(sched.log_1_min_cumprod_alpha, t, log_x_start.ndim) -
        np.log(num_classes))


def cat_q_posterior(sched, log_x_start, log_x_t, t, num_classes):
    """q(x_{t-1} | x_t, x0 distribution) in log space."""
    log_ev = cat_q_pred(sched, log_x_start, torch.clamp_min(t - 1, 0),
                        num_classes)
    t_b = t.reshape((-1,) + (1,) * (log_x_start.ndim - 1))
    log_ev = torch.where(t_b == 0, log_x_start, log_ev)
    unnormed = log_ev + cat_q_pred_one_timestep(sched, log_x_t, t,
                                                num_classes)
    return unnormed - torch.logsumexp(unnormed, dim=1, keepdim=True)


def cat_p_pred(sched, model_logits, log_x_t, t, num_classes):
    """x0 parameterization: log_softmax(model) -> q_posterior."""
    return cat_q_posterior(sched, torch.log_softmax(model_logits, dim=1),
                           log_x_t, t, num_classes)


def log_sample_categorical(noise, logits: torch.Tensor,
                           num_classes: int) -> torch.Tensor:
    """Gumbel-max sampling in log space; draws one ``uniform(logits.shape)``."""
    u = noise.uniform(logits.shape)
    gumbel = -torch.log(-torch.log(u + 1e-30) + 1e-30)
    return index_to_log_onehot(torch.argmax(gumbel + logits, dim=1),
                               num_classes)


def multinomial_kl(log_p1: torch.Tensor, log_p2: torch.Tensor
                   ) -> torch.Tensor:
    return (torch.exp(log_p1) * (log_p1 - log_p2)).sum(dim=1)


def _masked_time_mean(x: torch.Tensor, nonpadding: torch.Tensor
                      ) -> torch.Tensor:
    """Per batch row: sum over time of x * mask / sum of mask."""
    return (x * nonpadding).sum(-1) / torch.clamp_min(nonpadding.sum(-1),
                                                      1e-8)


# ---------------------------------------------------------------------------
# Training losses
# ---------------------------------------------------------------------------

def gm_mixed_loss(denoise_fn: Callable, sched: Schedule, f0: torch.Tensor,
                  uv: torch.Tensor, nonpadding: torch.Tensor, noise,
                  num_classes: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """The joint f0 + uv diffusion's training loss.

    f0: [B, T, 1] minmax-normed; uv: [B, T] 0/1 floats; ``denoise_fn(f0_t,
    uv_t int [B, T], t [B]) -> [B, T, 1 + K]``.  Draws: ``randint`` t,
    ``normal`` (the f0 noise), ``uniform`` (the uv q-sample).  Returns
    (multinomial loss, Gaussian L1 on eps over voiced frames)."""
    b = f0.shape[0]
    big_t = sched.num_timesteps
    t = noise.randint((b,), 0, big_t)
    eps = noise.normal(f0.shape)
    f0_t = gaussian_q_sample(sched, f0, t, eps)
    log_uv = index_to_log_onehot(uv.long(), num_classes)      # [B, K, T]
    log_uv_t = log_sample_categorical(
        noise, cat_q_pred(sched, log_uv, t, num_classes), num_classes)
    out = denoise_fn(f0_t, log_onehot_to_index(log_uv_t), t)  # [B, T, 1+K]
    eps_pred = out[..., :1]
    uv_logits = out[..., 1:].transpose(1, 2)                  # [B, K, T]

    log_true = cat_q_posterior(sched, log_uv, log_uv_t, t, num_classes)
    log_model = cat_p_pred(sched, uv_logits, log_uv_t, t, num_classes)
    kl = _masked_time_mean(multinomial_kl(log_true, log_model), nonpadding)
    decoder_nll = -_masked_time_mean(
        (torch.exp(log_uv) * log_model).sum(dim=1), nonpadding)
    at0 = (t == 0).to(kl.dtype)
    lt = at0 * decoder_nll + (1 - at0) * kl
    log_qxt = cat_q_pred(sched, log_uv, torch.full_like(t, big_t - 1),
                         num_classes)
    kl_prior = _masked_time_mean(
        multinomial_kl(log_qxt, torch.full_like(log_qxt,
                                                -np.log(num_classes))),
        nonpadding)
    pt = torch.full_like(lt, 1.0 / big_t)
    loss_multi = global_mean(lt / pt + kl_prior)

    mask = (nonpadding * (uv == 0).to(nonpadding.dtype))[..., None]
    loss_gauss = (torch.abs(eps - eps_pred) * mask).sum() / torch.clamp_min(
        global_sum(mask.sum(), "voiced") + 1e-8 * global_numel(mask), 1e-8)
    return loss_multi, loss_gauss


def shallow_p_losses(denoise_fn: Callable, sched: Schedule,
                     x_start: torch.Tensor, noise, K_step: int,
                     nonpadding: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """The mel diffusion's training loss: L1 between the drawn and the
    predicted eps at a t below ``K_step``, masked to ``nonpadding`` frames.
    Draws: ``randint`` t, then ``normal`` (the noise)."""
    b = x_start.shape[0]
    t = noise.randint((b,), 0, K_step)
    eps = noise.normal(x_start.shape)
    err = torch.abs(eps - denoise_fn(gaussian_q_sample(sched, x_start, t,
                                                       eps), t))
    if nonpadding is None:
        return global_mean(err)
    mask = nonpadding[..., None]
    return (err * mask).sum() / torch.clamp_min(
        global_sum(mask.sum(), "frames") * x_start.shape[-1], 1e-8)


# ---------------------------------------------------------------------------
# Samplers
# ---------------------------------------------------------------------------

def sample_gm_dual(denoise_fn_a: Callable, denoise_fn_b: Callable,
                   sched: Schedule, cond_T: int, batch: int, noise,
                   dyn_clip: Optional[Tuple] = None, num_classes: int = 2,
                   speedup: int = 1):
    """Both joint f0 + uv reverse chains: ancestral at ``speedup`` 1,
    strided (:func:`_sample_gm_dual_strided`) above it.

    Ancestral draws: normal z_a, normal z_b, uniform u_a, uniform u_b, then
    for each step t = T-1 .. 0 and chain a then b: normal (f0 step),
    uniform (uv step).  Returns ((f0_a [B, T, 1], uv_a [B, T]),
    (f0_b, uv_b))."""
    if speedup > 1:
        return _sample_gm_dual_strided(
            denoise_fn_a, denoise_fn_b, sched, cond_T, batch, noise,
            dyn_clip=dyn_clip, num_classes=num_classes, speedup=speedup)
    dev = sched.betas.device
    z_a = noise.normal((batch, cond_T, 1))
    z_b = noise.normal((batch, cond_T, 1))
    zeros = torch.zeros((batch, num_classes, cond_T), device=dev)
    log_ua = log_sample_categorical(noise, zeros, num_classes)
    log_ub = log_sample_categorical(noise, zeros, num_classes)
    clip = dyn_clip if dyn_clip is not None else (-1.0, 1.0)

    def half_step(fn, z, log_u, t):
        out = fn(z, log_onehot_to_index(log_u), t)
        logits = out[..., 1:].transpose(1, 2)
        z = gaussian_p_sample(sched, z, t, out[..., :1], noise, clip=clip)
        log_model = cat_p_pred(sched, logits, log_u, t, num_classes)
        return z, log_sample_categorical(noise, log_model, num_classes)

    for step in range(sched.num_timesteps - 1, -1, -1):
        t = torch.full((batch,), step, dtype=torch.long, device=dev)
        z_a, log_ua = half_step(denoise_fn_a, z_a, log_ua, t)
        z_b, log_ub = half_step(denoise_fn_b, z_b, log_ub, t)
    return ((z_a, log_onehot_to_index(log_ua).to(torch.float32)),
            (z_b, log_onehot_to_index(log_ub).to(torch.float32)))


def sample_shallow(denoise_fn: Callable, sched: Schedule,
                   coarse_norm: torch.Tensor, noise,
                   K_step: int) -> torch.Tensor:
    """Shallow diffusion: q_sample the coarse mel to t = K-1, then K reverse
    steps.  Draws: normal (q_sample), then one normal per step."""
    b = coarse_norm.shape[0]
    dev = coarse_norm.device
    t0 = torch.full((b,), K_step - 1, dtype=torch.long, device=dev)
    x = gaussian_q_sample(sched, coarse_norm, t0,
                          noise.normal(coarse_norm.shape))
    for step in range(K_step - 1, -1, -1):
        t = torch.full((b,), step, dtype=torch.long, device=dev)
        x = gaussian_p_sample(sched, x, t, denoise_fn(x, t), noise,
                              clip=(-1.0, 1.0))
    return x


def _gaussian_ddim_jump(sched: Schedule, x: torch.Tensor, t: torch.Tensor,
                        t_prev: torch.Tensor, eps_pred: torch.Tensor,
                        clip: Tuple) -> torch.Tensor:
    """Deterministic DDIM (eta = 0) jump t -> t_prev (t_prev < 0 lands on
    x0), with the ancestral sampler's x0 clipping."""
    x0 = torch.clamp(predict_start_from_noise(sched, x, t, eps_pred),
                     clip[0], clip[1])
    sr = _extract(sched.sqrt_recip_alphas_cumprod, t, x.ndim)
    srm1 = _extract(sched.sqrt_recipm1_alphas_cumprod, t, x.ndim)
    eps = (sr * x - x0) / srm1
    ac_prev = _extract(sched.alphas_cumprod, torch.clamp_min(t_prev, 0),
                       x.ndim)
    landed = t_prev.reshape((-1,) + (1,) * (x.ndim - 1)) < 0
    ac_prev = torch.where(landed, torch.ones_like(ac_prev), ac_prev)
    return torch.sqrt(ac_prev) * x0 + torch.sqrt(1.0 - ac_prev) * eps


def _log1mexp(a: torch.Tensor) -> torch.Tensor:
    """log(1 - exp(a)) for a <= 0, safe at a -> 0."""
    return torch.log(torch.clamp_min(-torch.expm1(a), 1e-30))


def cat_q_posterior_strided(sched, log_x_start, log_x_t, t, t_prev,
                            num_classes):
    """q(x_{t_prev} | x_t, x0 distribution) across a stride: the forward
    kernel over (t_prev, t] keeps ca_t / ca_{t_prev}.  Equals
    :func:`cat_q_posterior` at t_prev = t - 1."""
    ndim = log_x_t.ndim
    tp = torch.clamp_min(t_prev, 0)
    lca_t = _extract(sched.log_cumprod_alpha, t, ndim)
    lca_p = _extract(sched.log_cumprod_alpha, tp, ndim)
    tp_neg = t_prev.reshape((-1,) + (1,) * (ndim - 1)) < 0
    lca_p = torch.where(tp_neg, torch.zeros_like(lca_p), lca_p)
    log_span = lca_t - lca_p
    log_qxt = log_add_exp(log_x_t + log_span,
                          _log1mexp(log_span) - np.log(num_classes))
    log_ev = cat_q_pred(sched, log_x_start, tp, num_classes)
    log_ev = torch.where(tp_neg, log_x_start, log_ev)
    unnormed = log_ev + log_qxt
    return unnormed - torch.logsumexp(unnormed, dim=1, keepdim=True)


def _sample_gm_dual_strided(denoise_fn_a: Callable, denoise_fn_b: Callable,
                            sched: Schedule, cond_T: int, batch: int, noise,
                            dyn_clip: Optional[Tuple] = None,
                            num_classes: int = 2, speedup: int = 5):
    """Both joint f0 + uv chains with strided jumps: DDIM (eta = 0) for f0,
    the strided categorical posterior for uv, over t = T-1, T-1-speedup,
    ... and a last jump to t_prev = -1.

    Draws: normal z_a, normal z_b, uniform u_a, uniform u_b, then for each
    step and chain a then b one uniform (the uv step)."""
    dev = sched.betas.device
    z_a = noise.normal((batch, cond_T, 1))
    z_b = noise.normal((batch, cond_T, 1))
    zeros = torch.zeros((batch, num_classes, cond_T), device=dev)
    log_ua = log_sample_categorical(noise, zeros, num_classes)
    log_ub = log_sample_categorical(noise, zeros, num_classes)
    clip = dyn_clip if dyn_clip is not None else (-1.0, 1.0)

    def half_step(fn, z, log_u, t, t_prev):
        out = fn(z, log_onehot_to_index(log_u), t)
        logits = out[..., 1:].transpose(1, 2)
        z = _gaussian_ddim_jump(sched, z, t, t_prev, out[..., :1], clip)
        log_model = cat_q_posterior_strided(
            sched, torch.log_softmax(logits, dim=1), log_u, t, t_prev,
            num_classes)
        return z, log_sample_categorical(noise, log_model, num_classes)

    ts = np.arange(sched.num_timesteps - 1, -1, -speedup)
    tps = np.concatenate([ts[1:], [-1]])
    for step, step_prev in zip(ts, tps):
        t = torch.full((batch,), int(step), dtype=torch.long, device=dev)
        tp = torch.full((batch,), int(step_prev), dtype=torch.long,
                        device=dev)
        z_a, log_ua = half_step(denoise_fn_a, z_a, log_ua, t, tp)
        z_b, log_ub = half_step(denoise_fn_b, z_b, log_ub, t, tp)
    return ((z_a, log_onehot_to_index(log_ua).to(torch.float32)),
            (z_b, log_onehot_to_index(log_ub).to(torch.float32)))


def sample_shallow_plms(denoise_fn: Callable, sched: Schedule,
                        coarse_norm: torch.Tensor, noise, K_step: int,
                        speedup: int) -> torch.Tensor:
    """PLMS shallow sampling: q-sample the coarse mel to t = K-1, then steps
    t = K - speedup, K - 2 speedup, ..., 0 with an Adams-Bashforth
    combination of the last noise predictions (orders 1 to 4).  The first
    step is the order-1 predictor-corrector and calls the denoiser twice,
    so K / speedup + 1 calls in all.  Draws: one normal (the q-sample)."""
    b = coarse_norm.shape[0]
    dev = coarse_norm.device
    interval = speedup
    t0 = torch.full((b,), K_step - 1, dtype=torch.long, device=dev)
    x = gaussian_q_sample(sched, coarse_norm, t0,
                          noise.normal(coarse_norm.shape))
    ac = sched.alphas_cumprod

    def get_x_pred(x, noise_t, t):
        a_t = _extract(ac, t, x.ndim)
        a_prev = _extract(ac, torch.clamp_min(t - interval, 0), x.ndim)
        sq_t, sq_prev = torch.sqrt(a_t), torch.sqrt(a_prev)
        x_delta = (a_prev - a_t) * (
            (1.0 / (sq_t * (sq_t + sq_prev))) * x -
            1.0 / (sq_t * (torch.sqrt((1 - a_prev) * a_t) +
                           torch.sqrt((1 - a_t) * a_prev))) * noise_t)
        return x + x_delta

    n1 = n2 = n3 = torch.zeros_like(x)
    for idx, step in enumerate(range(K_step - interval, -1, -interval)):
        t = torch.full((b,), step, dtype=torch.long, device=dev)
        noise_pred = denoise_fn(x, t)
        if idx == 0:
            x_pred = get_x_pred(x, noise_pred, t)
            noise_prev = denoise_fn(x_pred, torch.clamp_min(t - interval, 0))
            prime = (noise_pred + noise_prev) / 2
        elif idx == 1:
            prime = (3 * noise_pred - n1) / 2
        elif idx == 2:
            prime = (23 * noise_pred - 16 * n1 + 5 * n2) / 12
        else:
            prime = (55 * noise_pred - 59 * n1 + 37 * n2 - 9 * n3) / 24
        x = get_x_pred(x, prime, t)
        n1, n2, n3 = noise_pred, n1, n2
    return x


def dpmpp_grid(sched: Schedule, K_step: int, n_steps: int):
    """DPM-Solver++(2M)'s timestep grid (descending, unique) and its
    per-step constants [n, 3] (sigma ratio, gain, r), computed in f64 and
    cast to f32 as the JAX sampler does, from the schedule's values on the
    host (no read from the device: a traced sampler stays one graph)."""
    ac = sched.alphas_cumprod_host.astype(np.float64)
    ts_f = np.linspace(K_step - 1, 0, max(int(n_steps), 1))
    ts = np.unique(np.round(ts_f).astype(np.int64))[::-1]
    n = len(ts)
    alpha = np.sqrt(ac[ts])
    sigma = np.sqrt(1.0 - ac[ts])
    lam = np.log(alpha) - np.log(np.maximum(sigma, 1e-12))
    h = np.append(lam[1:] - lam[:-1], np.inf)
    with np.errstate(invalid="ignore"):
        r = np.append(np.inf, h[:-1])[:n] / np.maximum(h, 1e-12)
    r = np.nan_to_num(r, posinf=1.0)
    r[-1] = np.inf  # the sigma -> 0 step is first order
    sig_ratio = np.append(sigma[1:] / np.maximum(sigma[:-1], 1e-12), 0.0)
    alpha_next = np.append(alpha[1:], 1.0)
    phi = np.expm1(-h)
    phi[-1] = -1.0  # the sigma -> 0 limit
    consts = np.stack([sig_ratio, alpha_next * -phi, r], -1)
    return ts, consts.astype(np.float32)


def sample_shallow_dpmpp(denoise_fn: Callable, sched: Schedule,
                         coarse_norm: torch.Tensor, noise, K_step: int,
                         n_steps: int) -> torch.Tensor:
    """DPM-Solver++(2M) shallow sampling: one denoiser call per point of
    :func:`dpmpp_grid`; the last step lands on the x0 prediction.  Draws:
    one normal (the q-sample)."""
    b = coarse_norm.shape[0]
    dev = coarse_norm.device
    t0 = torch.full((b,), K_step - 1, dtype=torch.long, device=dev)
    x = gaussian_q_sample(sched, coarse_norm, t0,
                          noise.normal(coarse_norm.shape))
    ts, consts = dpmpp_grid(sched, K_step, n_steps)
    prev_x0 = torch.zeros_like(x)
    one = np.float32(1.0)
    for idx, (step, (sig_ratio, gain, r)) in enumerate(zip(ts, consts)):
        t = torch.full((b,), int(step), dtype=torch.long, device=dev)
        eps = denoise_fn(x, t)
        a_t = _extract(sched.sqrt_alphas_cumprod, t, x.ndim)
        s_t = _extract(sched.sqrt_one_minus_alphas_cumprod, t, x.ndim)
        x0 = torch.clamp((x - s_t * eps) / a_t, -1.0, 1.0)
        if idx == 0:
            d = x0
        else:
            # in f32, as JAX computes the coefficients
            c2 = one / (np.float32(2.0) * np.maximum(r, np.float32(1e-6)))
            d = float(one + c2) * x0 - float(c2) * prev_x0
        x = float(sig_ratio) * x + float(gain) * d
        prev_x0 = x0
    return x


def prodiff_train(denoise_fn: Callable, sched: Schedule, timesteps: int,
                  x_start: torch.Tensor, noise) -> torch.Tensor:
    """ProDiff's training pass: ``x_start`` [B, T, M] diffused to a t drawn
    in [0, timesteps] and the x0 the denoiser predicts from it (the caller
    applies the mel losses).  Draws: ``randint`` t, then ``normal``."""
    b = x_start.shape[0]
    t = noise.randint((b,), 0, timesteps + 1)
    eps = noise.normal(x_start.shape)
    return denoise_fn(gaussian_q_sample(sched, x_start, t, eps), t)


def sample_prodiff(denoise_fn: Callable, sched: Schedule, timesteps: int,
                   shape: Sequence[int], noise) -> torch.Tensor:
    """ProDiff: x0-parameterized reverse sampling from pure noise over
    t = timesteps-1 .. 0.  Draws: normal x_T, then one normal per step
    (also at t = 0, where it is multiplied by 0)."""
    dev = sched.betas.device
    x = noise.normal(shape)
    for step in range(timesteps - 1, -1, -1):
        t = torch.full((shape[0],), step, dtype=torch.long, device=dev)
        mean, log_var = q_posterior(sched, denoise_fn(x, t), x, t)
        z = noise.normal(x.shape)
        nonzero = (t > 0).to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
        x = mean + nonzero * torch.exp(0.5 * log_var) * z
    return x


def norm_spec(x, spec_min, spec_max):
    return (x - spec_min) / (spec_max - spec_min) * 2 - 1


def denorm_spec(x, spec_min, spec_max):
    return (x + 1) / 2 * (spec_max - spec_min) + spec_min
