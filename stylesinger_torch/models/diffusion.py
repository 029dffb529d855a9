"""Diffusion math and the flagship samplers (port of
``stylesinger_tpu/models/diffusion.py``): schedules, Gaussian and log-space
multinomial steps, the dual joint f0 + uv sampler and the shallow mel
sampler.

The samplers take their randomness from a noise source (:class:`Noise`, or
any object with ``normal(shape)`` and ``uniform(shape)``), drawn in the
order each docstring states.  That order is the order of the JAX
package's draws, so a test can hand the port JAX's own numbers.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

_FIELDS = (
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
    "sqrt_recipm1_alphas_cumprod", "posterior_variance",
    "posterior_log_variance_clipped", "posterior_mean_coef1",
    "posterior_mean_coef2", "log_alpha", "log_1_min_alpha",
    "log_cumprod_alpha", "log_1_min_cumprod_alpha")


class Noise:
    """Standard-normal and uniform draws from a seeded ``torch.Generator``
    on ``device``."""

    def __init__(self, seed: int, device: Union[str, torch.device]):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    def normal(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.device)

    def uniform(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.generator,
                          device=self.device)


class Schedule(nn.Module):
    """Diffusion schedule buffers (f32), moved with the owning model."""

    def __init__(self, timesteps: int, max_beta: float,
                 schedule_type: str = "linear"):
        super().__init__()
        if schedule_type == "linear":
            betas = np.linspace(1e-4, max_beta, timesteps)
        elif schedule_type == "cosine":
            steps = timesteps + 1
            x = np.linspace(0, steps, steps)
            ac = np.cos(((x / steps) + 0.008) / 1.008 * np.pi * 0.5) ** 2
            ac = ac / ac[0]
            betas = np.clip(1 - (ac[1:] / ac[:-1]), 0, 0.999)
        else:
            raise ValueError(schedule_type)
        betas = betas.astype(np.float64)
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

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])


def make_schedule(timesteps: int, max_beta: float,
                  schedule_type: str = "linear") -> Schedule:
    return Schedule(timesteps, max_beta, schedule_type)


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


# ---------------------------------------------------------------------------
# Samplers
# ---------------------------------------------------------------------------

def sample_gm_dual(denoise_fn_a: Callable, denoise_fn_b: Callable,
                   sched: Schedule, cond_T: int, batch: int, noise,
                   dyn_clip: Optional[Tuple] = None, num_classes: int = 2):
    """Both joint f0 + uv reverse chains, ancestral (the un-strided path).

    Draws: normal z_a, normal z_b, uniform u_a, uniform u_b, then for each
    step t = T-1 .. 0 and chain a then b: normal (f0 step), uniform (uv
    step).  Returns ((f0_a [B, T, 1], uv_a [B, T]), (f0_b, uv_b))."""
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


def norm_spec(x, spec_min, spec_max):
    return (x - spec_min) / (spec_max - spec_min) * 2 - 1


def denorm_spec(x, spec_min, spec_max):
    return (x + 1) / 2 * (spec_max - spec_min) + spec_min
