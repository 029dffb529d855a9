"""Helpers for the parity tests of the PyTorch port against the JAX package.

- :func:`random_variables`: seeded numpy weights for a flax module, shaped
  by tracing its init (``jax.eval_shape``, no compile), as the JAX
  package's training-path init would create them.
- :func:`stash_draws`, :func:`sampler_keys`, :func:`gm_dual_draws`,
  :func:`shallow_draws`: collect the normal/uniform draws a JAX function
  makes, in order: directly where they are made outside ``lax.scan``, and
  by replaying the samplers' key splits for the draws inside their scans.
- :class:`Replay`: hands those draws to the port in the same order, so
  both sides see the same noise.
"""

from __future__ import annotations

import contextlib
import functools

import jax
import numpy as np
import torch


def _leaf_value(path, shape, rng, gain):
    name = str(path[-1].key)
    if name == "kernel":
        fan_in = int(np.prod(shape[:-1])) or 1
        return rng.standard_normal(shape) * gain / np.sqrt(fan_in)
    if name == "bias":
        return 0.1 * rng.standard_normal(shape)
    if name == "scale":
        return 1.0 + 0.1 * rng.standard_normal(shape)
    if name == "embedding":
        return rng.standard_normal(shape) / np.sqrt(shape[-1])
    if name == "pos_embed_alpha":
        return 1.0 + 0.1 * rng.standard_normal(shape)
    if name == "cluster_size_ema":
        return np.zeros(shape)
    return rng.standard_normal(shape)


def random_variables(init_fn, *args, seed: int = 0, gain: float = 1.0,
                     **kwargs):
    """numpy variables with the tree of ``init_fn(*args, **kwargs)``."""
    shapes = jax.eval_shape(functools.partial(init_fn, **kwargs), *args)
    rng = np.random.default_rng(seed)
    out = jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(_leaf_value(p, s.shape, rng, gain),
                                np.float32), shapes)
    _sync_ema(out.get("codebook", {}))
    return out


def _sync_ema(tree) -> None:
    """The EMA copy of each codebook starts equal to the codebook."""
    for v in tree.values():
        if isinstance(v, dict):
            if "embed_ema" in v:
                v["embed_ema"] = v["embedding"].copy()
            else:
                _sync_ema(v)


@contextlib.contextmanager
def stash_draws(draws: list):
    """Append every ``jax.random.normal``/``uniform`` output to ``draws``
    as (kind, value) while active.  Under ``jax.jit`` the values are
    tracers: return them from the jitted function."""
    normal, uniform = jax.random.normal, jax.random.uniform

    def rec_normal(key, shape=(), dtype=np.float32, *a, **k):
        out = normal(key, shape, dtype, *a, **k)
        draws.append(("n", out))
        return out

    def rec_uniform(key, shape=(), dtype=np.float32, *a, **k):
        out = uniform(key, shape, dtype, *a, **k)
        draws.append(("u", out))
        return out

    jax.random.normal, jax.random.uniform = rec_normal, rec_uniform
    try:
        yield draws
    finally:
        jax.random.normal, jax.random.uniform = normal, uniform


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _gm_dual_values(rng, steps, batch, length, num_classes):
    rng, ra, rb, rua, rub = jax.random.split(rng, 5)
    f0_shape, uv_shape = (batch, length, 1), (batch, num_classes, length)
    out = [jax.random.normal(ra, f0_shape), jax.random.normal(rb, f0_shape),
           jax.random.uniform(rua, uv_shape),
           jax.random.uniform(rub, uv_shape)]
    for rng_i in jax.random.split(rng, steps):
        for r in jax.random.split(rng_i):
            rg, rc = jax.random.split(r)
            out += [jax.random.normal(rg, f0_shape),
                    jax.random.uniform(rc, uv_shape)]
    return out


def gm_dual_draws(rng, steps: int, batch: int, length: int,
                  num_classes: int = 2):
    """The draws of ``diffusion.sample_gm_dual(rng)`` (un-strided), in
    order, replayed from its key splits: normal z_a, z_b, uniform u_a, u_b,
    then per step and chain (a, b) a normal and a uniform."""
    kinds = ["n", "n", "u", "u"] + ["n", "u"] * (2 * steps)
    return list(zip(kinds, _gm_dual_values(rng, steps, batch, length,
                                           num_classes)))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _shallow_values(rng, k_step, shape):
    rng, rng_q = jax.random.split(rng)
    return [jax.random.normal(rng_q, shape)] + [
        jax.random.normal(r, shape) for r in jax.random.split(rng, k_step)]


def shallow_draws(rng, k_step: int, shape):
    """The draws of ``diffusion.sample_shallow(rng)``, in order."""
    return [("n", v) for v in _shallow_values(rng, k_step, tuple(shape))]


@contextlib.contextmanager
def sampler_keys(keys: dict):
    """Capture the keys the StyleSinger model hands its two samplers."""
    from stylesinger_tpu.models import diffusion as diff

    gm, sh = diff.sample_gm_dual, diff.sample_shallow

    def gm_rec(fa, fb, sched, cond_t, batch, rng, *a, **k):
        keys["gm"] = rng
        return gm(fa, fb, sched, cond_t, batch, rng, *a, **k)

    def sh_rec(fn, sched, coarse, rng, *a, **k):
        keys["sh"] = rng
        return sh(fn, sched, coarse, rng, *a, **k)

    diff.sample_gm_dual, diff.sample_shallow = gm_rec, sh_rec
    try:
        yield keys
    finally:
        diff.sample_gm_dual, diff.sample_shallow = gm, sh


class Replay:
    """Noise source for the port that returns recorded draws in order."""

    def __init__(self, draws, device="cpu"):
        self.draws = list(draws)
        self.device = device

    def _next(self, kind, shape):
        assert self.draws, f"no recorded draw left for {kind}{tuple(shape)}"
        k, a = self.draws.pop(0)
        assert k == kind and a.shape == tuple(shape), (
            f"draw order differs: recorded {k}{a.shape}, "
            f"asked {kind}{tuple(shape)}")
        return torch.tensor(np.asarray(a), device=self.device)

    def normal(self, shape):
        return self._next("n", shape)

    def uniform(self, shape):
        return self._next("u", shape)


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
