"""The port's fast samplers against the JAX package's, function by function.

Each sampler runs with a small denoiser stand-in that both frameworks
compute alike, on the JAX package's schedules, with JAX's own draws
replayed into the port (``tests/torch_parity.py``).  f0 and mel agree at
atol 2e-4 / rtol 2e-3; uv decisions are exactly equal.  The denoiser calls
are counted on both sides (JAX's with a host callback, so a branch that
``lax.switch`` does not take is not counted).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylesinger_tpu.models import diffusion as jdiff
from torch_parity import (
    Replay, gm_dual_draws, prodiff_draws, shallow_draws, to_np,
)

from stylesinger_torch.models import diffusion as tdiff

TOL = dict(atol=2e-4, rtol=2e-3)
B, T, M = 2, 12, 6


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(shape).astype(np.float32)
            for k, shape in (("cond_f0", (B, T, 3)), ("cond_mel", (B, T, M)),
                             ("coarse", (B, T, M)))}


class _Calls:
    def __init__(self):
        self.n = 0

    def tick(self):
        self.n += 1


def _f0_fns(xp, cond, calls, host=False):
    """Two denoiser stand-ins for the dual F0 sampler: (f0, uv, t) ->
    [B, T, 3] eps and uv logits, in numpy-like ``xp`` (jnp or torch)."""
    def make(sign):
        def fn(z, uv, t):
            if host:
                jax.debug.callback(calls.tick)
            else:
                calls.tick()
            tt = t.reshape(-1, 1, 1).astype(np.float32) if host else \
                t.reshape(-1, 1, 1).to(torch.float32)
            u = uv[..., None].astype(np.float32) if host else \
                uv[..., None].to(torch.float32)
            eps = xp.tanh(0.7 * z + 0.03 * tt + 0.3 * u + cond[..., :1])
            l0 = sign * (0.5 * z - 0.02 * tt) + cond[..., 1:2]
            l1 = -sign * (0.4 * z + 0.5 * u) + cond[..., 2:3]
            return xp.concatenate([eps, l0, l1], -1) if host else \
                torch.cat([eps, l0, l1], -1)
        return fn
    return make(1.0), make(-1.0)


def _mel_fn(xp, cond, calls, host=False, x0=False):
    def fn(x, t):
        if host:
            jax.debug.callback(calls.tick)
            tt = t.reshape(-1, 1, 1).astype(np.float32)
        else:
            calls.tick()
            tt = t.reshape(-1, 1, 1).to(torch.float32)
        out = xp.tanh(0.8 * x + 0.02 * tt + cond)
        return 0.9 * out if x0 else out
    return fn


def _clip_bounds(seed):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-0.9, -0.2, (B, T, 1)).astype(np.float32)
    return lo, lo + 0.6


def test_gaussian_ddim_jump_matches_jax():
    sched_j = jdiff.make_schedule(20, 0.06)
    sched_t = tdiff.make_schedule(20, 0.06)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T, 1)).astype(np.float32)
    eps = rng.standard_normal((B, T, 1)).astype(np.float32)
    lo, hi = _clip_bounds(1)
    for t_val, tp_val in ((19, 14), (4, -1), (7, 6)):
        t, tp = np.full(B, t_val), np.full(B, tp_val)
        ref = jdiff._gaussian_ddim_jump(
            sched_j, jnp.asarray(x), jnp.asarray(t), jnp.asarray(tp),
            jnp.asarray(eps), (jnp.asarray(lo), jnp.asarray(hi)))
        out = tdiff._gaussian_ddim_jump(
            sched_t, torch.tensor(x), torch.tensor(t), torch.tensor(tp),
            torch.tensor(eps), (torch.tensor(lo), torch.tensor(hi)))
        np.testing.assert_allclose(to_np(out), np.asarray(ref), **TOL)


def test_cat_q_posterior_strided_matches_jax_and_reduces_to_one_step():
    sched_j = jdiff.make_schedule(20, 0.06)
    sched_t = tdiff.make_schedule(20, 0.06)
    rng = np.random.default_rng(2)
    log_x0 = np.log(rng.dirichlet([1, 1], (B, T)).transpose(0, 2, 1)
                    ).astype(np.float32)
    log_xt = np.log(np.clip(rng.dirichlet([1, 1], (B, T)).transpose(0, 2, 1),
                            1e-30, None)).astype(np.float32)
    args_t = (torch.tensor(log_x0), torch.tensor(log_xt))
    for t_val, tp_val in ((19, 14), (3, -1), (10, 9)):
        t, tp = np.full(B, t_val), np.full(B, tp_val)
        ref = jdiff.cat_q_posterior_strided(
            sched_j, jnp.asarray(log_x0), jnp.asarray(log_xt),
            jnp.asarray(t), jnp.asarray(tp), 2)
        out = tdiff.cat_q_posterior_strided(
            sched_t, *args_t, torch.tensor(t), torch.tensor(tp), 2)
        np.testing.assert_allclose(to_np(out), np.asarray(ref), **TOL)
    t = torch.full((B,), 10)
    one_step = tdiff.cat_q_posterior(sched_t, *args_t, t, 2)
    strided = tdiff.cat_q_posterior_strided(sched_t, *args_t, t, t - 1, 2)
    np.testing.assert_allclose(to_np(strided), to_np(one_step), atol=1e-5)


@pytest.mark.parametrize("speedup", [5, 2])
def test_strided_dual_f0_sampler_matches_jax(speedup):
    steps = 20
    inp = _inputs(3)
    lo, hi = _clip_bounds(4)
    key = jax.random.PRNGKey(5)
    jcalls, tcalls = _Calls(), _Calls()
    fa, fb = _f0_fns(jnp, jnp.asarray(inp["cond_f0"]), jcalls, host=True)
    (ja, jua), (jb, jub) = jdiff.sample_gm_dual(
        fa, fb, jdiff.make_schedule(steps, 0.06), T, B, key,
        dyn_clip=(jnp.asarray(lo), jnp.asarray(hi)), speedup=speedup)
    jax.effects_barrier()
    noise = Replay(gm_dual_draws(key, steps, B, T, speedup=speedup))
    fa, fb = _f0_fns(torch, torch.tensor(inp["cond_f0"]), tcalls)
    (ta, tua), (tb, tub) = tdiff.sample_gm_dual(
        fa, fb, tdiff.make_schedule(steps, 0.06), T, B, noise,
        dyn_clip=(torch.tensor(lo), torch.tensor(hi)), speedup=speedup)
    assert noise.draws == []
    for ours, ref in ((ta, ja), (tb, jb)):
        np.testing.assert_allclose(to_np(ours), np.asarray(ref), **TOL)
    for ours, ref in ((tua, jua), (tub, jub)):
        np.testing.assert_array_equal(to_np(ours), np.asarray(ref))
    assert tcalls.n == jcalls.n == 2 * len(range(steps - 1, -1, -speedup))


@pytest.mark.parametrize("speedup", [5, 2])
def test_plms_sampler_matches_jax(speedup):
    k_step = 20
    inp = _inputs(6)
    key = jax.random.PRNGKey(7)
    jcalls, tcalls = _Calls(), _Calls()
    ref = jdiff.sample_shallow_plms(
        _mel_fn(jnp, jnp.asarray(inp["cond_mel"]), jcalls, host=True),
        jdiff.make_schedule(k_step, 0.06), jnp.asarray(inp["coarse"]), key,
        k_step, speedup)
    jax.effects_barrier()
    noise = Replay(shallow_draws(key, k_step, (B, T, M), ancestral=False))
    out = tdiff.sample_shallow_plms(
        _mel_fn(torch, torch.tensor(inp["cond_mel"]), tcalls),
        tdiff.make_schedule(k_step, 0.06), torch.tensor(inp["coarse"]),
        noise, k_step, speedup)
    assert noise.draws == []
    np.testing.assert_allclose(to_np(out), np.asarray(ref), **TOL)
    assert tcalls.n == jcalls.n == k_step // speedup + 1


@pytest.mark.parametrize("n_steps", [4, 10])
def test_dpmpp_sampler_matches_jax(n_steps):
    k_step = 20
    inp = _inputs(8)
    key = jax.random.PRNGKey(9)
    jcalls, tcalls = _Calls(), _Calls()
    ref = jdiff.sample_shallow_dpmpp(
        _mel_fn(jnp, jnp.asarray(inp["cond_mel"]), jcalls, host=True),
        jdiff.make_schedule(k_step, 0.06), jnp.asarray(inp["coarse"]), key,
        k_step, n_steps)
    jax.effects_barrier()
    sched = tdiff.make_schedule(k_step, 0.06)
    noise = Replay(shallow_draws(key, k_step, (B, T, M), ancestral=False))
    out = tdiff.sample_shallow_dpmpp(
        _mel_fn(torch, torch.tensor(inp["cond_mel"]), tcalls), sched,
        torch.tensor(inp["coarse"]), noise, k_step, n_steps)
    assert noise.draws == []
    np.testing.assert_allclose(to_np(out), np.asarray(ref), **TOL)
    grid, _ = tdiff.dpmpp_grid(sched, k_step, n_steps)
    assert tcalls.n == jcalls.n == len(grid)


def test_prodiff_sampler_and_schedule_match_jax():
    steps = 4
    inp = _inputs(10)
    key = jax.random.PRNGKey(11)
    sched_j = jdiff.make_prodiff_schedule(steps)
    sched_t = tdiff.make_prodiff_schedule(steps)
    for name in tdiff._FIELDS:
        np.testing.assert_allclose(to_np(getattr(sched_t, name)),
                                   np.asarray(getattr(sched_j, name)),
                                   rtol=1e-6, atol=0)
    jcalls, tcalls = _Calls(), _Calls()
    ref = jdiff.sample_prodiff(
        _mel_fn(jnp, jnp.asarray(inp["cond_mel"]), jcalls, host=True,
                x0=True), sched_j, steps, (B, T, M), key)
    jax.effects_barrier()
    noise = Replay(prodiff_draws(key, steps, (B, T, M)))
    out = tdiff.sample_prodiff(
        _mel_fn(torch, torch.tensor(inp["cond_mel"]), tcalls, x0=True),
        sched_t, steps, (B, T, M), noise)
    assert noise.draws == []
    np.testing.assert_allclose(to_np(out), np.asarray(ref), **TOL)
    assert tcalls.n == jcalls.n == steps


@pytest.mark.parametrize("kind", ["linear", "cosine"])
def test_schedules_match_jax(kind):
    sched_j = jdiff.make_schedule(30, 0.06, kind)
    sched_t = tdiff.make_schedule(30, 0.06, kind)
    for name in tdiff._FIELDS:
        np.testing.assert_array_equal(to_np(getattr(sched_t, name)),
                                      np.asarray(getattr(sched_j, name)))
