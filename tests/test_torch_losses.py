"""The port's training pieces against the JAX package's, on the CPU: the
losses of ``training/losses.py``, both diffusion losses, the schedules and
curriculum, the optimizer against optax, the RQ codebooks' EMA update and
UMLN in training mode.

Same numpy inputs and weights on both sides; JAX's draws are replayed into
the port (``torch_parity.Replay``).  Tolerance atol 2e-4 / rtol 2e-3
(``tests/test_convert.py``) unless a test states another; codes and masks
are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stylesinger_tpu.config import tiny_test_config
from stylesinger_tpu.models import diffusion as jd
from stylesinger_tpu.training import losses as jl
from stylesinger_tpu.training import schedules as js
from stylesinger_tpu.training import step as jstep
from torch_parity import (
    Replay, one_torch_thread, random_variables, stash_draws, to_np,
)

from stylesinger_torch.config import tiny_test_config as torch_tiny
from stylesinger_torch.convert import from_jax_params
from stylesinger_torch.models import diffusion as td
from stylesinger_torch.training import losses as tl
from stylesinger_torch.training import schedules as ts
from stylesinger_torch.training import step as tstep

# the fixture, imported above, runs this module on one torch thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = dict(atol=2e-4, rtol=2e-3)


def _close(ours, ref, **tol):
    np.testing.assert_allclose(to_np(ours), np.asarray(ref), **(tol or TOL))


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _masked_mels(seed, b=3, t=40, m=16):
    rng = _rng(seed)
    target = rng.standard_normal((b, t, m)).astype(np.float32) - 2.0
    target[1, 30:] = 0.0
    target[b - 1, 12:] = 0.0
    pred = target + 0.3 * rng.standard_normal((b, t, m)).astype(np.float32)
    return pred, target


# ---------------------------------------------------------------- losses

def test_ssim_and_filter_match_jax():
    pred, target = _masked_mels(0)
    _close(tl._filter2d(_t(pred)), jl._filter2d(jnp.asarray(pred)))
    _close(tl.ssim(_t(pred) + 6, _t(target) + 6),
           jl.ssim(jnp.asarray(pred) + 6, jnp.asarray(target) + 6))


@pytest.mark.parametrize("spec", ["l1:0.5|ssim:0.5", "mse|l1:0.25"])
def test_mel_losses_match_jax(spec):
    pred, target = _masked_mels(1)
    assert tl.parse_mel_loss(spec) == jl.parse_mel_loss(spec)
    ref = jl.mel_losses(jnp.asarray(pred), jnp.asarray(target), spec, "_x")
    ours = tl.mel_losses(_t(pred), _t(target), spec, "_x")
    assert set(ours) == set(ref)
    for k in ref:
        _close(ours[k], ref[k])


def _durations(seed):
    rng = _rng(seed)
    txt = np.array([[3, 5, 7, 2, 9, 0, 0, 0], [4, 4, 1, 6, 0, 0, 0, 0]])
    mel2ph = np.zeros((2, 40), np.int64)
    mel2ph[0, :33] = np.repeat(np.arange(1, 6), [5, 8, 6, 7, 7])
    mel2ph[1, :20] = np.repeat(np.arange(1, 5), [4, 6, 3, 7])
    log_dur = rng.standard_normal(txt.shape).astype(np.float32) + 1.5
    is_sil = np.array([[0, 1, 0, 0, 1, 0, 0, 0], [0, 0, 1, 0, 0, 0, 0, 0]],
                      np.float32)
    return txt, mel2ph, log_dur, is_sil


def test_mel2ph_to_dur_matches_jax():
    from stylesinger_tpu.dsp.align import mel2ph_to_dur as jdur

    from stylesinger_torch.dsp.align import mel2ph_to_dur

    _, mel2ph, _, _ = _durations(0)
    mel2ph[1, 25] = 11   # past the phones: dropped on both sides
    for max_dur in (None, 6):
        np.testing.assert_array_equal(
            to_np(mel2ph_to_dur(_t(mel2ph), 8, max_dur)),
            np.asarray(jdur(jnp.asarray(mel2ph), 8, max_dur)))


@pytest.mark.parametrize("word", [0.0, 1.0], ids=["sentence", "word"])
def test_duration_losses_match_jax(word):
    cfg = tiny_test_config(lambda_word_dur=word)
    txt, mel2ph, log_dur, is_sil = _durations(2)
    ref = jl.duration_losses(jnp.asarray(log_dur), jnp.asarray(mel2ph),
                             jnp.asarray(txt), cfg, is_sil=jnp.asarray(is_sil))
    ours = tl.duration_losses(_t(log_dur), _t(mel2ph), _t(txt), cfg,
                              is_sil=_t(is_sil))
    assert set(ours) == set(ref) == ({"pdur", "sdur", "wdur"} if word else
                                     {"pdur", "sdur"})
    for k in ref:
        _close(ours[k], ref[k])


@pytest.mark.parametrize("pitch_loss", ["l1", "l2"])
def test_f0_uv_losses_match_jax(pitch_loss):
    cfg = tiny_test_config(pitch_loss=pitch_loss)
    rng = _rng(3)
    pred = rng.standard_normal((2, 30, 2)).astype(np.float32)
    f0 = rng.standard_normal((2, 30)).astype(np.float32)
    uv = (rng.uniform(size=(2, 30)) > 0.7).astype(np.float32)
    nonpadding = np.ones((2, 30), np.float32)
    nonpadding[1, 20:] = 0
    ref = jl.f0_uv_losses(*(jnp.asarray(a) for a in (pred, f0, uv,
                                                     nonpadding)), cfg)
    ours = tl.f0_uv_losses(*(_t(a) for a in (pred, f0, uv, nonpadding)), cfg)
    assert set(ours) == set(ref) == {"uv", "f0"}
    for k in ref:
        _close(ours[k], ref[k])


@pytest.mark.parametrize("flags", [(True, False, True), (False, True, False)],
                         ids=["rq_diff", "forcing"])
@pytest.mark.parametrize("f0_gen", ["gmdiff", "conv"])
def test_compute_losses_matches_jax(flags, f0_gen):
    cfg = tiny_test_config(f0_gen=f0_gen)
    use_rq, forcing, use_diff = flags
    pred, target = _masked_mels(4, b=2, m=cfg["audio_num_mel_bins"])
    txt, mel2ph, log_dur, _ = _durations(5)
    rng = _rng(6)
    ret = {"mel_out": pred, "dur": log_dur,
           "pitch_pred": rng.standard_normal((2, 40, 2)).astype(np.float32)}
    for k in ("diff_loss", "gloss", "rq_loss", "gdiff1", "mdiff1", "gdiff2",
              "mdiff2"):
        ret[k] = np.float32(rng.uniform())
    batch = {"mels": target, "mel2ph": mel2ph, "txt_tokens": txt,
             "f0": rng.standard_normal((2, 40)).astype(np.float32),
             "uv": (rng.uniform(size=(2, 40)) > 0.5).astype(np.float32)}
    kw = dict(use_rq=use_rq, forcing=forcing, use_diff=use_diff)
    ref = jl.compute_losses({k: jnp.asarray(v) for k, v in ret.items()},
                            {k: jnp.asarray(v) for k, v in batch.items()},
                            cfg, **kw)
    ours = tl.compute_losses({k: _t(v) for k, v in ret.items()},
                             {k: _t(v) for k, v in batch.items()}, cfg, **kw)
    assert list(ours) == list(ref)
    for k in ref:
        _close(ours[k], ref[k])
    _close(tstep.total_loss(ours), sum(jax.tree_util.tree_leaves(ref)))


def test_multi_resolution_stft_loss_matches_jax():
    rng = _rng(7)
    y = rng.standard_normal((2, 4800)).astype(np.float32) * 0.3
    x = y + 0.05 * rng.standard_normal((2, 4800)).astype(np.float32)
    ref = jl.multi_resolution_stft_loss(jnp.asarray(x), jnp.asarray(y))
    ours = tl.multi_resolution_stft_loss(_t(x), _t(y))
    for o, r in zip(ours, ref):
        _close(o, r)


# ------------------------------------------------------ diffusion losses

def test_gm_mixed_loss_matches_jax():
    rng = _rng(8)
    b, t = 3, 24
    sched_j = jd.make_schedule(4, 0.06, "linear")
    sched_t = td.make_schedule(4, 0.06, "linear")
    f0 = rng.uniform(-1, 1, (b, t, 1)).astype(np.float32)
    uv = (rng.uniform(size=(b, t)) > 0.6).astype(np.float32)
    cond = rng.standard_normal((b, t, 8)).astype(np.float32)
    nonpadding = np.ones((b, t), np.float32)
    nonpadding[2, 15:] = 0
    # a fixed affine map of [f0_t | uv_t | cond] and t -> [B, T, 1 + 2]
    w = rng.standard_normal((10, 3)).astype(np.float32) * 0.3
    t_w = rng.standard_normal(3).astype(np.float32) * 0.1

    def jax_denoise(f0_t, uv_t, tt):
        h = jnp.concatenate([f0_t, uv_t[..., None].astype(jnp.float32),
                             jnp.asarray(cond)], -1)
        return h @ w + tt[:, None, None] * t_w

    def torch_denoise(f0_t, uv_t, tt):
        h = torch.cat([f0_t, uv_t[..., None].float(), _t(cond)], -1)
        return h @ _t(w) + tt[:, None, None] * _t(t_w)

    def jax_fn(key):
        draws = []
        with stash_draws(draws):
            out = jd.gm_mixed_loss(jax_denoise, sched_j, jnp.asarray(f0),
                                   jnp.asarray(uv), jnp.asarray(cond),
                                   jnp.asarray(nonpadding), key)
        kinds[:] = [kind for kind, _ in draws]
        return out, [v for _, v in draws]

    kinds = []
    (m_ref, g_ref), draws = jax.jit(jax_fn)(jax.random.PRNGKey(3))
    assert kinds == ["i", "n", "u"]
    m_t, g_t = td.gm_mixed_loss(torch_denoise, sched_t, _t(f0), _t(uv),
                                _t(nonpadding),
                                Replay(list(zip(kinds, draws))))
    _close(m_t, m_ref)
    _close(g_t, g_ref)


@pytest.mark.parametrize("masked", [True, False])
def test_shallow_p_losses_matches_jax(masked):
    rng = _rng(10)
    b, t, m = 2, 20, 16
    sched_j = jd.make_schedule(8, 0.06, "linear")
    sched_t = td.make_schedule(8, 0.06, "linear")
    x0 = rng.uniform(-1, 1, (b, t, m)).astype(np.float32)
    nonpadding = np.ones((b, t), np.float32)
    nonpadding[1, 14:] = 0
    w = rng.standard_normal((m, m)).astype(np.float32) * 0.2

    def jax_fn(key):
        draws = []
        with stash_draws(draws):
            out = jd.shallow_p_losses(
                lambda x, tt: x @ jnp.asarray(w) + tt[:, None, None] * 0.01,
                sched_j, jnp.asarray(x0), None, key, 6,
                nonpadding=jnp.asarray(nonpadding) if masked else None)
        kinds[:] = [kind for kind, _ in draws]
        return out, [v for _, v in draws]

    kinds = []
    ref, draws = jax.jit(jax_fn)(jax.random.PRNGKey(4))
    assert kinds == ["i", "n"]
    ours = td.shallow_p_losses(
        lambda x, tt: x @ _t(w) + tt[:, None, None] * 0.01, sched_t, _t(x0),
        Replay(list(zip(kinds, draws))), 6,
        nonpadding=_t(nonpadding) if masked else None)
    _close(ours, ref)


def test_noise_randint_and_bernoulli():
    noise = td.Noise(0, "cpu")
    t = noise.randint((1000,), 0, 4)
    assert t.dtype == torch.int64 and set(t.tolist()) == {0, 1, 2, 3}
    mask = noise.bernoulli(0.9, (10000,))
    assert mask.dtype == torch.bool and 0.88 < mask.float().mean() < 0.92
    assert noise.bernoulli(0.5).shape == ()


# ------------------------------------------------ schedules, curriculum

def test_rsqrt_schedule_matches_jax():
    cfg = tiny_test_config(diff_start=40)
    jsched = js.rsqrt_schedule(cfg["lr"], cfg["warmup_updates"],
                               cfg["hidden_size"])
    tsched = ts.make_schedule(cfg)
    steps = [0, 1, 2, 3, cfg["warmup_updates"], cfg["diff_start"], 5000]
    for s in steps:
        np.testing.assert_allclose(tsched(s), float(jsched(s)), rtol=1e-6)
    assert tsched(0) == tsched(1)
    assert ts.check_diff_start_lr(cfg) == pytest.approx(
        js.check_diff_start_lr(cfg), rel=1e-6)
    assert ts.make_schedule(dict(cfg, scheduler="none"))(7) == \
        pytest.approx(cfg["lr"])


def test_phases_and_boundaries_match_jax():
    cfg = tiny_test_config(forcing=3, rq_start=5, diff_start=8)
    for decoder in ("diffsinger", "fft"):
        c = dict(cfg, decoder=decoder)
        for s in range(12):
            assert tuple(tstep.phase_for_step(s, c)) == \
                tuple(jstep.phase_for_step(s, c))
        assert tstep.phase_boundaries(c) == jstep.phase_boundaries(c)


def test_step_noise_depends_on_seed_step_and_stream():
    a = tstep.step_noise(1, 5, "cpu")
    b = tstep.step_noise(1, 5, "cpu")
    assert list(a) == list(tstep.STREAMS)
    draws = {k: v.normal((4,)) for k, v in a.items()}
    for k, v in b.items():
        assert torch.equal(v.normal((4,)), draws[k])
    assert len({tuple(v.tolist()) for v in draws.values()}) == 4
    other = tstep.step_noise(1, 6, "cpu")["dropout"].normal((4,))
    assert not torch.equal(other, draws["dropout"])


# ------------------------------------------------------------ optimizer

def _tree(seed, scale=1.0):
    rng = _rng(seed)
    return {"a": rng.standard_normal((3, 4)).astype(np.float32) * scale,
            "b": rng.standard_normal((5,)).astype(np.float32) * scale,
            "c": np.zeros((2, 2), np.float32)}


@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_optimizer_matches_optax(scale, weight_decay):
    """Three steps: the clip at global norm 1 (optax scales only when the
    norm reaches it), AdamW's moments and bias corrections, and the
    schedule at the count before each update.  A missing gradient counts as
    zero.  Tolerance rtol 1e-5 / atol 1e-7."""
    cfg = tiny_test_config(weight_decay=weight_decay, warmup_updates=3)
    params = _tree(0)
    tx = jstep.make_optimizer(cfg)
    state = tx.init(params)
    tparams = {k: torch.nn.Parameter(_t(v).clone()) for k, v in params.items()}
    opt = tstep.Optimizer(tparams, cfg)
    for i in range(3):
        grads = _tree(i + 1, scale)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        norm = opt.step(list(tparams.values()),
                        [_t(grads["a"]), _t(grads["b"]), None])
        _close(norm, optax.global_norm(grads), rtol=1e-6, atol=0)
        for k in params:
            _close(tparams[k], params[k], rtol=1e-5, atol=1e-7)
    assert opt.count == 3


def test_optimizer_accumulation_matches_optax_multisteps():
    cfg = tiny_test_config(accumulate_grad_batches=3)
    params = _tree(0)
    tx = jstep.make_optimizer(cfg)
    state = tx.init(params)
    tparams = {k: torch.nn.Parameter(_t(v).clone()) for k, v in params.items()}
    opt = tstep.Optimizer(tparams, cfg)
    for i in range(7):
        grads = _tree(i + 1, 0.5)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        opt.step(list(tparams.values()), [_t(grads[k]) for k in params])
        for k in params:
            _close(tparams[k], params[k], rtol=1e-5, atol=1e-7)
    assert (opt.count, opt.mini_step) == (2, 1)


def test_optimizer_state_round_trips():
    cfg = tiny_test_config(accumulate_grad_batches=2)
    tparams = {k: torch.nn.Parameter(_t(v)) for k, v in _tree(0).items()}
    opt = tstep.Optimizer(tparams, cfg)
    for i in range(3):
        opt.step(list(tparams.values()),
                 [_t(v) for v in _tree(i + 1).values()])
    again = tstep.Optimizer(tparams, cfg)
    again.load_state_dict(opt.state_dict())
    assert (again.count, again.mini_step) == (opt.count, opt.mini_step)
    for key in ("mu", "nu", "acc"):
        for x, y in zip(getattr(again, key), getattr(opt, key)):
            assert torch.equal(x, y)


# ----------------------------------------------------- RQ and UMLN train

def _rq_inputs(seed, b=2, t=12, d=16):
    rng = _rng(seed)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    nonpadding = np.ones((b, t), np.float32)
    nonpadding[1, 7:] = 0
    x[1, 7:] = 0
    return x, nonpadding


@pytest.mark.parametrize("n_embed", [8, 64], ids=["few_codes", "restart_many"])
def test_vq_embedding_update_matches_jax(n_embed):
    """One EMA step of a codebook: the buffers after it, the codes (found
    before the update) and their vectors (read after it).  With 64 codes
    and 24 vectors the restart tiles the inputs three times; the restart
    vectors come from real frames first."""
    from stylesinger_tpu.models import rq as jrq

    from stylesinger_torch.models import rq as trq

    x, nonpadding = _rq_inputs(11)
    vq = jrq.VQEmbedding(n_embed, 16)
    v = random_variables(vq.init, {"params": jax.random.PRNGKey(0)},
                         jnp.asarray(x), seed=12)
    v["codebook"]["cluster_size_ema"] = _rng(13).uniform(
        0, 2, n_embed).astype(np.float32)

    def f(variables, key):
        draws = []
        with stash_draws(draws):
            (emb, idx), upd = vq.apply(
                variables, jnp.asarray(x), train=True, rng=key,
                mask=jnp.asarray(nonpadding), mutable=["codebook"])
        return emb, idx, upd["codebook"], [d for _, d in draws]

    emb, idx, cb, draws = jax.jit(f)(v, jax.random.PRNGKey(5))
    port = trq.VQEmbedding(n_embed, 16)
    port.load_state_dict(from_jax_params(v))
    t_emb, t_idx = port(_t(x), Replay([("u", d) for d in draws]),
                        _t(nonpadding))
    np.testing.assert_array_equal(to_np(t_idx), np.asarray(idx))
    _close(t_emb, emb)
    for name in ("embedding", "cluster_size_ema", "embed_ema"):
        _close(getattr(port, name), cb[name])
    restarted = np.asarray(cb["cluster_size_ema"]) == 1.0
    assert restarted.any()


def test_rq_bottleneck_train_matches_jax():
    """Depth-2 residual quantizer in training: the straight-through output,
    the cumulative commitment loss (padded frames out), the codes and
    every codebook's buffers; and the gradient of the loss to the input."""
    from stylesinger_tpu.models import rq as jrq

    from stylesinger_torch.models import rq as trq

    x, nonpadding = _rq_inputs(14)
    rq = jrq.RQBottleneck(8, 16, rq_depth=2)
    v = random_variables(rq.init, {"params": jax.random.PRNGKey(0)},
                         jnp.asarray(x), seed=15)

    def f(variables, xin, key):
        draws = []

        def loss(xin):
            with stash_draws(draws):
                (q, commit, codes), upd = rq.apply(
                    variables, xin, train=True, rng=key,
                    nonpadding=jnp.asarray(nonpadding), mutable=["codebook"])
            return (q ** 2).sum() + commit, (q, commit, codes, upd)

        (_, aux), grad = jax.value_and_grad(loss, has_aux=True)(xin)
        return aux, grad, [d for _, d in draws]

    (q, commit, codes, upd), grad, draws = jax.jit(f)(
        v, jnp.asarray(x), jax.random.PRNGKey(6))
    port = trq.RQBottleneck(8, 16, rq_depth=2)
    port.load_state_dict(from_jax_params(v))
    xt = _t(x).requires_grad_(True)
    tq, tcommit, tcodes = port(xt, Replay([("u", d) for d in draws]),
                               _t(nonpadding))
    ((tq ** 2).sum() + tcommit).backward()
    np.testing.assert_array_equal(to_np(tcodes), np.asarray(codes))
    _close(tq, q)
    _close(tcommit, commit)
    _close(xt.grad, grad)
    ours = port.state_dict()
    for name, value in from_jax_params({"codebook": upd["codebook"]}).items():
        _close(ours[name], value)


@pytest.mark.parametrize("batch", [3, 1])
@pytest.mark.parametrize("coin", [True, False], ids=["applied", "skipped"])
def test_umln_train_matches_jax(coin, batch):
    """Training-mode UMLN with the coin both ways (the recorded coin is set
    on both sides), and at B = 1, where the batch std is zero; gradients of
    a loss to the input and to the affine layer."""
    from stylesinger_tpu.models.umln import UMLN as JUMLN

    from stylesinger_torch.models.umln import UMLN

    rng = _rng(16)
    x = rng.standard_normal((batch, 10, 16)).astype(np.float32)
    s = rng.standard_normal((batch, 1, 16)).astype(np.float32)
    m = JUMLN(16)
    v = random_variables(m.init, {"params": jax.random.PRNGKey(0)},
                         jnp.asarray(x), jnp.asarray(s), seed=17)
    normal, bern = jax.random.normal, jax.random.bernoulli
    draws = []

    def forced_bernoulli(key, p=0.5, shape=None, *a, **k):
        out = jnp.full(() if shape is None else shape, coin)
        draws.append(("b", out))
        return out

    def rec_normal(*a, **k):
        out = normal(*a, **k)
        draws.append(("n", out))
        return out

    def f(variables, xin):
        def loss(variables, xin):
            y = m.apply(variables, xin, jnp.asarray(s), train=True,
                        rngs={"umln": jax.random.PRNGKey(9)})
            return (y * jnp.arange(16.0)).sum(), y
        jax.random.normal, jax.random.bernoulli = rec_normal, forced_bernoulli
        try:
            (_, y), grads = jax.value_and_grad(loss, (0, 1), has_aux=True)(
                variables, xin)
        finally:
            jax.random.normal, jax.random.bernoulli = normal, bern
        return y, grads, [d for _, d in draws]

    y, (gv, gx), values = jax.jit(f)(v, jnp.asarray(x))
    assert [k for k, _ in draws] == ["n", "n", "b"]
    port = UMLN(16)
    port.load_state_dict(from_jax_params(v))
    xt = _t(x).requires_grad_(True)
    out = port(xt, _t(s), Replay(list(zip("nnb", values))))
    (out * torch.arange(16.0)).sum().backward()
    _close(out, y)
    _close(xt.grad, gx)
    _close(port.affine.weight.grad, np.asarray(gv["params"]["affine"]
                                               ["kernel"]).T)
    if not coin:
        np.testing.assert_array_equal(to_np(out), x)


# -------------------------------------------------------------- convert

def test_converted_codebooks_equal_jax_leaf_for_leaf():
    """``from_jax_params`` carries the whole ``codebook`` collection (the
    codebooks and their EMA statistics) into the RQ buffers."""
    from stylesinger_tpu.models.stylesinger import StyleSinger as JaxSS

    from stylesinger_torch.models.stylesinger import StyleSinger

    from test_torch_train import synthetic_batch

    cfg = tiny_test_config()
    b = {k: jnp.asarray(v) for k, v in synthetic_batch(cfg, 0).items()}
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(
        ("params",) + jstep._RNG_STREAMS)}
    v = random_variables(JaxSS(cfg, 20).init, rngs, **jstep._model_inputs(b),
                         infer=False, use_rq=True, forcing=False,
                         use_diff=True, seed=3)
    rq = v["codebook"]["style_extractor"]["rq"]
    for i, cb in enumerate(rq.values()):
        cb["cluster_size_ema"] = _rng(i).uniform(0, 3, cb[
            "cluster_size_ema"].shape).astype(np.float32)
        cb["embed_ema"] = cb["embed_ema"] * 1.5
    model = StyleSinger(torch_tiny(), 20)
    model.load_state_dict(from_jax_params(v))
    buffers = dict(model.named_buffers())
    leaves = jax.tree_util.tree_leaves_with_path(v["codebook"])
    assert len(leaves) == 3 * cfg["rq_depth"]
    for path, value in leaves:
        name = ".".join(str(p.key) for p in path)
        np.testing.assert_array_equal(to_np(buffers[name]), value)
