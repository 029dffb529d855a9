"""Vocoder GAN training of the port against the JAX package's, on the CPU.

At ``tiny_test_config`` with the audio of ``tests/test_training.py``'s
vocoder tests (16 kHz, hop 64, n_fft 256, 16 mel bins) and ``mrf_block``
64, so that the generator's last three stages run over overlap-save blocks:
the discriminators and GAN losses, the differentiable batched log-mel, the
generator's gradient through a blocked stage, one discriminator + generator
iteration against ``make_vocoder_bodies`` (adamw, radam, and with the
multi-resolution STFT loss), two iterations of ``make_vocoder_scan``, the
host and device crops, and a resumed ``fit_vocoder``.  Weights are seeded
numpy (``random_variables``) through ``from_jax_params``; the port replays
JAX's draws (``stash_draws`` / ``Replay``).

Tolerances: outputs, features, losses and metrics atol 2e-4 / rtol 2e-3
(``tests/test_convert.py``), gradients per leaf rtol 2e-3 with atol 2e-4 x
max|g_leaf| (floor 1e-7 x max|g|), the log-mel's gradient the same over the
whole array; with the multi-resolution STFT loss the generator's gradients at
atol 1e-2 x max|g_leaf|: its log-magnitudes amplify the rounding of nearly
empty bins, and against an f64 evaluation of the same step JAX's own f32
gradient is off by up to 5.5e-3 x max|g_leaf| (the port's by 2.8e-3);
parameters after an update as ``tests/test_torch_train.py``
holds them: atol 0.05 x lr where JAX's gradient is >= 1e-6 (Adam's first
step turns the f32 rounding of a smaller gradient into a sizeable share of
lr), and every parameter against optax's own update of the port's
gradients at atol 1e-3 x lr.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stylesinger_tpu.config import tiny_test_config
from stylesinger_tpu.dsp.mel import wav2mel as jax_wav2mel
from stylesinger_tpu.models import hifigan as jh
from stylesinger_tpu.training import vocoder_task as jvt
from torch_parity import (
    Replay, one_torch_thread, random_variables, stash_draws, to_np,
)

from stylesinger_torch.config import tiny_test_config as torch_tiny
from stylesinger_torch.convert import from_jax_params
from stylesinger_torch.dsp.mel import wav2mel_batch
from stylesinger_torch.models import hifigan as th
from stylesinger_torch.training import vocoder_task as tvt

# the fixture, imported above, runs this module on one torch thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")

AUDIO = dict(hop_size=64, fft_size=256, win_size=256, audio_num_mel_bins=16,
             fmax=8000, audio_sample_rate=16000, mrf_block=64)
TOL = dict(atol=2e-4, rtol=2e-3)
HOP, FRAMES, B = 64, 16, 2
KEY = jax.random.PRNGKey(7)


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(to_np(got), np.asarray(want), err_msg=err_msg,
                               **TOL)


def _batch(seed, b=B, frames=FRAMES):
    rng = np.random.default_rng(seed)
    f0 = 150.0 + 100.0 * rng.uniform(size=(b, frames))
    f0[:, -3:] = 0.0  # unvoiced frames: the source's noise branch
    return {"mels": rng.standard_normal((b, frames, 16)).astype(np.float32),
            "f0": f0.astype(np.float32),
            "wav": (0.3 * rng.standard_normal((b, frames * HOP))).astype(
                np.float32)}


def _items(seed, lengths):
    rng = np.random.default_rng(seed)
    return [{"mel": rng.standard_normal((t, 16)).astype(np.float32),
             "wav": (0.3 * rng.standard_normal(t * HOP)).astype(np.float32),
             "f0": (150.0 + 100.0 * rng.uniform(size=t)).astype(np.float32)}
            for t in lengths]


# ---------------------------------------------------------------------------
# discriminators, GAN losses, the batched log-mel
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def discs():
    wav = jnp.zeros((B, 1024))
    mpd, msd = jh.MultiPeriodDiscriminator(), jh.MultiScaleDiscriminator()
    mv = random_variables(mpd.init, jax.random.PRNGKey(0), wav, seed=11)
    sv = random_variables(msd.init, jax.random.PRNGKey(0), wav, seed=12)
    tm, ts = th.MultiPeriodDiscriminator(), th.MultiScaleDiscriminator()
    tm.load_state_dict(from_jax_params(mv))
    ts.load_state_dict(from_jax_params(sv))
    return {"mpd": (mpd, mv, tm), "msd": (msd, sv, ts)}


@pytest.mark.parametrize("length", [1003, 1024],
                         ids=["odd_no_period_divides", "even"])
@pytest.mark.parametrize("which", ["mpd", "msd"])
def test_discriminators_match_jax(discs, which, length):
    """Every branch's score and every feature map.  1003 = 17 x 59 is odd
    (the strided SAME pads and the pooling are uneven) and no period
    divides it (every branch reflect-pads); 1024 is even."""
    jmod, variables, tmod = discs[which]
    wav = (0.3 * np.random.default_rng(length).standard_normal(
        (B, length))).astype(np.float32)
    outs, feats = jmod.apply(variables, jnp.asarray(wav))
    with torch.no_grad():
        touts, tfeats = tmod(torch.as_tensor(wav))
    assert len(touts) == len(outs) == (5 if which == "mpd" else 3)
    for i, (o, to) in enumerate(zip(outs, touts)):
        _close(to, o, f"{which} branch {i} score")
        assert len(tfeats[i]) == len(feats[i])
        for j, (f, tf) in enumerate(zip(feats[i], tfeats[i])):
            # channel-first in the port, channel-last in flax
            tf = tf.permute(0, 2, 3, 1) if tf.ndim == 4 else tf.transpose(1, 2)
            _close(tf, f, f"{which} branch {i} feature {j}")


def test_gan_losses_match_jax():
    rng = np.random.default_rng(3)

    def maps(shapes):
        return [rng.standard_normal(s).astype(np.float32) for s in shapes]

    real, fake = maps([(2, 30), (2, 7)]), maps([(2, 30), (2, 7)])
    rf = [maps([(2, 4, 5), (2, 3)]), maps([(2, 6)])]
    ff = [maps([(2, 4, 5), (2, 3)]), maps([(2, 6)])]
    t = lambda xs: [torch.tensor(x) for x in xs]  # noqa: E731
    _close(th.discriminator_loss(t(real), t(fake)),
           jh.discriminator_loss(real, fake))
    _close(th.generator_adv_loss(t(fake)), jh.generator_adv_loss(fake))
    trf = [[torch.tensor(x, requires_grad=True) for x in fs] for fs in rf]
    tff = [[torch.tensor(x, requires_grad=True) for x in fs] for fs in ff]
    fm = th.feature_matching_loss(trf, tff)
    _close(fm, jh.feature_matching_loss(rf, ff))
    fm.backward()
    # no gradient into the real side, as JAX's stop_gradient
    assert all(x.grad is None for fs in trf for x in fs)
    want = jax.grad(jh.feature_matching_loss, argnums=1)(rf, ff)
    for fs, ws in zip(tff, want):
        for x, w in zip(fs, ws):
            _close(x.grad, w)


@pytest.mark.parametrize("win", [256, 200], ids=["win256", "win200"])
def test_wav2mel_batch_and_its_gradient_match_jax(win):
    """[B, T] with T not a multiple of the hop; a window shorter than the
    FFT is centred in the frame."""
    kw = dict(sample_rate=16000, n_fft=256, hop_size=64, win_length=win,
              n_mels=16, fmin=20.0, fmax=8000.0)
    rng = np.random.default_rng(4)
    wav = (0.3 * rng.standard_normal((B, 1000))).astype(np.float32)
    w = rng.standard_normal((B, 1 + 1000 // 64, 16)).astype(np.float32)
    ref = jax_wav2mel(jnp.asarray(wav), **kw)
    g_ref = np.asarray(jax.grad(lambda x: jnp.sum(
        jax_wav2mel(x, **kw) * w))(jnp.asarray(wav)))
    x = torch.tensor(wav, requires_grad=True)
    out = wav2mel_batch(x, **kw)
    (out * torch.tensor(w)).sum().backward()
    _close(out, ref)
    np.testing.assert_allclose(to_np(x.grad), g_ref, rtol=2e-3,
                               atol=2e-4 * np.abs(g_ref).max())


# ---------------------------------------------------------------------------
# the generator under autograd
# ---------------------------------------------------------------------------

def _generator_variables(cfg, batch, seed=2):
    gen = jh.HifiGanGenerator(cfg)
    return gen, random_variables(
        gen.init, {"params": jax.random.PRNGKey(0),
                   "noise": jax.random.PRNGKey(1)},
        jnp.asarray(batch["mels"]), jnp.asarray(batch["f0"]), seed=seed,
        gain=0.5)


def check_grads(ref_tree, names, grads, what, leaf_atol=2e-4):
    """Gradients per leaf: rtol 2e-3, atol ``leaf_atol`` x max|g_leaf|
    (floor 1e-7 x max|g| over the leaves)."""
    ref = {k: v.numpy() for k, v in from_jax_params(ref_tree).items()}
    assert set(ref) == set(names), what
    floor = 1e-7 * max(np.abs(g).max() for g in ref.values())
    for name, g in zip(names, grads):
        got = np.zeros_like(ref[name]) if g is None else to_np(g)
        np.testing.assert_allclose(
            got, ref[name], rtol=2e-3,
            atol=max(leaf_atol * np.abs(ref[name]).max(), floor),
            err_msg=f"{what} {name}")


def test_generator_gradient_through_blocked_stages_matches_jax():
    """Under autograd the blocked stages the kernel would take run the
    resblock modules ("blocks"): the gradient of every parameter."""
    cfg = tiny_test_config(**AUDIO)
    batch = _batch(5)
    gen, variables = _generator_variables(cfg, batch)
    w = np.random.default_rng(6).standard_normal(
        (B, FRAMES * HOP)).astype(np.float32)
    kinds = []

    def loss(params, mel, f0):
        draws = []
        with stash_draws(draws):
            wav = gen.apply({"params": params}, mel, f0,
                            rngs={"noise": KEY})
        kinds[:] = [k for k, _ in draws]
        return jnp.sum(wav * w), [v for _, v in draws]

    (value, draws), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"], jnp.asarray(batch["mels"]),
        jnp.asarray(batch["f0"]))
    port = th.HifiGanGenerator(torch_tiny(**AUDIO))
    port.load_state_dict(from_jax_params(variables))
    assert port.mrf_routes(FRAMES) == ["modules", "kernel", "kernel",
                                       "kernel"]
    assert port.mrf_routes(FRAMES, grad=True) == ["modules", "blocks",
                                                  "blocks", "blocks"]
    noise = Replay(list(zip(kinds, draws)))
    out = (port(torch.as_tensor(batch["mels"]), torch.as_tensor(batch["f0"]),
                noise) * torch.as_tensor(w)).sum()
    out.backward()
    assert noise.draws == []
    _close(out, value)
    names, params = zip(*port.named_parameters())
    check_grads({"params": grads}, names, [p.grad for p in params],
                "generator")


def test_mrf_route_is_never_the_kernel_while_autograd_records(monkeypatch):
    """The generator calls the MRF kernel's wrapper only when no gradient is
    recorded: not with trainable weights, not with an input that requires
    grad; under no_grad, or with frozen weights and a plain input, it
    does."""
    calls = []
    wrapper = th.fused_mrf_blocks

    def spy(*a, **k):
        calls.append(torch.is_grad_enabled())
        return wrapper(*a, **k)

    monkeypatch.setattr(th, "fused_mrf_blocks", spy)
    batch = _batch(8)
    gen = th.HifiGanGenerator(torch_tiny(**AUDIO))
    mel, f0 = torch.as_tensor(batch["mels"]), torch.as_tensor(batch["f0"])

    def run(mel):
        return gen(mel, f0, tvt.vocoder_noise(0, 0, "cpu", "noise"))

    run(mel)
    assert calls == []
    with torch.no_grad():
        run(mel)
    assert len(calls) == 3
    gen.requires_grad_(False)
    run(mel.clone().requires_grad_(True))
    assert len(calls) == 3
    run(mel)
    assert calls == [False] * 3 + [True] * 3


def test_bf16_generator_trains_with_f32_parameters(monkeypatch):
    """``vocoder_compute_dtype: bfloat16``: the convs run in bf16 while the
    parameters, their gradients and the optimizer's moments stay f32, as
    JAX's ``dtype=`` convs keep them; the discriminator step's generator
    pass takes the MRF kernel's bf16 mode, the generator step none."""
    modes = []
    wrapper = th.fused_mrf_blocks

    def spy(*a, **k):
        modes.append(k["compute_dtype"])
        return wrapper(*a, **k)

    monkeypatch.setattr(th, "fused_mrf_blocks", spy)
    cfg = torch_tiny(vocoder_compute_dtype="bfloat16", **AUDIO)
    state = tvt.init_vocoder_state(cfg, device="cpu")
    before = {k: v.detach().clone() for k, v in state.gen.named_parameters()}
    seen = capture_grads(state.gen_opt)
    disc_step, gen_step = tvt.make_vocoder_bodies(cfg)
    b = tvt.batch_to_device(_batch(51), "cpu")
    m = disc_step(state, b, tvt.vocoder_noise(0, 0, "cpu", "noise"))
    assert modes == [torch.bfloat16] * 3
    m.update(gen_step(state, b, tvt.vocoder_noise(0, 0, "cpu", "noise")))
    assert len(modes) == 3
    assert all(np.isfinite(float(v)) for v in m.values())
    for (name, p), g, mu in zip(state.gen.named_parameters(), seen[0],
                                state.gen_opt.mu):
        assert p.dtype == g.dtype == mu.dtype == torch.float32, name
        assert torch.isfinite(g).all(), name
    assert any(not torch.equal(p, before[k])
               for k, p in state.gen.named_parameters())


# ---------------------------------------------------------------------------
# one GAN iteration, against make_vocoder_bodies
# ---------------------------------------------------------------------------

def _jax_cfg(**over):
    return dict(tiny_test_config(**AUDIO), **over)


class _Gan:
    """Seeded weights for both sides and, per config, JAX's compiled
    iteration (disc_body then gen_body, one key) with its draws and the
    gradients each optimizer was given."""

    def __init__(self):
        self.batch = _batch(9)
        cfg = _jax_cfg()
        _, gv = _generator_variables(cfg, self.batch, seed=13)
        wav = jnp.zeros((B, FRAMES * HOP))
        self.gen_params = gv["params"]
        self.disc_params = {
            "mpd": random_variables(jh.MultiPeriodDiscriminator().init,
                                    jax.random.PRNGKey(0), wav,
                                    seed=14)["params"],
            "msd": random_variables(jh.MultiScaleDiscriminator().init,
                                    jax.random.PRNGKey(0), wav,
                                    seed=15)["params"]}
        self._fns = {}

    def jax_state(self, cfg):
        """JAX's ``init_vocoder_state``'s optimizers (traced, not run) on
        the seeded weights."""
        shapes = jax.eval_shape(lambda: jvt.init_vocoder_state(
            cfg, jax.random.PRNGKey(0), jnp.asarray(self.batch["mels"]),
            jnp.asarray(self.batch["f0"])))
        return jvt.VocoderState(
            step=jnp.zeros((), jnp.int32), gen_params=self.gen_params,
            disc_params=self.disc_params,
            gen_opt=shapes.gen_tx.init(self.gen_params),
            disc_opt=shapes.disc_tx.init(self.disc_params),
            gen_tx=shapes.gen_tx, disc_tx=shapes.disc_tx)

    def iteration(self, cfg):
        """f(state, batch, key) -> (state, metrics, draws, (disc grads, gen
        grads)) jitted, and the draws' kinds."""
        key = json.dumps(cfg, sort_keys=True)
        if key in self._fns:
            return self._fns[key]
        disc_body, gen_body = jvt.make_vocoder_bodies(cfg)
        kinds = []

        def f(state, batch, rng):
            grads = []

            def capture(tx):
                def update(g, s, p=None):
                    grads.append(g)
                    return tx.update(g, s, p)
                return optax.GradientTransformation(tx.init, update)

            state = state.replace(gen_tx=capture(state.gen_tx),
                                  disc_tx=capture(state.disc_tx))
            draws = []
            with stash_draws(draws):
                state, dm = disc_body(state, batch, rng)
                state, gm = gen_body(state, batch, rng)
            kinds[:] = [k for k, _ in draws]
            return (state.gen_params, state.disc_params, state.step,
                    {**dm, **gm}, [v for _, v in draws], grads)

        self._fns[key] = (jax.jit(f), kinds)
        return self._fns[key]


@pytest.fixture(scope="module")
def gan():
    return _Gan()


def port_state(gan, tcfg):
    state = tvt.init_vocoder_state(tcfg, device="cpu")
    state.gen.load_state_dict(from_jax_params({"params": gan.gen_params}))
    state.mpd.load_state_dict(from_jax_params(
        {"params": gan.disc_params["mpd"]}))
    state.msd.load_state_dict(from_jax_params(
        {"params": gan.disc_params["msd"]}))
    return state


def capture_grads(opt):
    """Record the gradients each ``opt.step`` is given."""
    seen = []
    step = opt.step

    def rec(params, grads, *rest):
        seen.append([None if g is None else g.detach().clone()
                     for g in grads])
        step(params, grads, *rest)

    opt.step = rec
    return seen


def check_update(ref_params, port_named, before, ref_grads, port_grads, tx,
                 lr, what):
    """The parameters after the update: atol 0.05 x lr where JAX's gradient
    is >= 1e-6, and all of them against optax's update (``tx``) of the
    port's gradients from ``before`` at atol 1e-3 x lr."""
    ref = {k: v.numpy() for k, v in from_jax_params(ref_params).items()}
    g_ref = {k: v.numpy() for k, v in from_jax_params(ref_grads).items()}
    ours = {k: to_np(v) for k, v in port_named.items()}
    assert set(ref) == set(ours), what
    for name, v in ref.items():
        steady = np.abs(g_ref[name]) >= 1e-6
        np.testing.assert_allclose(ours[name][steady], v[steady],
                                   atol=0.05 * lr, rtol=0,
                                   err_msg=f"{what} {name}")
    names = list(port_named)
    tgrads = {n: to_np(g) for n, g in zip(names, port_grads)}
    updates, _ = jax.jit(tx.update)(tgrads, tx.init(before), before)
    for name in names:
        np.testing.assert_allclose(
            ours[name], before[name] + np.asarray(updates[name]),
            atol=1e-3 * lr, rtol=0, err_msg=f"{what} optax {name}")


@pytest.mark.parametrize("kind", ["adamw", "radam"])
def test_gan_optimizer_matches_optax_over_eight_steps(kind):
    """``GanOptimizer`` against ``optax.adamw`` / ``optax.radam`` on the
    same seeded gradients for 8 steps, past radam's threshold (rho < 5 for
    steps 1-5 at b2 0.99, the rectified step from step 6).  Leaves with
    gradients of scale 1, 1e-3 and 1e-8 (where eps's place shows), at lr
    0.1 so that the update is large beside f32 rounding: each parameter's
    change at rtol 2e-3 / atol 2e-4 x max|change| of its leaf, and the
    parameters at the default tolerance."""
    lr, b1, b2 = 0.1, 0.8, 0.99
    rng = np.random.default_rng(11)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 3, 2)}
    scales = {"a": 1.0, "b": 1e-3, "c": 1e-8}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    grads = [{k: (scales[k] * rng.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(8)]
    tx = (optax.adamw if kind == "adamw" else optax.radam)(lr, b1, b2)
    want, opt_state = dict(p0), tx.init(p0)
    update = jax.jit(tx.update)
    for g in grads:
        upd, opt_state = update(g, opt_state, want)
        want = {k: np.asarray(want[k] + upd[k]) for k in want}
    params = {k: torch.nn.Parameter(torch.as_tensor(v.copy()))
              for k, v in p0.items()}
    opt = tvt.GanOptimizer(params, dict(
        vocoder_optimizer=kind, vocoder_lr=lr, vocoder_adam_b1=b1,
        vocoder_adam_b2=b2))
    for g in grads:
        opt.step(list(params.values()),
                 [torch.as_tensor(g[k]) for k in params])
    assert opt.count == 8
    for k, v in params.items():
        change, ref = to_np(v) - p0[k], want[k] - p0[k]
        np.testing.assert_allclose(change, ref, rtol=2e-3,
                                   atol=2e-4 * np.abs(ref).max(), err_msg=k)
        _close(v, want[k], err_msg=k)


@pytest.mark.parametrize("over", [
    dict(), dict(vocoder_optimizer="radam"), dict(lambda_ms_stft=1.0)],
    ids=["adamw", "radam", "ms_stft"])
def test_gan_iteration_matches_make_vocoder_bodies(gan, over):
    cfg = _jax_cfg(**over)
    tcfg = torch_tiny(**AUDIO, **over)
    fn, kinds = gan.iteration(cfg)
    gp, dp, step, metrics, draws, (d_grads, g_grads) = fn(
        gan.jax_state(cfg), {k: jnp.asarray(v) for k, v in gan.batch.items()},
        KEY)
    assert int(step) == 1
    # both passes draw the generator's noise from one key
    half = len(draws) // 2
    assert kinds == ["u", "n"] * 2
    for a, b in zip(draws[:half], draws[half:]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    state = port_state(gan, tcfg)
    gen_before = {k: to_np(v).copy()
                  for k, v in state.gen.named_parameters()}
    disc_named = state.named_disc_params()
    disc_names = list(disc_named)
    disc_before = {n: to_np(p).copy() for n, p in disc_named.items()}
    seen_d, seen_g = capture_grads(state.disc_opt), capture_grads(
        state.gen_opt)
    disc_step, gen_step = tvt.make_vocoder_bodies(tcfg)
    tb = tvt.batch_to_device(gan.batch, "cpu")
    pairs = list(zip(kinds, draws))
    noise = [Replay(pairs[:half]), Replay(pairs[half:])]
    tm = disc_step(state, tb, noise[0])
    tm.update(gen_step(state, tb, noise[1]))
    assert state.step == 1 and all(n.draws == [] for n in noise)
    assert set(tm) == set(metrics) == (
        {"disc_loss", "adv", "fm", "mel_l1", "gen_loss"} |
        ({"ms_stft"} if "lambda_ms_stft" in over else set()))
    for k, v in metrics.items():
        _close(tm[k], v, k)
    disc_tree = {"params": d_grads}
    check_grads(disc_tree, disc_names, seen_d[0], "disc")
    gen_names = [n for n, _ in state.gen.named_parameters()]
    check_grads({"params": g_grads}, gen_names, seen_g[0], "gen",
                leaf_atol=1e-2 if "lambda_ms_stft" in over else 2e-4)

    lr = tcfg["vocoder_lr"]
    shapes = gan.jax_state(cfg)
    check_update({"params": dp}, disc_named, disc_before, disc_tree,
                 seen_d[0], shapes.disc_tx, lr, "disc")
    check_update({"params": gp}, dict(state.gen.named_parameters()),
                 gen_before, {"params": g_grads}, seen_g[0], shapes.gen_tx,
                 lr, "gen")


# ---------------------------------------------------------------------------
# the device-resident multi-step loop, the crops
# ---------------------------------------------------------------------------

def _jax_crop_draws(key, step, batch_size, n_items):
    """What the JAX scan's crop draws at ``step``: randint of the items,
    then of the raw offsets, from split(fold_in(fold_in(key, step), 1))."""
    ki, ko = jax.random.split(jax.random.fold_in(
        jax.random.fold_in(key, step), 1))
    return [("i", np.asarray(jax.random.randint(ki, (batch_size,), 0,
                                                n_items))),
            ("i", np.asarray(jax.random.randint(ko, (batch_size,), 0,
                                                1 << 30)))]


@pytest.mark.parametrize("case", ["identity", "random_crops"])
def test_vocoder_scan_matches_jax_scan(gan, case):
    """Two iterations of ``make_vocoder_scan`` against JAX's: a corpus of
    one item exactly ``crop_frames`` long (the crop is the identity, as in
    ``tests/test_training.py::test_vocoder_scan_matches_per_step``), and a
    corpus of three items of 40, 24 and 33 frames cropped at random, JAX's
    crop draws replayed.  With radam, whose first five steps are the
    bias-corrected momentum, each parameter's change is linear in its
    gradients: held at rtol 2e-3, atol 2e-4 x max|change| of the leaf, or
    two f32 spacings of the leaf's largest weight where that is more."""
    lengths, batch_size = ([FRAMES], 1) if case == "identity" else (
        [40, 24, 33], B)
    items = _items(21, lengths)
    cfg = _jax_cfg(vocoder_optimizer="radam")
    tcfg = torch_tiny(**AUDIO, vocoder_optimizer="radam")
    data = jvt.stack_corpus(items, cfg, max(lengths))
    st, m = jvt.make_vocoder_scan(cfg)(
        gan.jax_state(cfg), {k: jnp.asarray(v) for k, v in data.items()},
        KEY, 2, FRAMES, batch_size)
    assert int(st.step) == 2

    gen = jh.HifiGanGenerator(cfg)
    kinds = []

    @jax.jit
    def gen_draws(rng):
        draws = []
        with stash_draws(draws):
            gen.apply({"params": gan.gen_params},
                      jnp.zeros((batch_size, FRAMES, 16)),
                      jnp.zeros((batch_size, FRAMES)), rngs={"noise": rng})
        kinds[:] = [k for k, _ in draws]
        return [v for _, v in draws]

    replay = {}
    for n in range(2):
        values = gen_draws(jax.random.fold_in(KEY, n))
        replay[n, "noise"] = list(zip(kinds, values))
        replay[n, "crop"] = _jax_crop_draws(KEY, n, batch_size, len(items))

    def noise(seed, step, device, stream):
        return Replay(replay[step, stream], device)

    port = port_state(gan, tcfg)
    named = {**dict(port.gen.named_parameters()), **port.named_disc_params()}
    before = {k: to_np(v).copy() for k, v in named.items()}
    tm = tvt.make_vocoder_scan(tcfg)(
        port, tvt.corpus_to_device(tvt.stack_corpus(items, tcfg,
                                                    max(lengths)), "cpu"),
        0, 2, FRAMES, batch_size, noise=noise)
    assert port.step == 2
    assert set(tm) == set(m)
    for k in m:
        assert tm[k].shape == (2,)
        _close(tm[k], m[k], k)
    ref = {k: v.numpy() for k, v in from_jax_params(
        {"params": {**st.gen_params, **st.disc_params}}).items()}
    ours = {k: to_np(v) for k, v in named.items()}
    assert set(ours) == set(ref)
    for name, v in ref.items():
        want = v.astype(np.float64) - before[name]
        got = ours[name].astype(np.float64) - before[name]
        atol = max(2e-4 * np.abs(want).max(),
                   2 * np.spacing(np.abs(before[name]).max()))
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=atol,
                                   err_msg=name)


def test_stack_corpus_and_crop_batch_equal_jax():
    items = _items(31, [40, 24, 33, 10])
    cfg = _jax_cfg()
    tcfg = torch_tiny(**AUDIO)
    for k, v in jvt.stack_corpus(items, cfg, 36).items():
        np.testing.assert_array_equal(
            tvt.stack_corpus(items, tcfg, 36)[k], v, err_msg=k)
    for crop in (16, 48):  # 48: longer than three items, zero-padded
        want = jvt.crop_batch(items, cfg, np.random.default_rng(5), crop)
        got = tvt.crop_batch(items, tcfg, np.random.default_rng(5), crop)
        for k, v in want.items():
            assert got[k].dtype == v.dtype
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("spd", [1, 2], ids=["host_crops", "device_crops"])
def test_fit_vocoder_resumes_as_an_unbroken_run(tmp_path, spd):
    """Two iterations at once, or one, a save, and a second call that
    resumes: the same state bit for bit, and the generator file loads
    through ``HifiGAN_NSF``'s ``vocoder_ckpt``."""
    from stylesinger_torch.vocoder_infer import HifiGAN_NSF

    cfg = torch_tiny(**AUDIO)
    items = _items(41, [40, 24, 33])
    kw = dict(batch=B, crop_frames=FRAMES, spd=spd, device="cpu",
              log=lambda msg: None)
    whole, history = tvt.fit_vocoder(cfg, items, 2, str(tmp_path / "a"),
                                     **kw)
    assert len(history) == 2 and all(
        np.isfinite(float(v)) for m in history for v in m.values())
    tvt.fit_vocoder(cfg, items, 1, str(tmp_path / "b"), **kw)
    resumed, rest = tvt.fit_vocoder(cfg, items, 2, str(tmp_path / "b"), **kw)
    assert resumed.step == whole.step == 2 and len(rest) == 1
    for k, v in rest[0].items():
        assert torch.equal(v, history[1][k]), k
    a, b = whole.state_dict(), resumed.state_dict()
    for side in ("gen", "mpd", "msd"):
        for k, v in a[side].items():
            assert torch.equal(v, b[side][k]), (side, k)
    for side in ("gen_opt", "disc_opt"):
        assert a[side]["count"] == b[side]["count"] == 2
        for key in ("mu", "nu"):
            for k, v in a[side][key].items():
                assert torch.equal(v, b[side][key][k]), (side, key, k)
    for path in (tmp_path / "b" / tvt.GENERATOR_FILE,
                 tmp_path / "b" / tvt.GAN_STATE_FILE):
        voc = HifiGAN_NSF(cfg.replace(vocoder_ckpt=str(path)), device="cpu")
        for k, v in voc.model.state_dict().items():
            assert torch.equal(v, a["gen"][k]), (path, k)
    assert os.path.exists(tmp_path / "a" / tvt.GENERATOR_FILE)
