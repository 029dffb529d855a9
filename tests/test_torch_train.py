"""One StyleSinger train step of the port against the JAX package's
``make_step_body`` at ``tiny_test_config``, on the CPU.

Both sides start from the same seeded weights (``random_variables``,
converted with ``from_jax_params``) and the same batch, and the port
replays JAX's draws stream by stream (``dropout``, ``umln``, ``rq``,
``diffusion``).  Each (phase, dropout) case compiles one JAX step, shared
by the tests through a module-scoped cache.

Tolerances: losses, ``total_loss`` and ``grad_norm`` atol 2e-4 / rtol 2e-3
(``tests/test_convert.py``); each gradient leaf atol 2e-4 * max|g_leaf| +
rtol 2e-3, where the atol has a floor of 1e-7 * max|g| over all leaves,
the f32 rounding left in a leaf whose gradient is zero in exact arithmetic
(the cross-attention's key bias: softmax ignores a shift shared by a row);
the parameters after the update atol 0.05 * lr (Adam's first step moves an
element by about lr) where JAX's clipped gradient is at least 1e-6 (100 x
Adam's eps); below it Adam's first step, ``g / (|g| + eps)``, turns the
f32 rounding of a gradient into a sizeable share of lr, so there, and
everywhere after a first step, the port's parameters are also held to
optax's own update of the port's gradients (atol 1e-3 * lr); the RQ
buffers atol 2e-4 / rtol 2e-3.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stylesinger_tpu.config import tiny_test_config
from stylesinger_tpu.data.batching import collate_batch
from stylesinger_tpu.data.dataset import StyleSingerDataset
from stylesinger_tpu.models.stylesinger import StyleSinger as JaxStyleSinger
from stylesinger_tpu.training import step as jstep
from torch_parity import (
    Replay, no_dropout, one_torch_thread, random_variables, stash_draws,
    to_np,
)

from stylesinger_torch.config import tiny_test_config as torch_tiny
from stylesinger_torch.convert import from_jax_params
from stylesinger_torch.models.stylesinger import StyleSinger
from stylesinger_torch.training import step as tstep

# the fixture, imported above, runs this module on one torch thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")

VOCAB = 20
TOL = dict(atol=2e-4, rtol=2e-3)
RQ_FORCE = jstep.Phase(use_rq=True, forcing=False, use_diff=True)
WARMUP = jstep.Phase(use_rq=False, forcing=True, use_diff=False)


def synthetic_items(cfg, rng, n=4):
    items = []
    for i in range(n):
        t = int(rng.integers(16, 30))
        tt = max(2, t // 4)
        items.append({
            "item_name": f"i{i}",
            "mel": rng.standard_normal(
                (t, cfg["audio_num_mel_bins"])).astype(np.float32) * 0.5 - 2,
            "mel2ph": np.repeat(np.arange(1, tt + 1), 4)[:t],
            "f0": np.abs(rng.standard_normal(t)).astype(np.float32) * 100
            + 150,
            "ph_token": rng.integers(1, VOCAB, tt),
            "ep_pitches": rng.integers(40, 80, tt),
            "ep_notedurs": rng.uniform(0.1, 0.6, tt).astype(np.float32),
            "ep_types": np.ones(tt, np.int64),
            "spk_embed": rng.standard_normal(256).astype(np.float32),
            "emo_embed": rng.standard_normal(256).astype(np.float32),
        })
    return items


def synthetic_batch(cfg, seed, n=4):
    ds = StyleSingerDataset(cfg, "train",
                            items=synthetic_items(cfg, np.random.default_rng(
                                seed), n))
    batch = collate_batch([ds[i] for i in range(n)], cfg["frame_buckets"],
                          cfg["token_buckets"])
    return {k: v for k, v in batch.items() if k != "nsamples"}


class _Setup:
    """The JAX model, its seeded variables, two batches and the compiled
    steps, built once per module."""

    def __init__(self):
        self.cfg = tiny_test_config()
        self.tcfg = torch_tiny()
        self.model = JaxStyleSinger(self.cfg, VOCAB)
        self.batches = [synthetic_batch(self.cfg, s) for s in (3, 4)]
        b = {k: jnp.asarray(v) for k, v in self.batches[0].items()}
        rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(
            ("params",) + jstep._RNG_STREAMS)}
        self.variables = random_variables(
            self.model.init, rngs, **jstep._model_inputs(b), infer=False,
            use_rq=True, forcing=False, use_diff=True, seed=5)
        self.rng = jax.random.PRNGKey(7)
        self._steps = {}
        self._eval = {}

    def jax_state(self, tx):
        return jstep.TrainState.create(self.variables["params"],
                                       self.variables["codebook"], tx)

    def step_fn(self, phase, dropout, accumulate=1):
        """(jitted f(state, batch) -> (state, metrics, grads, draws), tx,
        kinds), where ``draws[stream]`` lines up with ``kinds[stream]``."""
        key = (phase, dropout, accumulate)
        if key in self._steps:
            return self._steps[key]
        cfg = dict(self.cfg, accumulate_grad_batches=accumulate)
        inner = jstep.make_optimizer(cfg)
        captured, kinds = [], {}

        def update(g, s, p=None):
            captured.append(g)
            return inner.update(g, s, p)

        tx = optax.GradientTransformation(inner.init, update)
        body = jstep.make_step_body(self.model, cfg)

        def f(state, batch):
            captured.clear()
            draws = {}
            off = contextlib.nullcontext() if dropout else no_dropout()
            with off, stash_draws(draws):
                state, metrics = body(state, batch, self.rng, phase)
            kinds.clear()
            kinds.update({k: [kind for kind, _ in v]
                          for k, v in draws.items()})
            return state, metrics, captured[0], {
                k: [value for _, value in v] for k, v in draws.items()}

        self._steps[key] = (jax.jit(f), tx, kinds)
        return self._steps[key]

    def port_state(self, accumulate=1):
        tcfg = self.tcfg.replace(accumulate_grad_batches=accumulate)
        model = StyleSinger(tcfg, VOCAB)
        model.load_state_dict(from_jax_params(self.variables))
        return tstep.TrainState(model, tstep.Optimizer(
            dict(model.named_parameters()), tcfg)), tcfg


@pytest.fixture(scope="module")
def setup():
    return _Setup()


def port_noise(kinds, draws, dropout):
    noise = {s: Replay(list(zip(kinds.get(s, []), draws.get(s, []))))
             for s in tstep.STREAMS}
    if not dropout:
        noise["dropout"] = None
    return noise


def run_both(setup, phase, dropout, n_steps=1, accumulate=1):
    """``n_steps`` steps on both sides from the same state; returns the JAX
    state, metrics and grads of the last step and the port's state,
    metrics and config."""
    fn, tx, kinds = setup.step_fn(phase, dropout, accumulate)
    state = setup.jax_state(tx)
    port, tcfg = setup.port_state(accumulate)
    for i in range(n_steps):
        batch = setup.batches[i % 2]
        state, metrics, grads, draws = fn(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
        noise = port_noise(kinds, draws, dropout)
        tmetrics = tstep.train_step(port, tstep.batch_to_device(batch, "cpu"),
                                    tstep.Phase(*phase), tcfg, noise=noise)
        for stream, src in noise.items():
            assert src is None or not src.draws, f"{stream} draws left over"
    return state, metrics, grads, port, tmetrics, tcfg


def check_metrics(metrics, tmetrics):
    assert set(tmetrics) == set(metrics)
    for k in metrics:
        np.testing.assert_allclose(to_np(tmetrics[k]), np.asarray(metrics[k]),
                                   err_msg=k, **TOL)


def check_grads(grads, port, slack=None):
    """Each leaf at atol 2e-4 * max|g_leaf| (floor 1e-7 * max|g|) + rtol
    2e-3; ``slack`` ({name: array}) adds an allowance element by element."""
    ref = {k: v.numpy() for k, v in from_jax_params({"params": grads}).items()}
    ours = dict(port.model.named_parameters())
    assert set(ref) == set(ours)
    floor = 1e-7 * max(np.abs(g).max() for g in ref.values())
    for name, g in ref.items():
        p = ours[name]
        got = np.zeros_like(g) if p.grad is None else to_np(p.grad)
        atol = max(2e-4 * np.abs(g).max(), floor)
        if slack is None:
            np.testing.assert_allclose(got, g, rtol=2e-3, atol=atol,
                                       err_msg=name)
            continue
        bad = np.abs(got - g) > atol + 2e-3 * np.abs(g) + slack[name]
        assert not bad.any(), (name, np.abs(got - g)[bad].max())


def check_params_and_buffers(state, port, lr, grads, grad_norm, cfg,
                             first_params=None, clear_of=None):
    """The parameters and RQ buffers after the step.  ``first_params`` (the
    parameters before a first step) also holds the port's parameters to
    optax's update of the port's own gradients.  ``clear_of`` ({name:
    array}, a gradient's known uncertainty) leaves out of the comparison
    with JAX the elements whose gradient is within twice it of 0, where
    Adam's first step may take either sign."""
    ref = {k: v.numpy() for k, v in from_jax_params(
        {"params": state.params, "codebook": state.codebook}).items()}
    ours = {k: to_np(v) for k, v in port.model.state_dict().items()}
    assert set(ref) == set(ours)
    clip = min(1.0, cfg["clip_grad_norm"] / float(grad_norm))
    g_ref = {k: v.numpy() * clip
             for k, v in from_jax_params({"params": grads}).items()}
    for name, v in ref.items():
        if ".codebook_" in name:
            if clear_of is None:
                np.testing.assert_allclose(ours[name], v, err_msg=name,
                                           **TOL)
            else:
                bad = np.abs(ours[name] - v) > TOL["atol"] + \
                    TOL["rtol"] * np.abs(v) + 2 * clear_of[name]
                assert not bad.any(), (name, np.abs(ours[name] - v).max())
            continue
        steady = np.abs(g_ref[name]) >= 1e-6
        if clear_of is not None:
            steady &= np.abs(g_ref[name]) > 2 * clip * clear_of[name]
        np.testing.assert_allclose(ours[name][steady], v[steady],
                                   atol=0.05 * lr, rtol=0, err_msg=name)
    if first_params is not None:
        named = dict(port.model.named_parameters())
        tgrads = {k: np.zeros(p.shape, np.float32) if p.grad is None
                  else to_np(p.grad) for k, p in named.items()}
        tx = jstep.make_optimizer(cfg)
        updates, _ = jax.jit(tx.update)(tgrads, tx.init(first_params),
                                        first_params)
        for name, u in updates.items():
            np.testing.assert_allclose(
                ours[name], first_params[name] + np.asarray(u),
                atol=1e-3 * lr, rtol=0, err_msg=name)


@pytest.mark.parametrize("dropout", [False, True], ids=["dropout_off",
                                                        "dropout_replayed"])
@pytest.mark.parametrize("phase", [RQ_FORCE, WARMUP],
                         ids=["rq_diff", "forcing"])
def test_train_step_matches_jax(setup, phase, dropout):
    state, metrics, grads, port, tmetrics, tcfg = run_both(setup, phase,
                                                           dropout)
    assert port.step == int(state.step) == 1
    check_metrics(metrics, tmetrics)
    check_grads(grads, port)
    lr = tstep.make_schedule(tcfg)(0)
    first = {k: v.numpy() for k, v in from_jax_params(setup.variables).items()
             if ".codebook_" not in k}
    check_params_and_buffers(state, port, lr, grads, metrics["grad_norm"],
                             setup.cfg, first_params=first)
    expected = {"l1", "ssim", "pdur", "sdur", "gdiff1", "mdiff1", "gdiff2",
                "mdiff2", "total_loss", "grad_norm"}
    if phase == RQ_FORCE:
        expected |= {"diff", "gloss", "rq_loss"}
    assert set(tmetrics) == expected


def test_two_steps_match_jax(setup):
    """The Adam moments and the schedule's second count carry over."""
    state, metrics, grads, port, tmetrics, tcfg = run_both(
        setup, RQ_FORCE, False, n_steps=2)
    assert port.step == 2 and port.opt.count == 2
    check_metrics(metrics, tmetrics)
    check_grads(grads, port)
    check_params_and_buffers(state, port, tstep.make_schedule(tcfg)(1),
                             grads, metrics["grad_norm"], setup.cfg)


def test_accumulation_matches_optax_multisteps(setup):
    """``accumulate_grad_batches=2``: the first call leaves the parameters
    as they are, the second applies the mean of both gradients."""
    fn, tx, kinds = setup.step_fn(RQ_FORCE, False, accumulate=2)
    state0 = setup.jax_state(tx)
    port, tcfg = setup.port_state(accumulate=2)
    before = {k: v.clone() for k, v in port.model.named_parameters()}
    state, _, _, draws = fn(state0, {k: jnp.asarray(v) for k, v in
                                     setup.batches[0].items()})
    tstep.train_step(port, tstep.batch_to_device(setup.batches[0], "cpu"),
                     tstep.Phase(*RQ_FORCE), tcfg,
                     noise=port_noise(kinds, draws, False))
    for k, v in port.model.named_parameters():
        assert torch.equal(v, before[k]), k
    state, metrics, grads, draws = fn(state, {k: jnp.asarray(v) for k, v in
                                              setup.batches[1].items()})
    tmetrics = tstep.train_step(
        port, tstep.batch_to_device(setup.batches[1], "cpu"),
        tstep.Phase(*RQ_FORCE), tcfg, noise=port_noise(kinds, draws, False))
    assert port.opt.count == 1 and port.opt.mini_step == 0
    check_metrics(metrics, tmetrics)
    check_params_and_buffers(state, port, tstep.make_schedule(tcfg)(0),
                             grads, metrics["grad_norm"], setup.cfg)


def test_eval_step_matches_jax(setup):
    """Validation: deterministic, the diffusion draws of the step, no
    codebook update."""
    # the un-jitted body, so that its draws belong to this trace
    eval_step = jstep.make_eval_step(setup.model, setup.cfg).__wrapped__
    state = setup.jax_state(jstep.make_optimizer(setup.cfg))
    batch = {k: jnp.asarray(v) for k, v in setup.batches[0].items()}

    @jax.jit
    def f(state, batch):
        draws = {}
        with stash_draws(draws):
            losses = eval_step(state, batch, setup.rng, RQ_FORCE)
        kinds.update({k: [kind for kind, _ in v] for k, v in draws.items()})
        return losses, {k: [value for _, value in v]
                        for k, v in draws.items()}

    kinds = {}
    losses, draws = f(state, batch)
    assert set(kinds) == {"diffusion"}
    port, tcfg = setup.port_state()
    before = {k: v.clone() for k, v in port.model.state_dict().items()}
    tlosses = tstep.eval_step(port, tstep.batch_to_device(
        setup.batches[0], "cpu"), tstep.Phase(*RQ_FORCE), tcfg,
        noise=port_noise(kinds, draws, False))
    check_metrics(losses, tlosses)
    for k, v in port.model.state_dict().items():
        assert torch.equal(v, before[k]), k
