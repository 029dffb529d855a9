"""``compute_dtype: bfloat16``: one StyleSinger train step and one eval step
of the port against the JAX package's ``make_step_body`` /
``make_eval_step`` at the same setting, on the CPU at ``tiny_test_config``;
the refusal of any other value; the f32 step unchanged by the setting's
machinery.

Both sides start from the same seeded weights and batch, and the port
replays JAX's draws (``tests/test_torch_train.py``'s recipe).  bf16 keeps 8
significant bits, and the two sides round at the same sites but not in the
same order (XLA fuses elementwise chains and keeps f32 inside a fusion;
PyTorch rounds after each op), so the outputs differ by a few bf16 ulps
that the layers carry forward: at this size JAX's own bf16 gradients are
13 % (L2, all leaves) from its f32 gradients, where the port's are 1.2 %
(XLA's CPU backend rounds inside elementwise chains such as gelu's
backward, PyTorch once per op).  So the bf16 step must also show that it
ran in bf16: every layer built with ``compute=True`` that runs (among them
the attention's ``qkv``, the FFN's ``Conv_0`` and WaveNet's ``in_0``)
returns bf16, and the port's bf16 gradient is more than 0.4 % (L2, a
third of the 1.2 % measured) from its own f32 gradient on the same
weights, batch and draws; a step that ignored the setting would be 0
from it.  Tolerances, bf16: the losses,
``total_loss`` and ``grad_norm`` atol 2e-2 / rtol 2e-2 (about 5 bf16 ulps;
measured: rq_loss 1.5e-2 relative, the rest under 7e-3); the gradients: the
port's no further (L2) from JAX's f32 gradients than JAX's bf16 gradients
are, plus 1e-2 of their norm; cosine similarity with JAX's bf16 gradients
above 0.98 (measured 0.991); each leaf within 0.3 of its f32 norm (floor
1e-3 of the whole norm) of JAX's bf16 leaf (measured at most 0.24); the
parameters (f32) equal to
optax's update of the port's own gradients (atol 1e-3 * lr: Adam's first
step moves an element by lr times its gradient's sign, which the bf16
rounding of a near-zero gradient decides); each RQ buffer (style vectors
and their counts) within, in L2, twice JAX's own bf16-to-f32 distance plus
1e-2 of its norm.  f32: ``tests/test_torch_train.py``'s tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stylesinger_tpu.config import tiny_test_config
from stylesinger_tpu.models.stylesinger import StyleSinger as JaxStyleSinger
from stylesinger_tpu.training import step as jstep
from test_torch_train import (
    RQ_FORCE, VOCAB, check_metrics, port_noise, synthetic_batch,
)
from torch_parity import (
    no_dropout, one_torch_thread, random_variables, stash_draws, to_np,
)

from stylesinger_torch.config import tiny_test_config as torch_tiny
from stylesinger_torch.convert import from_jax_params
from stylesinger_torch.models import precision
from stylesinger_torch.models.stylesinger import StyleSinger
from stylesinger_torch.training import step as tstep
from stylesinger_torch.training.trainer import Trainer

# the port's bf16 gradient is at least this far (relative L2) from its f32
# gradient (measured 1.2 %), and at least this share of JAX's own bf16-to-f32
# distance (measured 13 %; the share 0.089)
MIN_BF16_SPREAD = 4e-3
MIN_SPREAD_OF_JAX = 0.03
# layers that take the compute dtype and must have run in bf16: the
# attention's qkv, the FFN's conv, WaveNet's first conv and a LayerNorm of
# the style encoder's conv blocks
BF16_SITES = (".qkv", ".Conv_0", ".in_0", ".res_0.ln_0")

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BF16_TOL = dict(atol=2e-2, rtol=2e-2)


class _Setup:
    """The JAX model at bf16, its seeded variables, a batch and the jitted
    step and eval bodies, built once for the module."""

    def __init__(self):
        self.cfg = tiny_test_config(compute_dtype="bfloat16")
        self.tcfg = torch_tiny(compute_dtype="bfloat16")
        self.model = JaxStyleSinger(self.cfg, VOCAB)
        self.batch = synthetic_batch(self.cfg, 3)
        b = {k: jnp.asarray(v) for k, v in self.batch.items()}
        rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(
            ("params",) + jstep._RNG_STREAMS)}
        self.variables = random_variables(
            self.model.init, rngs, **jstep._model_inputs(b), infer=False,
            use_rq=True, forcing=False, use_diff=True, seed=5)
        self.rng = jax.random.PRNGKey(7)

    def port_state(self):
        model = StyleSinger(self.tcfg, VOCAB)
        model.load_state_dict(from_jax_params(self.variables))
        return tstep.TrainState(model, tstep.Optimizer(
            dict(model.named_parameters()), self.tcfg))


@pytest.fixture(scope="module")
def setup():
    return _Setup()


def test_compute_dtype_other_than_f32_or_bf16_raises():
    for bad in ("float16", "bf16", "int8"):
        with pytest.raises(ValueError, match="compute_dtype"):
            with precision.activation_dtype(bad):
                pass
    cfg = torch_tiny(compute_dtype="float16")
    model = StyleSinger(cfg, VOCAB)
    state = tstep.init_state(model, cfg)
    batch = tstep.batch_to_device(synthetic_batch(tiny_test_config(), 3),
                                  "cpu")
    with pytest.raises(ValueError, match="compute_dtype"):
        tstep.train_step(state, batch, tstep.Phase(*RQ_FORCE), cfg)
    assert state.step == 0
    with pytest.raises(ValueError, match="compute_dtype"):
        Trainer(model, cfg, "unused_work_dir", device="cpu")


def test_activation_dtype_scopes_the_setting():
    assert precision.compute_dtype() is None
    with precision.activation_dtype("bfloat16"):
        assert precision.compute_dtype() is torch.bfloat16
        assert precision.cast(torch.ones(2)).dtype == torch.bfloat16
        with precision.activation_dtype("float32"):
            assert precision.compute_dtype() is None
        assert precision.compute_dtype() is torch.bfloat16
    assert precision.compute_dtype() is None
    assert precision.cast(torch.ones(2)).dtype == torch.float32
    assert precision.const(2 ** -0.5, torch.bfloat16) == 0.70703125


def test_bf16_layers_follow_flax_dtype_rules():
    """flax Dense/Conv(dtype=bf16) return bf16, Dense() promotes a bf16
    input to f32, LayerNorm(dtype=bf16) returns bf16 from f32 statistics."""
    from stylesinger_torch.models.common import Conv, Dense, LayerNorm

    x = torch.randn(2, 5, 8)
    with precision.activation_dtype("bfloat16"):
        assert Dense(8, 4, compute=True)(x).dtype == torch.bfloat16
        assert Dense(8, 4)(x.bfloat16()).dtype == torch.float32
        assert Conv(8, 4, 3, compute=True)(x).dtype == torch.bfloat16
        assert Conv(8, 4, 3, compute=False)(x.bfloat16()).dtype == \
            torch.float32
        assert LayerNorm(8, compute=True)(x).dtype == torch.bfloat16
        assert LayerNorm(8)(x.bfloat16()).dtype == torch.float32
    assert Conv(8, 4, 3, compute=True)(x).dtype == torch.float32
    assert Conv(8, 4, 3, compute=True)(x.bfloat16()).dtype == torch.float32


def _jax_step(setup, cfg):
    """JAX's step at ``cfg``: (new state, metrics, gradients as the port's
    names, draws, kinds)."""
    inner = jstep.make_optimizer(cfg)
    captured = []

    def update(g, s, p=None):
        captured.append(g)
        return inner.update(g, s, p)

    tx = optax.GradientTransformation(inner.init, update)
    body = jstep.make_step_body(setup.model, cfg)
    state = jstep.TrainState.create(setup.variables["params"],
                                    setup.variables["codebook"], tx)
    kinds = {}

    @jax.jit
    def f(state, batch):
        captured.clear()
        draws = {}
        with no_dropout(), stash_draws(draws):
            new, metrics = body(state, batch, setup.rng, RQ_FORCE)
        kinds.update({k: [kind for kind, _ in v] for k, v in draws.items()})
        return new, metrics, captured[0], {k: [value for _, value in v]
                                           for k, v in draws.items()}

    new, metrics, grads, draws = f(state, {k: jnp.asarray(v) for k, v in
                                           setup.batch.items()})
    grads = {k: v.numpy() for k, v in from_jax_params(
        {"params": grads}).items()}
    return new, metrics, grads, draws, kinds


@pytest.fixture(scope="module")
def jax_steps(setup):
    """JAX's bf16 step and its f32 step on the same weights, batch and
    draws."""
    return (_jax_step(setup, setup.cfg),
            _jax_step(setup, tiny_test_config(compute_dtype="float32")))


def _rel(a, b, ref):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(ref), 1e-30))


def _port_step(setup, jax_steps, compute_dtype):
    """The port's step from the same weights, batch and draws at
    ``compute_dtype``: (state, metrics, the output dtypes of its
    ``compute=True`` layers, the parameters before the step)."""
    _, _, _, draws, kinds = jax_steps[0]
    port = setup.port_state()
    first = {k: to_np(v).copy() for k, v in port.model.named_parameters()}
    with precision.compute_layer_dtypes(port.model) as seen:
        tmetrics = tstep.train_step(
            port, tstep.batch_to_device(setup.batch, "cpu"),
            tstep.Phase(*RQ_FORCE),
            setup.tcfg.replace(compute_dtype=compute_dtype),
            noise=port_noise(kinds, draws, False))
    return port, tmetrics, seen, first


@pytest.fixture(scope="module")
def port_f32_grads(setup, jax_steps):
    """The port's own f32 gradient on the same weights, batch and draws."""
    port = _port_step(setup, jax_steps, "float32")[0]
    return {k: None if p.grad is None else to_np(p.grad)
            for k, p in port.model.named_parameters()}


def _grad_vector(grads, keys, like):
    return np.concatenate([np.zeros(like[k].size, np.float32)
                           if grads[k] is None else grads[k].ravel()
                           for k in keys])


def bf16_gate(setup, jax_steps, port_f32_grads, port, tmetrics, seen, first,
              check_dtypes=True):
    """The bf16 step's checks (module docstring); raises AssertionError."""
    (new, metrics, grads, _, _), (_, _, grads32, _, _) = jax_steps
    if check_dtypes:
        for site in BF16_SITES:
            assert any(name.endswith(site) for name in seen), site
        assert all(d == {torch.bfloat16} for d in seen.values()), seen
    assert set(tmetrics) == set(metrics)
    for k in metrics:
        assert np.isfinite(float(tmetrics[k])), k
        np.testing.assert_allclose(to_np(tmetrics[k]),
                                   np.asarray(metrics[k]), err_msg=k,
                                   **BF16_TOL)
    named = dict(port.model.named_parameters())
    ours = {k: np.zeros_like(grads[k]) if p.grad is None else to_np(p.grad)
            for k, p in named.items()}
    assert set(ours) == set(grads)
    # JAX's bf16 step on the CPU rounds inside its elementwise chains (gelu,
    # mish, the gates) where PyTorch rounds once per op, so its gradient is
    # the noisier one: the port's bf16 gradient is no further from JAX's
    # f32 gradient than JAX's bf16 gradient is, points the same way, and no
    # leaf is off by more than 30 % of the leaf's f32 norm
    keys = sorted(grads)
    p16, j16, j32 = (np.concatenate([d[k].ravel() for k in keys])
                     for d in (ours, grads, grads32))
    norm32 = np.linalg.norm(j32)
    assert np.linalg.norm(p16 - j32) <= np.linalg.norm(j16 - j32) + \
        1e-2 * norm32
    cos = p16 @ j16 / np.linalg.norm(p16) / np.linalg.norm(j16)
    assert cos > 0.98, cos
    # ... and is measurably off the port's own f32 gradient: by more than
    # MIN_BF16_SPREAD, and by more than MIN_SPREAD_OF_JAX of JAX's own
    # bf16-to-f32 distance
    p32 = _grad_vector(port_f32_grads, keys, grads)
    spread = np.linalg.norm(p16 - p32) / np.linalg.norm(p32)
    jax_spread = np.linalg.norm(j16 - j32) / norm32
    assert spread > MIN_BF16_SPREAD, ("spread", spread)
    assert spread > MIN_SPREAD_OF_JAX * jax_spread, ("spread", spread,
                                                    jax_spread)
    for k in keys:
        assert ours[k].dtype == np.float32, k
        scale = max(np.linalg.norm(grads32[k]), 1e-3 * norm32)
        assert np.linalg.norm(ours[k] - grads[k]) <= 0.3 * scale, k
    # the f32 parameters take optax's update of the port's own gradients;
    # the RQ buffers are JAX's
    lr = tstep.make_schedule(setup.tcfg)(0)
    tx = jstep.make_optimizer(setup.cfg)
    updates, _ = jax.jit(tx.update)(ours, tx.init(first), first)
    for k, u in updates.items():
        assert named[k].dtype == torch.float32, k
        np.testing.assert_allclose(to_np(named[k]), first[k] + np.asarray(u),
                                   atol=1e-3 * lr, rtol=0, err_msg=k)
    # the RQ buffers hold style vectors (the EMA sums and the restarts),
    # which carry the style encoder's bf16 noise: each within twice JAX's
    # own bf16-to-f32 distance plus 1e-2 of its norm
    ref16, ref32 = ({k: v.numpy() for k, v in from_jax_params(
        {"codebook": st.codebook}).items()}
        for st in (new, jax_steps[1][0]))
    buffers = {k: to_np(v) for k, v in port.model.state_dict().items()}
    for k, v in ref16.items():
        gap = np.linalg.norm(v - ref32[k])
        assert np.linalg.norm(buffers[k] - v) <= 2 * gap + \
            1e-2 * np.linalg.norm(ref32[k]), (k, np.linalg.norm(
                buffers[k] - v), gap)


def test_bf16_train_step_matches_jax(setup, jax_steps, port_f32_grads):
    bf16_gate(setup, jax_steps, port_f32_grads,
              *_port_step(setup, jax_steps, "bfloat16"))


def test_bf16_gate_fails_a_step_run_in_f32(setup, jax_steps, port_f32_grads):
    """Negative control: the same step with ``compute_dtype`` forced to f32
    fails the gate, on the layers' dtypes and, with that check off, on the
    distance from the f32 gradient alone."""
    run = _port_step(setup, jax_steps, "float32")
    with pytest.raises(AssertionError):
        bf16_gate(setup, jax_steps, port_f32_grads, *run)
    with pytest.raises(AssertionError, match="spread"):
        bf16_gate(setup, jax_steps, port_f32_grads, *run,
                  check_dtypes=False)


def test_bf16_eval_step_matches_jax(setup):
    eval_step = jstep.make_eval_step(setup.model, setup.cfg).__wrapped__
    state = jstep.TrainState.create(setup.variables["params"],
                                    setup.variables["codebook"],
                                    jstep.make_optimizer(setup.cfg))
    kinds = {}

    @jax.jit
    def f(state, batch):
        draws = {}
        with stash_draws(draws):
            losses = eval_step(state, batch, setup.rng, RQ_FORCE)
        kinds.update({k: [kind for kind, _ in v] for k, v in draws.items()})
        return losses, {k: [value for _, value in v]
                        for k, v in draws.items()}

    losses, draws = f(state, {k: jnp.asarray(v)
                              for k, v in setup.batch.items()})
    port = setup.port_state()
    tlosses = tstep.eval_step(port, tstep.batch_to_device(setup.batch, "cpu"),
                              tstep.Phase(*RQ_FORCE), setup.tcfg,
                              noise=port_noise(kinds, draws, False))
    assert set(tlosses) == set(losses)
    for k in losses:
        np.testing.assert_allclose(to_np(tlosses[k]), np.asarray(losses[k]),
                                   err_msg=k, **BF16_TOL)


def test_f32_setting_keeps_the_f32_step(setup, jax_steps):
    """``compute_dtype: float32`` is the f32 step: no activation in bf16 and
    the losses equal to JAX's f32 step at ``tests/test_torch_train.py``'s
    tolerance."""
    _, metrics, _, draws, kinds = jax_steps[1]
    port = setup.port_state()
    tcfg = setup.tcfg.replace(compute_dtype="float32")
    dtypes = set()
    hooks = [m.register_forward_hook(
        lambda m, i, o: dtypes.add(o.dtype) if isinstance(o, torch.Tensor)
        else None) for m in port.model.modules()]
    tmetrics = tstep.train_step(
        port, tstep.batch_to_device(setup.batch, "cpu"),
        tstep.Phase(*RQ_FORCE), tcfg, noise=port_noise(kinds, draws, False))
    for h in hooks:
        h.remove()
    assert dtypes == {torch.float32}, dtypes
    check_metrics(metrics, tmetrics)
