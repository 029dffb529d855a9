"""The FastSpeech2 family of the port against the JAX package on the CPU,
at ``tiny_test_config``: ``FastSpeech2`` (``frame`` pitch with energy and
d-vectors, ``ph`` pitch with speaker ids, ``cwt`` pitch), the
``PitchExtractor`` and ``pe_loss``, one train step of each
(``training/fs2_task.py``), and the ``F0DiffNet`` / ``MDiffNet``
denoisers.

Same seeded weights (``random_variables`` -> ``from_jax_params``) and
numpy inputs on both sides.  Each FastSpeech2 case runs the training pass
(ground-truth ``mel2ph``, f0, uv and energy, deterministic) and the
inference pass (predicted durations, pitch and energy) in one JAX compile.
The train steps run with dropout on, JAX's masks replayed into the port.

Tolerances: outputs atol 2e-4 / rtol 2e-3 (``tests/test_convert.py``);
``mel2ph`` and the coarse pitch exactly equal; the train steps at
``tests/test_torch_train.py``'s: losses atol 2e-4 / rtol 2e-3, each
gradient leaf atol 2e-4 * max|g_leaf| (floor 1e-7 * max|g|) + rtol 2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stylesinger_tpu.config import tiny_test_config
from stylesinger_tpu.models.diffnet import F0DiffNet as JaxF0DiffNet
from stylesinger_tpu.models.diffnet import MDiffNet as JaxMDiffNet
from stylesinger_tpu.models.fs2 import FastSpeech2 as JaxFS2
from stylesinger_tpu.models.pe import PitchExtractor as JaxPE
from stylesinger_tpu.models.pe import pe_loss as jax_pe_loss
from stylesinger_tpu.training import fs2_task as jtask
from stylesinger_tpu.training.step import TrainState, make_optimizer
from test_torch_train import check_grads, check_metrics
from torch_parity import (
    Replay, one_torch_thread, random_variables, stash_draws, to_np,
)

from stylesinger_torch.config import tiny_test_config as torch_tiny
from stylesinger_torch.convert import from_jax_params
from stylesinger_torch.models import FastSpeech2
from stylesinger_torch.models.diffnet import F0DiffNet, MDiffNet
from stylesinger_torch.models.pe import PitchExtractor, pe_loss
from stylesinger_torch.training import fs2_task
from stylesinger_torch.training.step import Optimizer

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = dict(atol=2e-4, rtol=2e-3)
VOCAB = 20
B, T_TXT, T_MEL = 2, 8, 32
CASES = {
    "frame_energy_dvector": dict(pitch_type="frame", use_energy_embed=True),
    "ph_spk_id": dict(pitch_type="ph", use_spk_embed=False,
                      use_spk_id=True, num_spk=4),
    "cwt": dict(pitch_type="cwt"),
}
_KEYS = ("mel_out", "dur", "decoder_inp", "f0_denorm", "pitch_pred", "cwt",
         "f0_mean", "f0_std", "energy_pred")


def fs2_batch(cfg, seed):
    """A padded FastSpeech2 batch as numpy: 4 frames per phone, the last
    phone and frames of the second item padding."""
    rng = np.random.default_rng(seed)
    m = cfg["audio_num_mel_bins"]
    txt = rng.integers(1, VOCAB, (B, T_TXT))
    txt[1, -2:] = 0
    mel2ph = np.repeat(np.arange(1, T_TXT + 1), 4)[None].repeat(B, 0)
    mel2ph[1, -8:] = 0
    frames = (mel2ph > 0)[..., None]
    ph = cfg["pitch_type"] == "ph"
    f0 = rng.uniform(7.0, 8.5, (B, T_TXT if ph else T_MEL))
    uv = (rng.uniform(size=(B, T_MEL)) < 0.3).astype(np.float32)
    spk = rng.integers(1, cfg["num_spk"] + 1, (B,)) if cfg["use_spk_id"] \
        else rng.standard_normal((B, 256)).astype(np.float32)
    return dict(
        txt_tokens=txt, mel2ph=mel2ph, spk_embed=spk,
        f0=f0.astype(np.float32), uv=uv * frames[..., 0],
        energy=rng.uniform(0.0, 3.99, (B, T_MEL)).astype(np.float32),
        mels=(rng.standard_normal((B, T_MEL, m)) * frames).astype(
            np.float32),
        is_sil=(rng.uniform(size=(B, T_TXT)) < 0.2).astype(np.float32))


def _args(batch):
    return (batch["txt_tokens"], batch["mel2ph"], batch["spk_embed"],
            batch["f0"], batch["uv"], batch["energy"])


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


class _FS2Case:
    def __init__(self, name):
        self.cfg = tiny_test_config(**CASES[name])
        self.tcfg = torch_tiny(**CASES[name])
        self.model = JaxFS2(self.cfg, VOCAB,
                            out_dims=self.cfg["audio_num_mel_bins"])
        self.batch = fs2_batch(self.cfg, 3)
        rngs = {"params": jax.random.PRNGKey(0),
                "dropout": jax.random.PRNGKey(1)}
        self.variables = random_variables(
            self.model.init, rngs, *map(jnp.asarray, _args(self.batch)),
            infer=False, seed=5)

    def port(self):
        model = FastSpeech2(self.tcfg, VOCAB,
                            out_dims=self.tcfg["audio_num_mel_bins"])
        model.load_state_dict(from_jax_params(self.variables))
        return model


@pytest.fixture(scope="module", params=sorted(CASES))
def fs2_case(request):
    return _FS2Case(request.param)


def test_fastspeech2_matches_jax(fs2_case):
    c = fs2_case
    b = c.batch

    @jax.jit
    def both(v, txt, mel2ph, spk, f0, uv, energy):
        train = c.model.apply(v, txt, mel2ph, spk, f0, uv, energy,
                              infer=False, deterministic=True)
        infer = c.model.apply(v, txt, None, spk, infer=True)
        return train, infer

    train, infer = both(c.variables, *map(jnp.asarray, _args(b)))
    model = c.port()
    tb = _torch(b)
    with torch.no_grad():
        ttrain = model(*_args(tb), infer=False)
        tinfer = model(tb["txt_tokens"], None, tb["spk_embed"], infer=True)
    for ref, ours in ((train, ttrain), (infer, tinfer)):
        np.testing.assert_array_equal(to_np(ours["mel2ph"]),
                                      np.asarray(ref["mel2ph"]))
        assert set(ours) == set(ref)
        for k in _KEYS:
            if k in ref:
                np.testing.assert_allclose(to_np(ours[k]), np.asarray(ref[k]),
                                           err_msg=k, **TOL)
    assert np.asarray(infer["mel2ph"]).max() > 0
    if c.cfg["use_energy_embed"]:
        assert "energy_pred" in ttrain


def _jax_train_step(make_step, model, cfg, variables, batch, seed):
    """One JAX step from ``variables`` with dropout on: (losses, grads,
    kinds, draws)."""
    inner = make_optimizer(cfg)
    captured, kinds = [], []

    def update(g, s, p=None):
        captured.append(g)
        return inner.update(g, s, p)

    tx = optax.GradientTransformation(inner.init, update)
    body = make_step(model, cfg).__wrapped__

    @jax.jit
    def f(state, batch):
        captured.clear()
        draws = []
        with stash_draws(draws):
            _, losses = body(state, batch, jax.random.PRNGKey(seed))
        kinds[:] = [kind for kind, _ in draws]
        return losses, captured[0], [value for _, value in draws]

    losses, grads, values = f(TrainState.create(variables["params"], {}, tx),
                              {k: jnp.asarray(v) for k, v in batch.items()})
    return losses, grads, list(zip(kinds, values))


class _Port:
    """What ``check_grads`` reads: the model after the step."""

    def __init__(self, model):
        self.model = model


def test_fs2_train_step_matches_jax(fs2_case):
    c = fs2_case
    batch = dict(c.batch)
    if not c.cfg["use_energy_embed"]:
        batch.pop("energy")
    losses, grads, draws = _jax_train_step(
        jtask.make_fs2_train_step, c.model, c.cfg, c.variables, batch, 9)
    model = c.port()
    state = fs2_task.TrainState(model, Optimizer(
        dict(model.named_parameters()), c.tcfg))
    replay = Replay(draws)
    tlosses = fs2_task.make_fs2_train_step(c.tcfg)(
        state, _torch(batch), drop=replay)
    assert not replay.draws and state.step == 1
    check_metrics(losses, tlosses)
    assert {"l1", "ssim", "pdur", "total_loss"} <= set(tlosses)
    assert ({"uv", "f0"} <= set(tlosses)) == \
        (c.cfg["pitch_type"] == "frame")
    check_grads(grads, _Port(model))


@pytest.fixture(scope="module")
def pe_setup():
    cfg, tcfg = tiny_test_config(), torch_tiny()
    batch = fs2_batch(cfg, 4)
    batch = {k: batch[k] for k in ("mels", "f0", "uv")}
    model = JaxPE(cfg)
    variables = random_variables(
        model.init, {"params": jax.random.PRNGKey(0)},
        jnp.asarray(batch["mels"]), seed=6)
    port = PitchExtractor(tcfg)
    port.load_state_dict(from_jax_params(variables))
    return cfg, tcfg, batch, model, variables, port


def test_pitch_extractor_and_loss_match_jax(pe_setup):
    cfg, tcfg, batch, model, variables, port = pe_setup

    @jax.jit
    def run(v, mels, f0, uv):
        ret = model.apply(v, mels)
        return ret, jax_pe_loss(ret, f0, uv, cfg)

    ret, losses = run(variables, *(jnp.asarray(batch[k])
                                   for k in ("mels", "f0", "uv")))
    tb = _torch(batch)
    with torch.no_grad():
        tret = port(tb["mels"])
        tlosses = pe_loss(tret, tb["f0"], tb["uv"], tcfg)
    assert set(tret) == set(ret) and set(tlosses) == set(losses) == \
        {"uv", "f0"}
    np.testing.assert_array_equal(to_np(tret["nonpadding"]),
                                  np.asarray(ret["nonpadding"]))
    for k in ("pitch_pred", "f0_denorm_pred"):
        np.testing.assert_allclose(to_np(tret[k]), np.asarray(ret[k]),
                                   err_msg=k, **TOL)
    check_metrics(losses, tlosses)


def test_pe_train_step_matches_jax(pe_setup):
    cfg, tcfg, batch, model, variables, port = pe_setup
    losses, grads, draws = _jax_train_step(
        jtask.make_pe_train_step, model, cfg, variables, batch, 10)
    port = PitchExtractor(tcfg)
    port.load_state_dict(from_jax_params(variables))
    state = fs2_task.TrainState(port, Optimizer(
        dict(port.named_parameters()), tcfg))
    replay = Replay(draws)
    tlosses = fs2_task.make_pe_train_step(tcfg)(state, _torch(batch),
                                                      drop=replay)
    assert not replay.draws and state.step == 1
    check_metrics(losses, tlosses)
    check_grads(grads, _Port(port))


def test_fs2_step_draws_its_own_dropout():
    """Without ``drop`` the step takes the seeded ``dropout`` stream of its
    global step: the same weights and batch give the same losses."""
    tcfg = torch_tiny()
    batch = _torch(fs2_batch(tcfg, 5))
    outs = []
    for _ in range(2):
        model = FastSpeech2(tcfg, VOCAB, out_dims=16)
        state = fs2_task.init_fs2_state(model, tcfg, seed=3)
        step = fs2_task.make_fs2_train_step(tcfg)
        outs.append([step(state, batch)["total_loss"] for _ in range(2)])
    assert torch.equal(torch.stack(outs[0]), torch.stack(outs[1]))
    assert outs[0][0] != outs[0][1]


@pytest.mark.parametrize("name", ["F0DiffNet", "MDiffNet"])
def test_f0_and_uv_denoisers_match_jax(name):
    rng = np.random.default_rng(8)
    cond_dim, t = 12, 24
    mask = np.ones((B, t), np.float32)
    mask[1, -5:] = 0
    cond = rng.standard_normal((B, t, cond_dim)).astype(np.float32)
    steps = np.array([3, 17])
    if name == "F0DiffNet":
        jm = JaxF0DiffNet(residual_layers=3, residual_channels=8)
        x = rng.standard_normal((B, t, 1)).astype(np.float32)
        port = F0DiffNet(cond_dim=cond_dim, residual_layers=3,
                         residual_channels=8)
    else:
        jm = JaxMDiffNet(residual_layers=3, residual_channels=8)
        x = rng.integers(0, 2, (B, t))
        port = MDiffNet(cond_dim=cond_dim, residual_layers=3,
                        residual_channels=8)
    args = (x, steps, cond, mask)
    variables = random_variables(jm.init, jax.random.PRNGKey(0),
                                 *map(jnp.asarray, args), seed=2)
    ref = jax.jit(jm.apply)(variables, *map(jnp.asarray, args))
    port.load_state_dict(from_jax_params(variables))
    with torch.no_grad():
        ours = port(*(torch.as_tensor(a) for a in args))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(to_np(ours), np.asarray(ref), **TOL)
