"""The StyleSinger settings the port refused until now, each one train step
against the JAX package's ``make_step_body`` on the CPU at
``tiny_test_config``: ProDiff's training loss (``decoder: prodiff``, on the
WaveNet denoiser, and on the FFT denoiser with dropout replayed),
``use_spk_id``, ``rel_pos`` and ``pitch_type: ph``; and the ``spk_id``
field through the dataset and the collate.

Both sides start from the same seeded weights (``random_variables`` ->
``from_jax_params``) and batch, and the port replays JAX's draws stream by
stream.  Tolerances are ``tests/test_torch_train.py``'s: losses,
``total_loss`` and ``grad_norm`` atol 2e-4 / rtol 2e-3; each gradient leaf
atol 2e-4 * max|g_leaf| + rtol 2e-3 (floor 1e-7 * max|g|); the parameters
after the update atol 0.05 * lr where JAX's clipped gradient is at least
1e-6, and optax's update of the port's gradients atol 1e-3 * lr; the RQ
buffers atol 2e-4 / rtol 2e-3.

``use_spk_id``: JAX's model reads the speaker ids from ``spk_embed`` (its
collate drops the dataset's ``spk_id``); the port's collate stacks
``spk_id`` and its step hands it to the model, so the JAX batch here
carries the same ids in ``spk_embed``.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from stylesinger_tpu.config import tiny_test_config
from stylesinger_tpu.data.batching import collate_batch as jax_collate
from stylesinger_tpu.data.dataset import StyleSingerDataset as JaxDataset
from stylesinger_tpu.models.stylesinger import StyleSinger as JaxStyleSinger
from stylesinger_tpu.training import step as jstep
from test_torch_train import (
    RQ_FORCE, VOCAB, check_grads, check_metrics, check_params_and_buffers,
    port_noise, synthetic_batch, synthetic_items,
)
from torch_parity import (
    no_dropout, one_torch_thread, random_variables, stash_draws, to_np,
)

from stylesinger_torch.config import tiny_test_config as torch_tiny
from stylesinger_torch.convert import from_jax_params
from stylesinger_torch.data.batching import collate_batch
from stylesinger_torch.data.dataset import StyleSingerDataset
from stylesinger_torch.models.stylesinger import StyleSinger
from stylesinger_torch.training import step as tstep

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SPK_IDS = np.array([3, 7, 1, 150])

CASES = {
    "prodiff": (dict(decoder="prodiff"), False),
    "prodiff_fft_dropout": (dict(decoder="prodiff",
                                 diff_decoder_type="fft"), True),
    "use_spk_id": (dict(use_spk_id=True), False),
    "rel_pos": (dict(rel_pos=True), False),
    "pitch_type_ph": (dict(pitch_type="ph"), False),
}


def _batches(cfg):
    """The JAX batch and the port's batch (the port's has ``spk_id`` where
    JAX's carries the ids in ``spk_embed``)."""
    batch = synthetic_batch(cfg, 3)
    port = dict(batch)
    if cfg.get("use_spk_id"):
        batch = dict(batch, spk_embed=SPK_IDS.astype(np.float32))
        port["spk_id"] = SPK_IDS
    return batch, port


@pytest.mark.parametrize("case", list(CASES))
def test_setting_train_step_matches_jax(case):
    overrides, dropout = CASES[case]
    cfg = tiny_test_config(**overrides)
    tcfg = torch_tiny(**overrides)
    model = JaxStyleSinger(cfg, VOCAB)
    batch, port_batch = _batches(cfg)
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(
        ("params",) + jstep._RNG_STREAMS)}
    variables = random_variables(
        model.init, rngs, **jstep._model_inputs(b), infer=False,
        use_rq=True, forcing=False, use_diff=True, seed=5)

    inner = jstep.make_optimizer(cfg)
    captured = []

    def update(g, s, p=None):
        captured.append(g)
        return inner.update(g, s, p)

    tx = optax.GradientTransformation(inner.init, update)
    body = jstep.make_step_body(model, cfg)
    kinds = {}

    @jax.jit
    def f(state, batch):
        captured.clear()
        draws = {}
        off = contextlib.nullcontext() if dropout else no_dropout()
        with off, stash_draws(draws):
            state, metrics = body(state, batch, jax.random.PRNGKey(7),
                                  RQ_FORCE)
        kinds.update({k: [kind for kind, _ in v] for k, v in draws.items()})
        return state, metrics, captured[0], {
            k: [value for _, value in v] for k, v in draws.items()}

    state = jstep.TrainState.create(variables["params"],
                                    variables["codebook"], tx)
    state, metrics, grads, draws = f(state, b)

    port_model = StyleSinger(tcfg, VOCAB)
    port_model.load_state_dict(from_jax_params(variables))
    port = tstep.TrainState(port_model, tstep.Optimizer(
        dict(port_model.named_parameters()), tcfg))
    noise = port_noise(kinds, draws, dropout)
    tmetrics = tstep.train_step(port, tstep.batch_to_device(port_batch,
                                                            "cpu"),
                                tstep.Phase(*RQ_FORCE), tcfg, noise=noise)
    for stream, src in noise.items():
        assert src is None or not src.draws, f"{stream} draws left over"
    check_metrics(metrics, tmetrics)
    check_grads(grads, port)
    first = {k: v.numpy() for k, v in from_jax_params(variables).items()
             if ".codebook_" not in k}
    check_params_and_buffers(state, port, tstep.make_schedule(tcfg)(0),
                             grads, metrics["grad_norm"], cfg,
                             first_params=first)
    if cfg["decoder"] == "prodiff":
        assert "diff" not in tmetrics and "l1" in tmetrics
        assert kinds["diffusion"][-2:] == ["i", "n"]   # t, then the noise
    if cfg.get("use_spk_id"):
        emb = dict(port.model.named_parameters())["spk_embed_proj.weight"]
        assert tuple(emb.shape) == (cfg["num_spk"] + 1, cfg["hidden_size"])


def test_spk_id_through_dataset_and_collate():
    cfg = tiny_test_config(use_spk_id=True)
    tcfg = torch_tiny(use_spk_id=True)
    items = synthetic_items(cfg, np.random.default_rng(3), 3)
    for item, spk in zip(items, (4, 0, 9)):
        item["spk_id"] = spk
    jds = JaxDataset(cfg, "train", items=items)
    tds = StyleSingerDataset(tcfg, "train", items=items)
    for i in range(3):
        assert tds[i]["spk_id"] == jds[i]["spk_id"]
    batch = collate_batch([tds[i] for i in range(3)], tcfg["frame_buckets"],
                          tcfg["token_buckets"])
    assert batch["spk_id"].dtype == np.int64
    np.testing.assert_array_equal(batch["spk_id"], [4, 0, 9, 0])
    ref = jax_collate([jds[i] for i in range(3)], cfg["frame_buckets"],
                      cfg["token_buckets"])
    for k, v in ref.items():
        np.testing.assert_array_equal(np.asarray(batch[k]), np.asarray(v),
                                      err_msg=k)
    assert tstep.model_inputs(tstep.batch_to_device(batch, "cpu"))[
        "spk_embed"].tolist() == [4, 0, 9, 0]
    # without the setting the dataset holds no id
    assert "spk_id" not in StyleSingerDataset(torch_tiny(), "train",
                                              items=items)[0]


def test_settings_build_without_refusal():
    for overrides, _ in CASES.values():
        StyleSinger(torch_tiny(**overrides), VOCAB)
    for bad in (dict(f0_gen="cwt"), dict(decoder="wavenet")):
        with pytest.raises(NotImplementedError):
            StyleSinger(torch_tiny(**bad), VOCAB)
