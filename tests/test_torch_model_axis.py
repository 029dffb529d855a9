"""The ``model`` mesh axis of the port (``parallel/mesh.py``: ``make_mesh``,
``param_shardings``, ``shard_params``; the Megatron split of every
``TransformerFFN``) against the JAX package's ``parallel/mesh.py``.

- ``param_shardings`` splits the leaves JAX's splits, on the same axes,
  for the tiny ``StyleSinger`` and ``FastSpeech2``;
- one spawn of 4 gloo ranks in a 2 x 2 grid: each loads the same weights,
  ``shard_params``, and takes ``train_step`` on its data index's rows of a
  4-row global batch, with JAX's draws of the global batch replayed
  (dropout on); against JAX's step body under ``jax.jit`` on
  ``make_mesh(n_data=2, n_model=2)`` with ``shard_params`` /
  ``shard_batch``.  Checked: the losses, every gradient leaf gathered to
  its full layout, the parameters and the RQ buffers after the step, at
  ``tests/test_torch_train.py``'s tolerances; the replicated leaves equal
  bit for bit across each model group (and all four gathered states
  equal); a checkpoint saved by all four ranks (gathered, rank 0 writes,
  with a milestone) restored re-sharded in the ranks and loaded whole in
  one process by ``StyleSingerInfer.load_params``;
- ``check_mesh_shape``'s message for ``mesh_shape.model`` > 1.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stylesinger_tpu.config import tiny_test_config
from stylesinger_tpu.models.stylesinger import StyleSinger as JaxStyleSinger
from stylesinger_tpu.parallel import mesh as jmesh
from stylesinger_tpu.training import step as jstep
from test_torch_distributed import _run_ranks
from test_torch_fs2 import CASES, _FS2Case
from test_torch_train import (
    RQ_FORCE, VOCAB, check_grads, check_metrics, check_params_and_buffers,
    synthetic_batch,
)
from torch_parity import random_variables, stash_draws

from stylesinger_torch.config import tiny_test_config as torch_tiny
from stylesinger_torch.convert import from_jax_params
from stylesinger_torch.models import FastSpeech2
from stylesinger_torch.models.stylesinger import StyleSinger
from stylesinger_torch.parallel import mesh
from stylesinger_torch.training import step as tstep

_WORKER = r"""
import json, os, sys
import numpy as np
import torch

from stylesinger_torch.config import tiny_test_config
from stylesinger_torch.models.stylesinger import StyleSinger
from stylesinger_torch.parallel import mesh
from stylesinger_torch.training import step as tstep
from stylesinger_torch.training.checkpoint import CheckpointManager

torch.set_num_threads(1)
d = sys.argv[1]
assert mesh.init_distributed("cpu") and mesh.world_size() == 4
m = mesh.make_mesh(n_data=2, n_model=2)
rank = mesh.rank()
assert (m.data_index, m.model_index) == (rank // 2, rank % 2)


class Replay:
    def __init__(self, kinds, values):
        self.draws = list(zip(kinds, values))

    def _next(self, kind, shape):
        k, a = self.draws.pop(0)
        assert k == kind and a.shape == tuple(shape), (k, a.shape, shape)
        return torch.tensor(a)

    def normal(self, shape):
        return self._next("n", shape)

    def uniform(self, shape):
        return self._next("u", shape)

    def randint(self, shape, low, high):
        return self._next("i", shape).long()

    def bernoulli(self, p, shape=()):
        return self._next("b", shape)


meta = json.load(open(os.path.join(d, "meta.json")))
draws = np.load(os.path.join(d, "draws.npz"))
noise = {s: Replay(meta["kinds"].get(s, []),
                   [draws[f"{s}_{i}"] for i in range(len(
                       meta["kinds"].get(s, [])))])
         for s in tstep.STREAMS}
cfg = tiny_test_config()
sd = np.load(os.path.join(d, "weights.npz"))


def sharded_state():
    model = StyleSinger(cfg, meta["vocab"])
    model.load_state_dict({k: torch.tensor(sd[k]) for k in sd.files})
    mesh.shard_params(model, m)
    return tstep.TrainState(model, tstep.Optimizer(
        dict(model.named_parameters()), cfg))


state = sharded_state()
split = mesh.split_dims(state.model)
assert split and all(p.shape[dim] * 2 == sd[name].shape[dim]
                     for name, dim in split.items()
                     for p in [dict(state.model.named_parameters())[name]])
rows = mesh.batch_sharding(m)
batch = {k: rows.local(torch.tensor(v), m) for k, v in
         np.load(os.path.join(d, "batch.npz")).items()}
metrics = tstep.train_step(state, tstep.batch_to_device(batch, "cpu"),
                           tstep.Phase(*meta["phase"]), cfg, noise=noise)
assert all(not src.draws for src in noise.values()), "draws left over"
model = state.model
grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
         for k, p in model.named_parameters()}
out = {f"metric/{k}": v.numpy() for k, v in metrics.items()}
out.update({f"state/{k}": v.numpy() for k, v in
            mesh.full_tensors(model, model.state_dict()).items()})
out.update({f"grad/{k}": v.numpy() for k, v in
            mesh.full_tensors(model, grads).items()})
out.update({f"replicated/{k}": v.numpy() for k, v in
            model.state_dict().items() if k not in split})
# a checkpoint and a milestone: gathered on every rank, written by rank 0,
# restored re-sharded into a fresh state
ckpt = CheckpointManager(os.path.join(d, "work"), milestone_interval=1)
ckpt.save(1, state)
torch.distributed.barrier()
assert ckpt.milestone_steps() == [1]
fresh, step = ckpt.restore(sharded_state())
assert step == 1
for a, b in ((fresh.model.state_dict(), model.state_dict()),
             (fresh.opt.state_dict()["mu"], state.opt.state_dict()["mu"]),
             (fresh.opt.state_dict()["nu"], state.opt.state_dict()["nu"])):
    for k in b:
        assert torch.equal(a[k], b[k]), k
np.savez(os.path.join(d, f"out{rank}.npz"), **out)
print(f"RANK_OK {rank}", flush=True)
"""


def _jax_specs(variables, n_model=2):
    """{port name: split axis of the 4h dimension} from JAX's
    ``param_shardings`` on a (1, n_model) mesh: each split leaf holds the
    index along its split axis, which ``from_jax_params`` carries to the
    port's layout."""
    jm = jmesh.make_mesh(n_data=1, n_model=n_model)
    specs = jmesh.param_shardings(jm, variables["params"])

    def mark(x, sharding):
        axes = [i for i, a in enumerate(sharding.spec) if a == "model"]
        if not axes:
            return np.full(x.shape, -1.0, np.float32)
        shape = [1] * x.ndim
        shape[axes[0]] = x.shape[axes[0]]
        return np.broadcast_to(np.arange(x.shape[axes[0]], dtype=np.float32)
                               .reshape(shape), x.shape).copy()

    tree = jax.tree_util.tree_map(mark, variables["params"], specs)
    return {k: v.numpy() for k, v in from_jax_params(
        {"params": tree}).items()}


def _check_shardings(port_model, variables):
    marked = _jax_specs(variables)
    port = mesh.param_shardings(mesh.Mesh(1, 2, 0, 0, None, None),
                                port_model.state_dict())
    assert set(port) >= set(marked)
    split = {k for k, v in marked.items() if (v >= 0).any()}
    assert split == {k for k, s in port.items() if s.axis == "model"}
    assert len(split) > 0
    for name in split:
        v, dim = marked[name], port[name].dim
        shape = [1] * v.ndim
        shape[dim] = v.shape[dim]
        want = np.broadcast_to(np.arange(v.shape[dim]).reshape(shape),
                               v.shape)
        np.testing.assert_array_equal(v, want, err_msg=name)
    assert all(s.axis is None for k, s in port.items() if k not in split)


def test_param_shardings_split_what_jax_splits_stylesinger(global_step):
    g = global_step
    _check_shardings(StyleSinger(torch_tiny(), VOCAB), g.variables)


def test_param_shardings_split_what_jax_splits_fastspeech2():
    case = _FS2Case(sorted(CASES)[0])
    port = FastSpeech2(case.tcfg, VOCAB,
                       out_dims=case.tcfg["audio_num_mel_bins"])
    _check_shardings(port, case.variables)


class _GridStep:
    """A 4-row global batch, seeded weights, and JAX's step body on it on a
    2 x 2 mesh with ``shard_params`` and ``shard_batch``."""

    def __init__(self):
        cfg = self.cfg = tiny_test_config()
        self.batch = synthetic_batch(cfg, 21, n=4)
        self.model = JaxStyleSinger(cfg, VOCAB)
        gb = {k: jnp.asarray(v) for k, v in self.batch.items()}
        rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(
            ("params",) + jstep._RNG_STREAMS)}
        self.variables = random_variables(
            self.model.init, rngs, **jstep._model_inputs(gb), infer=False,
            use_rq=True, forcing=False, use_diff=True, seed=5)

    def jax_step(self):
        cfg, variables = self.cfg, self.variables
        inner = jstep.make_optimizer(cfg)
        captured, kinds = [], {}

        def update(g, s, p=None):
            captured.append(g)
            return inner.update(g, s, p)

        tx = optax.GradientTransformation(inner.init, update)
        body = jstep.make_step_body(self.model, cfg)

        @jax.jit
        def f(state, batch):
            captured.clear()
            draws = {}
            with stash_draws(draws):   # dropout on: its masks replayed
                state, metrics = body(state, batch, jax.random.PRNGKey(7),
                                      RQ_FORCE)
            kinds.update({k: [kind for kind, _ in v]
                          for k, v in draws.items()})
            return state, metrics, captured[0], {
                k: [value for _, value in v] for k, v in draws.items()}

        jm = jmesh.make_mesh(n_data=2, n_model=2)
        state = jstep.TrainState.create(
            jmesh.shard_params(variables["params"], jm),
            variables["codebook"], tx)
        out = f(state, jmesh.shard_batch(self.batch, jm))
        return jax.tree_util.tree_map(np.asarray, out) + (kinds,)


@pytest.fixture(scope="module")
def global_step():
    return _GridStep()


@pytest.fixture(scope="module")
def grid_run(global_step, tmp_path_factory):
    """JAX's step, then the 4 ranks' (one spawn)."""
    g = global_step
    d = tmp_path_factory.mktemp("grid")
    state, metrics, grads, draws, kinds = g.jax_step()
    np.savez(d / "weights.npz", **{
        k: v.numpy() for k, v in from_jax_params(g.variables).items()})
    np.savez(d / "draws.npz", **{
        f"{s}_{i}": np.asarray(v) for s, vs in draws.items()
        for i, v in enumerate(vs)})
    np.savez(d / "batch.npz", **g.batch)
    (d / "meta.json").write_text(json.dumps(
        {"kinds": kinds, "vocab": VOCAB, "phase": list(RQ_FORCE)}))
    outs = _run_ranks([sys.executable, "-c", _WORKER, str(d)], world=4)
    assert all(f"RANK_OK {r}" in out for r, out in enumerate(outs))
    results = [dict(np.load(d / f"out{r}.npz")) for r in range(4)]
    return dict(dir=d, results=results, state=state, metrics=metrics,
                grads=grads)


def test_four_gloo_ranks_in_a_2x2_grid_match_jax(global_step, grid_run):
    g, run = global_step, grid_run
    results = run["results"]
    for r in (1, 2, 3):   # every rank ends with the same global state
        for k, v in results[0].items():
            if not k.startswith("replicated/"):
                np.testing.assert_array_equal(results[r][k], v, err_msg=k)
    for a, b in ((0, 1), (2, 3)):   # each model group's replicated leaves
        for k, v in results[a].items():
            if k.startswith("replicated/"):
                np.testing.assert_array_equal(results[b][k], v, err_msg=k)
    tcfg = torch_tiny()
    port_model = StyleSinger(tcfg, VOCAB)
    port_model.load_state_dict({k[6:]: torch.tensor(v) for k, v in
                                results[0].items() if k.startswith("state/")})
    for name, p in port_model.named_parameters():
        p.grad = torch.tensor(results[0][f"grad/{name}"])
    port = tstep.TrainState(port_model, tstep.Optimizer(
        dict(port_model.named_parameters()), tcfg), step=1)
    check_metrics(run["metrics"], {k[7:]: v for k, v in results[0].items()
                                   if k.startswith("metric/")})
    check_grads(run["grads"], port)
    first = {k: v.numpy() for k, v in from_jax_params(g.variables).items()
             if ".codebook_" not in k}
    check_params_and_buffers(run["state"], port,
                             tstep.make_schedule(tcfg)(0), run["grads"],
                             run["metrics"]["grad_norm"], g.cfg,
                             first_params=first)


def test_sharded_checkpoint_loads_in_one_process(grid_run):
    """The grid's checkpoint is in the full layout: ``load_params`` of its
    work dir in one process gives the gathered state, and so does the
    milestone."""
    from stylesinger_torch.inference import StyleSingerInfer
    from stylesinger_torch.training.checkpoint import load_payload

    phones = [f"p{i:02d}" for i in range(VOCAB - 3)]
    ti = StyleSingerInfer(torch_tiny(), phone_list=phones, device="cpu")
    ti.load_params(str(grid_run["dir"] / "work"))
    state = grid_run["results"][0]
    for k, v in ti.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), state[f"state/{k}"],
                                      err_msg=k)
    milestone = load_payload(str(grid_run["dir"] / "work" /
                                 "ckpt_milestones" / "model_ckpt_steps_1.pt"))
    assert set(milestone) == {"model", "step"} and milestone["step"] == 1
    for k, v in milestone["model"].items():
        np.testing.assert_array_equal(v.numpy(), state[f"state/{k}"],
                                      err_msg=k)


def test_mesh_shape_model_axis_names_the_calls_that_build_it():
    with pytest.raises(NotImplementedError,
                       match=r"make_mesh\(n_data, n_model\).*shard_params"):
        mesh.check_mesh_shape({"data": -1, "model": 2})
    mesh.check_mesh_shape({"data": -1, "model": 1})


def test_trainer_takes_a_mesh_and_refuses_a_split_model(tmp_path):
    """``Trainer(mesh=)`` makes the grid the process's mesh and shards the
    batch only, as JAX's does: a model split by ``shard_params`` raises."""
    from stylesinger_torch.training.trainer import Trainer

    cfg = torch_tiny()
    grid = mesh.Mesh(1, 2, 0, 0, None, None)   # no process group needed
    model = mesh.shard_params(StyleSinger(cfg, VOCAB), grid)
    assert set(mesh.split_dims(model)) == {
        k for k, s in mesh.param_shardings(grid, StyleSinger(
            cfg, VOCAB).state_dict()).items() if s.axis == "model"}
    try:
        with pytest.raises(ValueError, match="split over a model axis"):
            Trainer(model, cfg, str(tmp_path), device="cpu", mesh=grid)
        assert mesh.data_size() == 1 and mesh.data_rank() == 0
    finally:
        mesh.use_mesh(None)
