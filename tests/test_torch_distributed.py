"""Data parallel training of the port across processes against the JAX
package's step on the global batch, on the CPU (gloo).

Two processes each hold different rows in different natural buckets
(rank 0: 2 items, 32 frames / 8 phones; rank 1: 3 items in a 4-row batch,
64 frames / 16 phones).  The JAX package's ``make_step_body`` takes the
global batch: both batches padded to the common bucket and concatenated in
rank order, what its multi-process test builds with
``make_array_from_process_local_data``.  Each port process replays JAX's
draws of the global batch (dropout on) and takes its own rows.  Checked:
the losses on both ranks, the summed gradients, the updated parameters
and the RQ buffers against JAX's, and both ranks' states equal.  Also: the
``EpochBatches`` rank split against JAX's, field for field, and ``run.py
train`` in two processes.

Every fifth frame of each item's mel is silent (all bins 0) inside the
item, so the style encoder's mask has holes there.  At such a frame the
style encoder's first LayerNorm sees a row that is constant across its
channels (the interpolated f0 added to a WaveNet output masked to 0): its
variance is pure rounding, which the LayerNorm divides by sqrt(1e-6).  In
f32 JAX's and PyTorch's rounding differ there, and the gradients of the
layers before it move apart by up to ~5e-4 of a leaf's largest value; in
f64 the port agrees with JAX at the default tolerance
(:func:`test_interior_silent_frames_match_jax_in_f64`).  JAX's f32 and f64
steps draw the same noise (:func:`draws_in_32_bits`).

Tolerances are ``tests/test_torch_train.py``'s: losses, ``total_loss`` and
``grad_norm`` atol 2e-4 / rtol 2e-3; each gradient leaf atol 2e-4 *
max|g_leaf| + rtol 2e-3 (floor 1e-7 * max|g|), and in f32 each element
also within twice JAX's own f32-against-f64 gap at that element, measured
on the same batch; the parameters atol 0.05 * lr where JAX's clipped
gradient is at least 1e-6 and clear of that gap, and optax's update of the
port's gradients atol 1e-3 * lr; the RQ buffers atol 2e-4 / rtol 2e-3.
Each process wait has a timeout; a rank that fails or times out fails the
test.
"""

import contextlib
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stylesinger_tpu.config import tiny_test_config
from stylesinger_tpu.data.batching import EpochBatches as JaxEpochBatches
from stylesinger_tpu.data.batching import collate_batch
from stylesinger_tpu.data.dataset import StyleSingerDataset as JaxDataset
from stylesinger_tpu.models.stylesinger import StyleSinger as JaxStyleSinger
from stylesinger_tpu.training import step as jstep
from stylesinger_tpu.models.style import LocalStyleAdaptor as JaxLSA
from test_torch_train import (
    RQ_FORCE, TOL, VOCAB, check_grads, check_metrics,
    check_params_and_buffers, synthetic_items,
)
from test_torch_trainer import _write_corpus, tiny
from torch_parity import Replay, random_variables, stash_draws, to_np

from stylesinger_torch.config import load_config
from stylesinger_torch.config import tiny_test_config as torch_tiny
from stylesinger_torch.convert import from_jax_params
from stylesinger_torch.data.batching import EpochBatches
from stylesinger_torch.data.dataset import StyleSingerDataset
from stylesinger_torch.models.style import LocalStyleAdaptor
from stylesinger_torch.models.stylesinger import StyleSinger
from stylesinger_torch.training import step as tstep

REPO = Path(__file__).resolve().parents[1]
WAIT = 300   # seconds per process

_WORKER = r"""
import json, os, sys
import numpy as np
import torch

from stylesinger_torch.config import tiny_test_config
from stylesinger_torch.models.stylesinger import StyleSinger
from stylesinger_torch.parallel import mesh
from stylesinger_torch.training import step as tstep

torch.set_num_threads(1)
d = sys.argv[1]
assert mesh.init_distributed("cpu") and mesh.world_size() == 2
rank = mesh.rank()


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
model = StyleSinger(cfg, meta["vocab"])
sd = np.load(os.path.join(d, "weights.npz"))
model.load_state_dict({k: torch.tensor(sd[k]) for k in sd.files})
state = tstep.TrainState(model, tstep.Optimizer(
    dict(model.named_parameters()), cfg))
batch = dict(np.load(os.path.join(d, f"batch{rank}.npz")))
metrics = tstep.train_step(state, tstep.batch_to_device(batch, "cpu"),
                           tstep.Phase(*meta["phase"]), cfg, noise=noise)
assert all(not src.draws for src in noise.values()), "draws left over"
out = {f"metric/{k}": v.numpy() for k, v in metrics.items()}
out.update({f"state/{k}": v.numpy() for k, v in model.state_dict().items()})
out.update({f"grad/{k}": (torch.zeros_like(p) if p.grad is None
                          else p.grad).numpy()
            for k, p in model.named_parameters()})
np.savez(os.path.join(d, f"out{rank}.npz"), **out)
print(f"RANK_OK {rank}", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(args, world=2, timeout=WAIT, cwd=REPO):
    """Runs ``args`` once per rank with torchrun's variables; returns the
    outputs, failing when a rank fails or outlives ``timeout``."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               WORLD_SIZE=str(world), MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()))
    procs = [subprocess.Popen(args, cwd=cwd, env=dict(
        env, RANK=str(r), LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [f"rank {r} failed:\n{out[-3000:]}" for r, (p, out) in
              enumerate(zip(procs, outs)) if p.returncode != 0]
    assert not failed, "\n".join(failed)
    return outs


def _local_batch(cfg, seed, n, long):
    items = synthetic_items(cfg, np.random.default_rng(seed), n)
    if long:   # 40-60 frames and more phones: the next buckets
        for it in items:
            t = len(it["mel"]) + 30
            tt = t // 4
            it["mel"] = np.resize(it["mel"], (t, it["mel"].shape[1]))
            it["mel2ph"] = np.repeat(np.arange(1, tt + 1), 4)[:t]
            it["f0"] = np.resize(it["f0"], t)
            for k in ("ph_token", "ep_pitches", "ep_types"):
                it[k] = np.resize(it[k], tt)
            it["ep_notedurs"] = np.resize(it["ep_notedurs"], tt)
    for it in items:   # the masks the losses count differ from each other
        it["f0"][1::3] = 0.0        # unvoiced frames
        it["mel2ph"][-2:] = 0       # frames of the mel outside every phone
        it["mel"][2::5] = 0.0       # silent frames inside the item
    ds = JaxDataset(cfg, "train", items=items)
    batch = collate_batch([ds[i] for i in range(n)], cfg["frame_buckets"],
                          cfg["token_buckets"])
    return {k: v for k, v in batch.items() if k != "nsamples"}


def _pad_to(batch, t_mel, t_txt):
    out = {}
    for k, v in batch.items():
        length = t_mel if k in ("mels", "mel2ph", "f0", "uv") else \
            t_txt if k in ("txt_tokens", "notes", "note_durs",
                           "note_types") else None
        if length is not None:
            widths = [(0, 0), (0, length - v.shape[1])] + \
                [(0, 0)] * (v.ndim - 2)
            v = np.pad(v, widths)
        out[k] = v
    return out


_DRAWS = ("normal", "uniform", "bernoulli", "randint")


@contextlib.contextmanager
def draws_in_32_bits():
    """Under ``jax.enable_x64`` every ``jax.random`` normal, uniform,
    bernoulli and randint draws what it draws without x64 (32-bit values),
    cast to the dtype asked for, so that an f64 step sees the f32 step's
    noise."""
    saved = {name: getattr(jax.random, name) for name in _DRAWS}

    def normal(key, shape=(), dtype=None):
        return saved["normal"](key, shape, jnp.float32).astype(
            dtype or jnp.float64)

    def uniform(key, shape=(), dtype=None, minval=0.0, maxval=1.0):
        return saved["uniform"](key, shape, jnp.float32, minval,
                                maxval).astype(dtype or jnp.float64)

    def bernoulli(key, p=0.5, shape=None):
        return saved["bernoulli"](key, jnp.asarray(p, jnp.float32), shape)

    def randint(key, shape, minval, maxval, dtype=None):
        return saved["randint"](key, shape, minval, maxval,
                                jnp.int32).astype(dtype or jnp.int64)

    for name in _DRAWS:
        setattr(jax.random, name, locals()[name])
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(jax.random, name, fn)


def _jax_step(model, cfg, variables, batch, x64):
    """JAX's step (dropout on) on ``batch``: (state, metrics, grads, draws,
    kinds) as numpy, ``draws[stream]`` in line with ``kinds[stream]``."""
    inner = jstep.make_optimizer(cfg)
    captured, kinds = [], {}

    def update(g, s, p=None):
        captured.append(g)
        return inner.update(g, s, p)

    tx = optax.GradientTransformation(inner.init, update)
    body = jstep.make_step_body(model, cfg)

    @jax.jit
    def f(state, batch):
        captured.clear()
        draws = {}
        bits = draws_in_32_bits() if x64 else contextlib.nullcontext()
        with bits, stash_draws(draws):   # dropout on: its masks replayed
            state, metrics = body(state, batch, jax.random.PRNGKey(7),
                                  RQ_FORCE)
        kinds.update({k: [kind for kind, _ in v] for k, v in draws.items()})
        return state, metrics, captured[0], {
            k: [value for _, value in v] for k, v in draws.items()}

    state, metrics, grads, draws = jax.tree_util.tree_map(
        np.asarray, f(jstep.TrainState.create(
            variables["params"], variables["codebook"], tx),
            {k: jnp.asarray(v) for k, v in batch.items()}))
    return state, metrics, grads, draws, kinds


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64)
        if np.asarray(a).dtype.kind == "f" else np.asarray(a), tree)


class _GlobalStep:
    """Two ranks' batches, the global batch, seeded weights, and JAX's step
    on the global batch in f32 and in f64 (same draws)."""

    def __init__(self):
        cfg = self.cfg = tiny_test_config()
        self.locals = [_local_batch(cfg, 11, 2, False),
                       _local_batch(cfg, 12, 3, True)]
        t_mel = max(b["mels"].shape[1] for b in self.locals)
        t_txt = max(b["txt_tokens"].shape[1] for b in self.locals)
        padded = [_pad_to(b, t_mel, t_txt) for b in self.locals]
        self.batch = {k: np.concatenate([p[k] for p in padded])
                      for k in padded[0]}
        self.model = JaxStyleSinger(cfg, VOCAB)
        gb = {k: jnp.asarray(v) for k, v in self.batch.items()}
        rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(
            ("params",) + jstep._RNG_STREAMS)}
        self.variables = random_variables(
            self.model.init, rngs, **jstep._model_inputs(gb), infer=False,
            use_rq=True, forcing=False, use_diff=True, seed=5)
        self.f32 = _jax_step(self.model, cfg, self.variables, self.batch,
                             False)
        with jax.enable_x64(True):
            self.f64 = _jax_step(self.model, cfg, _f64(self.variables),
                                 _f64(self.batch), True)

    def grads(self, which):
        return {k: v.numpy() for k, v in from_jax_params(
            {"params": _f64(which[2])}).items()}


@pytest.fixture(scope="module")
def global_step():
    return _GlobalStep()


def _port_noise(kinds, draws):
    return {s: Replay(list(zip(kinds.get(s, []), draws.get(s, []))))
            for s in tstep.STREAMS}


def test_interior_silent_frames_match_jax_in_f64(global_step):
    """Fault 6's cause: in f64 the style adaptor and the whole step agree
    with JAX at the default tolerance on items with silent frames inside
    them; the f32 gap is rounding at rows that are constant across their
    channels."""
    g = global_step
    cfg, batch = g.cfg, g.batch
    assert (np.abs(batch["mels"][:, :, 0]) <= 1e-8).any(axis=1).all()
    # the style adaptor alone, inference-mode RQ
    jlsa = JaxLSA(cfg["hidden_size"], n_codes=cfg["nRQ"],
                  rq_depth=cfg["rq_depth"], rq_decay=cfg["rq_decay"],
                  vae_dropout=cfg["vae_dropout"],
                  mel_bins=cfg["audio_num_mel_bins"],
                  wn_layers=cfg.get("style_wn_layers", 4),
                  conv_dilations=tuple(cfg.get("style_conv_dilations",
                                               (1,) * 5)))
    lsa_vars = {"params": g.variables["params"]["style_extractor"],
                "codebook": g.variables["codebook"]["style_extractor"]}
    with jax.enable_x64(True):
        quant, loss, codes = jax.jit(lambda v, m, f: jlsa.apply(
            v, m, f, use_rq=True))(_f64(lsa_vars), _f64(batch["mels"]),
                                   _f64(batch["f0"]))
        quant, loss, codes = (np.asarray(a) for a in (quant, loss, codes))
    tlsa = LocalStyleAdaptor(
        cfg["hidden_size"], n_codes=cfg["nRQ"], rq_depth=cfg["rq_depth"],
        mel_bins=cfg["audio_num_mel_bins"],
        wn_layers=cfg.get("style_wn_layers", 4),
        conv_dilations=tuple(cfg.get("style_conv_dilations", (1,) * 5)),
        rq_decay=cfg["rq_decay"], vae_dropout=cfg["vae_dropout"])
    tlsa.load_state_dict(from_jax_params(lsa_vars))
    tlsa.double()
    with torch.no_grad():
        tquant, tloss, tcodes = tlsa(torch.tensor(batch["mels"]).double(),
                                     torch.tensor(batch["f0"]).double())
    np.testing.assert_allclose(to_np(tquant), quant, **TOL)
    np.testing.assert_allclose(to_np(tloss), loss, **TOL)
    np.testing.assert_array_equal(to_np(tcodes), codes)
    # the one-process train step on the global batch
    _, metrics, _, draws, kinds = g.f64
    tcfg = torch_tiny()
    model = StyleSinger(tcfg, VOCAB)
    model.load_state_dict(from_jax_params(g.variables))
    model.double()
    state = tstep.TrainState(model, tstep.Optimizer(
        dict(model.named_parameters()), tcfg))
    tbatch = {k: v.double() if v.is_floating_point() else v for k, v in
              tstep.batch_to_device(batch, "cpu").items()}
    noise = _port_noise(kinds, draws)
    tmetrics = tstep.train_step(state, tbatch, tstep.Phase(*RQ_FORCE), tcfg,
                                noise=noise)
    assert all(not src.draws for src in noise.values())
    check_metrics(metrics, tmetrics)
    check_grads(g.f64[2], state)


def test_two_gloo_ranks_match_jax_on_the_global_batch(tmp_path, global_step):
    g = global_step
    cfg, locals_, variables = g.cfg, g.locals, g.variables
    shapes = [(b["mels"].shape, b["txt_tokens"].shape) for b in locals_]
    assert shapes[0] != shapes[1] and shapes[0][0][0] != shapes[1][0][0]
    state, metrics, grads, draws, kinds = g.f32
    np.savez(tmp_path / "weights.npz", **{
        k: v.numpy() for k, v in from_jax_params(variables).items()})
    np.savez(tmp_path / "draws.npz", **{
        f"{s}_{i}": np.asarray(v) for s, vs in draws.items()
        for i, v in enumerate(vs)})
    for r, b in enumerate(locals_):
        np.savez(tmp_path / f"batch{r}.npz", **b)
    (tmp_path / "meta.json").write_text(json.dumps(
        {"kinds": kinds, "vocab": VOCAB, "phase": list(RQ_FORCE)}))
    outs = _run_ranks([sys.executable, "-c", _WORKER, str(tmp_path)])
    assert all(f"RANK_OK {r}" in out for r, out in enumerate(outs))

    results = [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(2)]
    for k in results[0]:   # both ranks end with equal state
        np.testing.assert_array_equal(results[0][k], results[1][k],
                                      err_msg=k)
    tcfg = torch_tiny()
    port_model = StyleSinger(tcfg, VOCAB)
    port_model.load_state_dict({k[6:]: torch.tensor(v) for k, v in
                                results[0].items() if k.startswith("state/")})
    for name, p in port_model.named_parameters():
        p.grad = torch.tensor(results[0][f"grad/{name}"])
    port = tstep.TrainState(port_model, tstep.Optimizer(
        dict(port_model.named_parameters()), tcfg), step=1)
    check_metrics(metrics, {k[7:]: v for k, v in results[0].items()
                            if k.startswith("metric/")})
    # JAX's own f32-against-f64 gap, element by element: of the gradients
    # and of the RQ buffers after the step
    gap = {k: np.abs(v - g.grads(g.f64)[k])
           for k, v in g.grads(g.f32).items()}
    check_grads(grads, port, slack={k: 2 * v for k, v in gap.items()})
    buffers = [{k: v.numpy() for k, v in from_jax_params(
        {"codebook": _f64(st[0].codebook)}).items()} for st in (g.f32, g.f64)]
    gap.update({k: np.abs(v - buffers[1][k]) for k, v in buffers[0].items()})
    first = {k: v.numpy() for k, v in from_jax_params(variables).items()
             if ".codebook_" not in k}
    check_params_and_buffers(state, port, tstep.make_schedule(tcfg)(0),
                             grads, metrics["grad_norm"], cfg,
                             first_params=first, clear_of=gap)


@pytest.mark.parametrize("world", [2, 3])
def test_epoch_batches_rank_split_matches_jax(world):
    cfg = tiny_test_config(max_tokens=70, max_sentences=2)
    tcfg = torch_tiny(max_tokens=70, max_sentences=2)
    items = synthetic_items(cfg, np.random.default_rng(5), 11)
    jds = JaxDataset(cfg, "train", items=items)
    tds = StyleSingerDataset(tcfg, "train", items=items)
    for rank in range(world):
        ours = EpochBatches(tds, tcfg, rank=rank, world_size=world)
        ref = JaxEpochBatches(jds, cfg, rank=rank, world_size=world)
        for _ in range(2):   # two epochs: the shuffle moves on
            got, want = list(ours), list(ref)
            assert len(got) == len(want) > 0
            for a, b in zip(got, want):
                assert set(a) == set(b)
                for k in b:
                    np.testing.assert_array_equal(np.asarray(a[k]),
                                                  np.asarray(b[k]),
                                                  err_msg=k)


def test_run_train_in_two_gloo_processes(tmp_path):
    """``run.py train`` under torchrun's variables: both ranks take steps,
    rank 0 alone writes the work dir."""
    cfg = tiny(max_updates=2, max_sentences=2)   # 2 batches an epoch
    _write_corpus(tmp_path / "binary", cfg)
    base = load_config()
    overrides = dict({k: v for k, v in cfg.items()
                      if json.dumps(v) != json.dumps(base[k])},
                     binary_data_dir=str(tmp_path / "binary"))
    hparams = ",".join(f"{k}={json.dumps(v) if isinstance(v, (list, tuple)) else v}"
                       for k, v in overrides.items())
    outs = _run_ranks([sys.executable, "-m", "stylesinger_torch.run",
                       "train", "--device", "cpu", "--hparams", hparams,
                       "--exp_name", "dp", "--work_dir_root",
                       str(tmp_path / "ckpts")])
    assert all("trained to step 2" in out for out in outs)
    work = tmp_path / "ckpts" / "dp"
    assert (work / "ckpt" / "model_ckpt_steps_2.pt").exists()
    assert (work / "config.yaml").exists()
    rows = [json.loads(line) for line in
            (work / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows if r["prefix"] == "train"] == [1, 2]
