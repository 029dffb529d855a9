"""The rest of the trainer, the port against the JAX package on the CPU:
``steps_per_dispatch`` (the padded device-resident epoch, its batch
schedule and windows, ``Trainer.fit`` through the scan path), the budget
fallback, the batch prefetcher, ``debug_nans``, ``profile_step``, the
host-RSS watchdog with ``run.py train``'s exit 75 and ``--supervise``, the
validation dump, and the refusal of ``steps_per_dispatch`` > 1 under two
gloo ranks.

The fit test replays JAX's draws into the port step by step: JAX trains
each step of its schedule through ``make_step_body`` (the body its
``make_train_scan`` scans) on the batch ``stacked[order[t]]`` of its own
``_stack_batches``, one compile per curriculum phase (four: JAX's own scan
test's curriculum), and the port's ``Trainer.fit`` takes the draws of step
t from ``noise_fn(t)``, both in f64.  Tolerances are JAX's own scan test's:
each parameter leaf rtol 5e-3 / atol 2e-3 and an aggregate relative
distance under 1e-3; the codebook rtol 5e-3 / atol 5e-4; the logged window
means of the losses rtol 2e-3 / atol 2e-4 (``tests/test_torch_train.py``).
"""

import concurrent.futures
import json
import os
import re
import socket
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylesinger_tpu.config import tiny_test_config as jax_tiny
from stylesinger_tpu.data.batching import collate_batch
from stylesinger_tpu.data.dataset import StyleSingerDataset
from stylesinger_tpu.models.stylesinger import StyleSinger as JaxStyleSinger
from stylesinger_tpu.parallel.mesh import make_mesh
from stylesinger_tpu.training import step as jstep
from stylesinger_tpu.training import trainer as jtr
from test_torch_train import VOCAB, port_noise
from torch_parity import one_torch_thread, random_variables, stash_draws

from stylesinger_torch import run as trun
from stylesinger_torch.config import READ_WITH_GET_TRAINER
from stylesinger_torch.config import tiny_test_config as torch_tiny
from stylesinger_torch.convert import from_jax_params
from stylesinger_torch.models.stylesinger import StyleSinger
from stylesinger_torch.training import step as tstep
from stylesinger_torch.training import trainer as ttr
from stylesinger_torch.utils import meters, plot, profiling

# the fixture, imported above, runs this module on one torch thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parent.parent
# JAX's scan test's curriculum: diffusion on after step 0, forcing off at
# 2, RQ on after 3; log every 2 steps, validate at 6
SCAN_CFG = dict(max_updates=6, val_check_interval=6, tb_log_interval=2,
                valid_infer_interval=10 ** 9, num_ckpt_keep=1, forcing=2,
                rq_start=3, diff_start=0, steps_per_dispatch=4,
                prefetch_batches=0)


def _items(rng, n, frames):
    items = []
    for i in range(n):
        t = int(rng.integers(*frames))
        tt = max(2, t // 4)
        items.append({
            "item_name": f"i{i}",
            "mel": rng.standard_normal((t, 16)).astype(np.float32) * 0.5 - 2,
            "mel2ph": np.repeat(np.arange(1, tt + 1), 4)[:t],
            "f0": np.abs(rng.standard_normal(t)).astype(np.float32) * 100
            + 150,
            "ph_token": rng.integers(1, VOCAB, tt),
            "ep_pitches": rng.integers(40, 80, tt),
            "ep_notedurs": rng.uniform(0.1, 0.6, tt).astype(np.float32),
            "ep_types": np.ones(tt, np.int64),
            "spk_embed": rng.standard_normal(256).astype(np.float32),
            "emo_embed": rng.standard_normal(256).astype(np.float32)})
    return items


def epoch_batches(cfg, seed=11):
    """Three collated batches of different sentence counts, frame buckets
    (32, 64) and token buckets (8, 16)."""
    rng = np.random.default_rng(seed)
    out = []
    for n, frames in ((4, (16, 30)), (2, (36, 60)), (1, (16, 30))):
        ds = StyleSingerDataset(cfg, "train", items=_items(rng, n, frames))
        b = collate_batch([ds[i] for i in range(n)], cfg["frame_buckets"],
                          cfg["token_buckets"])
        out.append({k: v for k, v in b.items() if k != "nsamples"})
    return out


def jax_trainer(cfg):
    """A JAX ``Trainer`` for its dispatch methods alone, on a one-device
    mesh (the port's one process)."""
    t = jtr.Trainer.__new__(jtr.Trainer)
    t.cfg, t.model, t.rng = cfg, None, None
    t.mesh = make_mesh(devices=jax.devices()[:1])
    return t


def port_trainer(cfg, work_dir, **kw):
    return ttr.Trainer(StyleSinger(cfg, VOCAB), cfg, str(work_dir),
                       device="cpu", **kw)


# ---------------------------------------------------------- schedule

WINDOW_CASES = {  # (tb_log_interval, val_check_interval, curriculum, spd)
    "jax_scan_test": (2, 6, dict(forcing=2, rq_start=3, diff_start=0), 4),
    "long_windows": (50, 100, dict(forcing=30, rq_start=60, diff_start=45),
                     16),
    "odd_intervals": (3, 7, dict(forcing=5, rq_start=2, diff_start=11), 5),
    "spd_one": (4, 8, dict(forcing=3, rq_start=3, diff_start=3), 1),
}


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_window_len_equals_jax(case):
    log, val, curriculum, spd = WINDOW_CASES[case]
    kw = dict(curriculum, tb_log_interval=log, val_check_interval=val,
              steps_per_dispatch=spd)
    ours = types.SimpleNamespace(cfg=torch_tiny(**kw))
    theirs = types.SimpleNamespace(cfg=jax_tiny(**kw))
    for max_updates in (7, 120):
        for step in range(max_updates):
            assert ttr.Trainer._window_len(ours, step, max_updates) == \
                jtr.Trainer._window_len(theirs, step, max_updates), \
                (step, max_updates)


@pytest.mark.parametrize("start", [0, 7])
@pytest.mark.parametrize("case", ["jax_scan_test", "odd_intervals"])
def test_schedule_equals_jax(monkeypatch, case, start):
    """The windows, their phases and batch orders of JAX's
    ``_train_loop_scan`` (its step program stubbed) and the port's, over
    40 steps of a 3-batch epoch, from step 0 and resumed at step 7."""
    log, val, curriculum, spd = WINDOW_CASES[case]
    kw = dict(curriculum, tb_log_interval=log, val_check_interval=val,
              steps_per_dispatch=spd, seed=5)
    jax_windows, port_windows = [], []

    def jax_scan(model, cfg):
        def run(state, stacked, order, rng, phase):
            jax_windows.append((np.asarray(order).tolist(), tuple(phase)))
            return state, {}
        return run

    def port_scan(state, stacked, order, phase):
        port_windows.append((list(order), tuple(phase)))
        state.step += len(order)
        return {}

    monkeypatch.setattr(jtr, "make_train_scan", jax_scan)
    jt = jax_trainer(jax_tiny(**kw))
    jt._log_val_save = lambda step, state, phase, w, t0, *a: t0
    jt._train_loop_scan((None, 3), None, start, 40, None, {}, 0.0)
    pt = ttr.Trainer.__new__(ttr.Trainer)
    pt.cfg, pt.scan, pt._stop = torch_tiny(**kw), port_scan, False
    pt._log_val_save = lambda state, phase, w, t0, *a: t0
    pt._train_loop_scan((None, 3), types.SimpleNamespace(step=start), 40,
                        None)
    assert port_windows == jax_windows
    assert sum(len(o) for o, _ in port_windows) == 40 - start


def test_batch_index_is_the_seeded_epoch_permutation():
    cache = {}
    got = [ttr.batch_index(t, 5, 9, cache) for t in range(15)]
    want = np.concatenate([np.random.default_rng(9 + e).permutation(5)
                           for e in range(3)])
    assert got == want.tolist()


def test_stacked_epoch_equals_jax(tmp_path):
    """Field for field, shape and values, on batches of different sentence
    counts, frame and token lengths: padded with zeros to the epoch's
    largest size in each dimension."""
    jcfg = jax_tiny(**SCAN_CFG)
    batches = epoch_batches(jcfg)
    shapes = {tuple(b["mels"].shape) for b in batches}
    assert len(shapes) == 3 and len({b["txt_tokens"].shape[1]
                                     for b in batches}) == 2
    want, n_b = jax_trainer(jcfg)._stack_batches(batches)
    got, n_p = port_trainer(torch_tiny(**SCAN_CFG), tmp_path)._stack_batches(
        batches)
    assert n_b == n_p == 3 and set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)
    assert not got["mel2ph"][1, 2:].any()  # the padded sentences


def test_budget_fallback_streams_per_step(tmp_path, capsys):
    cfg = torch_tiny(**dict(SCAN_CFG, max_updates=2, tb_log_interval=1,
                            val_check_interval=2,
                            device_data_budget_mb=0.0001))
    state = port_trainer(cfg, tmp_path).fit(epoch_batches(cfg)[:1])
    assert state.step == 2
    assert "streaming per-step" in capsys.readouterr().out


# ------------------------------------------------------- fit vs JAX

def _f64(tree):
    return jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float64)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


@pytest.fixture(scope="module")
def jax_run():
    """JAX's schedule over its own padded epoch, 6 steps of
    ``make_step_body`` on ``stacked[order[t]]`` with each step's draws
    recorded, from seeded weights, in f64."""
    jcfg = jax_tiny(**SCAN_CFG)
    batches = epoch_batches(jcfg)
    jt = jax_trainer(jcfg)
    model = JaxStyleSinger(jcfg, VOCAB)
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(
        ("params",) + jstep._RNG_STREAMS)}
    stacked, n_b = jt._stack_batches(batches)
    variables = random_variables(
        model.init, rngs, **jstep._model_inputs(
            {k: v[0] for k, v in stacked.items()}), infer=False,
        use_rq=True, forcing=False, use_diff=True, seed=3)
    with jax.enable_x64(True):
        return _jax_steps(jcfg, jt, model, batches, variables)


def _jax_steps(jcfg, jt, model, batches, variables):
    stacked, n_b = jt._stack_batches(batches)
    stacked = _f64(stacked)
    body = jstep.make_step_body(model, jcfg)
    rng = jax.random.PRNGKey(jcfg["seed"])
    kinds = {}

    def f(state, batch, phase):
        draws = {}
        with stash_draws(draws):
            state, metrics = body(state, batch, rng, phase)
        kinds[phase] = {k: [kind for kind, _ in v] for k, v in draws.items()}
        return state, metrics, {k: [value for _, value in v]
                                for k, v in draws.items()}

    state = jstep.TrainState.create(_f64(variables["params"]),
                                    _f64(variables["codebook"]),
                                    jstep.make_optimizer(jcfg))
    b0 = {k: v[0] for k, v in stacked.items()}
    phases = sorted({jstep.phase_for_step(s, jcfg)
                     for s in range(jcfg["max_updates"])})
    # traced one after another (stash_draws patches jax.random), compiled
    # side by side
    lowered = [jax.jit(f, static_argnums=2).lower(state, b0, p)
               for p in phases]
    with concurrent.futures.ThreadPoolExecutor(len(phases)) as pool:
        step_fns = dict(zip(phases, pool.map(lambda lo: lo.compile(),
                                             lowered)))
    order, windows, cache, t = [], [], {}, 0
    while t < jcfg["max_updates"]:
        w = jt._window_len(t, jcfg["max_updates"])
        windows.append(w)
        for s in range(t, t + w):  # JAX's batch_index
            epoch = s // n_b
            if epoch not in cache:
                cache[epoch] = np.random.default_rng(
                    jcfg["seed"] + epoch).permutation(n_b)
            order.append(int(cache[epoch][s % n_b]))
        t += w
    metrics, draws = [], []
    for s, j in enumerate(order):
        phase = jstep.phase_for_step(s, jcfg)
        state, m, d = step_fns[phase](state, {k: v[j] for k, v in
                                              stacked.items()})
        metrics.append({k: float(v) for k, v in m.items()})
        draws.append((kinds[phase], d))
    return dict(batches=batches, variables=variables, state=state,
                metrics=metrics, draws=draws, order=order, windows=windows)


def test_fit_with_steps_per_dispatch_matches_jax(jax_run, tmp_path,
                                                 monkeypatch):
    """``Trainer.fit`` with ``steps_per_dispatch=4`` over 6 steps of JAX's
    scan test's curriculum (windows of 1, 1, 2, 2 steps), on a padded epoch
    of three batches of different shapes, JAX's draws replayed: the
    parameters, the codebook and the logged window means as JAX's.  Both
    sides in f64 (the port's epoch put on the device in f64): in f32, Adam
    at this curriculum's learning rate (up to 0.056) turns the two
    implementations' rounding of a gradient that crosses 0 into a share
    of a step (one element of 12k moved 0.004 apart)."""
    assert jax_run["windows"] == [1, 1, 2, 2]
    assert len(set(jax_run["order"])) == 3
    cfg = torch_tiny(**SCAN_CFG)
    model = StyleSinger(cfg, VOCAB)
    model.load_state_dict(from_jax_params(jax_run["variables"]))
    model.double()
    monkeypatch.setattr(ttr, "batch_to_device", lambda b, d: {
        k: v.double() if v.is_floating_point() else v
        for k, v in tstep.batch_to_device(b, d).items()})

    def noise_fn(step):
        kinds, draws = jax_run["draws"][step]
        return port_noise(kinds, draws, True)

    trainer = port_trainer(cfg, tmp_path, noise_fn=noise_fn)
    trainer.model = model
    trainer.init_state = lambda: tstep.TrainState(
        model, tstep.Optimizer(dict(model.named_parameters()), cfg))
    state = trainer.fit(jax_run["batches"])
    assert state.step == 6 and state.opt.count == 6

    st = jax_run["state"]
    want = {k: v.numpy() for k, v in from_jax_params(
        {"params": st.params}).items()}
    got = {k: p.detach().numpy() for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=5e-3, atol=2e-3,
                                   err_msg=k)
    num = sum(float(np.sum((got[k] - w) ** 2)) for k, w in want.items())
    den = sum(float(np.sum(w ** 2)) for w in want.values())
    assert (num / den) ** 0.5 < 1e-3, (num, den)
    cb = {k: v.numpy() for k, v in from_jax_params(
        {"params": {}, "codebook": st.codebook}).items()}
    sd = model.state_dict()
    for k, w in cb.items():
        np.testing.assert_allclose(sd[k].numpy(), w, rtol=5e-3, atol=5e-4,
                                   err_msg=k)

    rows = [json.loads(line) for line in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in rows if r["prefix"] == "train"]
    assert [r["step"] for r in train] == [2, 4, 6]
    for r in train:
        window = jax_run["metrics"][r["step"] - 2:r["step"]]
        keys = set(window[-1])
        assert keys <= set(r), keys - set(r)
        for k in keys:
            mean = np.mean([m[k] for m in window if k in m])
            np.testing.assert_allclose(r[k], mean, rtol=2e-3, atol=2e-4,
                                       err_msg=(r["step"], k))
        assert r["host_rss_gb"] > 0


# ---------------------------------------------------- the rest

def test_prefetcher_gives_the_same_batches_in_order():
    cfg = torch_tiny()
    batches = epoch_batches(cfg)
    plain = ttr._BatchStream(batches, torch.device("cpu"))
    ahead = ttr.BatchPrefetcher(batches, torch.device("cpu"), depth=2)
    try:
        for _ in range(7):  # two epochs and a third begun
            a, b = plain.next(), ahead.next()
            assert set(a) == set(b)
            for k in a:
                assert torch.equal(a[k], b[k]), k
    finally:
        ahead.close()
    empty = ttr.BatchPrefetcher([], torch.device("cpu"), depth=2)
    with pytest.raises(ValueError, match="an epoch gives no batch"):
        empty.next()
    empty.close()


@pytest.mark.parametrize("spd", [1, 2])
def test_debug_nans_raises_at_the_first_non_finite_value(tmp_path, spd):
    cfg = torch_tiny(**dict(SCAN_CFG, max_updates=2, steps_per_dispatch=spd,
                            debug_nans=True))
    batch = dict(epoch_batches(cfg)[0])
    batch["mels"] = batch["mels"].copy()
    batch["mels"][0, 3, 5] = np.nan
    with pytest.raises(FloatingPointError, match="debug_nans"):
        port_trainer(cfg, tmp_path).fit([batch])


def test_profile_step_prints_jax_table(tmp_path, capsys):
    """``profile_step`` 0 with ``profile_n_steps`` 1 traces steps 0 and 1
    (JAX's window) into ``<work_dir>/profile`` and prints the per-op table
    as JAX's ``format_table`` prints the same rows."""
    from stylesinger_tpu.utils.profiling import format_table as jax_table

    cfg = torch_tiny(**dict(SCAN_CFG, max_updates=2, profile_step=0,
                            profile_n_steps=1))
    port_trainer(cfg, tmp_path).fit(epoch_batches(cfg)[:1])
    out = capsys.readouterr().out
    trace = profiling.latest_trace(str(tmp_path / "profile"))
    assert trace is not None
    rows = profiling.parse_trace(trace)
    for r in rows:
        r["per_iter_us"] = r["total_us"] / 1
    table = profiling.format_table(rows, top=15)
    assert table == jax_table(rows, top=15)
    assert table in out
    assert re.search(r"^\s+\d+\.\d{3} ms  x\s*\d+  \[\s*cpu_op\]  aten::",
                     table, re.M)


def test_watchdog_checkpoints_and_raises(tmp_path):
    cfg = torch_tiny(**dict(SCAN_CFG, max_updates=3, tb_log_interval=1,
                            max_host_rss_gb=0.001))
    trainer = port_trainer(cfg, tmp_path)
    with pytest.raises(ttr.HostMemoryExceeded, match="exceeded"):
        trainer.fit(epoch_batches(cfg))
    assert trainer.state.step == 1 and trainer.ckpt.all_steps() == [1]


@pytest.mark.parametrize("value", [-1.0, 0.0, 2.5])
def test_rss_limit_as_jax_resolves_it_on_a_local_backend(value):
    assert ttr.resolve_rss_limit_gb(value) == jtr.resolve_rss_limit_gb(value)


def test_run_train_exits_75_on_the_watchdog(tmp_path):
    from test_torch_trainer import _write_corpus

    from stylesinger_torch.config import load_config

    cfg = torch_tiny(max_updates=2, tb_log_interval=1, val_check_interval=2,
                     forcing=1, rq_start=0, diff_start=0,
                     max_host_rss_gb=0.001, prefetch_batches=0)
    _write_corpus(tmp_path / "binary", cfg)
    base = load_config()
    overrides = dict({k: v for k, v in cfg.items()
                      if json.dumps(v) != json.dumps(base.get(k))},
                     binary_data_dir=str(tmp_path / "binary"))
    hparams = ",".join(
        f"{k}={json.dumps(v) if isinstance(v, (list, tuple)) else v}"
        for k, v in overrides.items())
    code = trun.main(["train", "--device", "cpu", "--hparams", hparams,
                      "--exp_name", "rss", "--work_dir_root",
                      str(tmp_path / "ckpts")])
    assert code == trun.RESTART_EXIT_CODE == 75
    assert (tmp_path / "ckpts" / "rss" / "ckpt" /
            "model_ckpt_steps_1.pt").exists()


def test_supervise_restarts_on_75_and_stops_on_0(tmp_path, capsys):
    counter = tmp_path / "runs"
    script = ("import pathlib, sys; p = pathlib.Path(sys.argv[1]); "
              "n = int(p.read_text()) + 1 if p.exists() else 1; "
              "p.write_text(str(n)); sys.exit(75 if n < 3 else 0)")
    assert trun.supervise([sys.executable, "-c", script, str(counter)]) == 0
    assert counter.read_text() == "3"
    assert capsys.readouterr().out.count("supervise: restart") == 2
    failing = [sys.executable, "-c", "import sys; sys.exit(3)"]
    assert trun.supervise(failing) == 3


class _Vocoder:
    def spec2wav(self, mel, f0=None):
        return 0.1 * np.sin(np.arange(len(mel) * 64) / 5.0)


@pytest.mark.parametrize("imageio", ["present", "absent"])
def test_valid_dump_writes_jax_file_set(tmp_path, monkeypatch, imageio):
    """The first validation item's inference as ``mel_<step>.png`` (or
    ``.npy`` without imageio) and, with a vocoder, ``wav_<step>.wav``, as
    JAX's ``_dump_valid_artifacts`` names them (the duration head set to
    ~4 frames a phone: random weights predict none)."""
    if imageio == "absent":
        monkeypatch.setitem(sys.modules, "imageio", None)
    cfg = torch_tiny(**SCAN_CFG)
    trainer = port_trainer(cfg, tmp_path, vocoder=_Vocoder())
    state = trainer.init_state()
    head = state.model.dur_predictor.out
    with torch.no_grad():
        head.weight.mul_(0.1)
        head.bias.fill_(float(np.log(5.0)))
    batch = tstep.batch_to_device(epoch_batches(cfg)[0], "cpu")
    trainer._dump_valid_artifacts(state, batch, 7)
    mel = "mel_7.png" if imageio == "present" else "mel_7.npy"
    assert sorted(os.listdir(tmp_path / "valid_plots")) == sorted(
        [mel, "wav_7.wav"])


def test_a_failed_plot_is_printed_and_training_goes_on(tmp_path, capsys,
                                                       monkeypatch):
    """``validate`` dumps at the ``valid_infer_interval`` cadence; a
    failure there is printed and training goes on."""
    def broken(*a, **k):
        raise ImportError("no matplotlib")

    monkeypatch.setattr(plot, "spec_to_figure", broken)
    cfg = torch_tiny(**dict(SCAN_CFG, max_updates=2, val_check_interval=2,
                            valid_infer_interval=2, steps_per_dispatch=1))
    batches = epoch_batches(cfg)[:1]
    state = port_trainer(cfg, tmp_path).fit(batches, lambda: batches)
    assert state.step == 2
    assert "valid plot failed: no matplotlib" in capsys.readouterr().out


def test_plots_and_meters_equal_jax():
    from stylesinger_tpu.utils import meters as jmeters
    from stylesinger_tpu.utils import plot as jplot

    spec = np.random.default_rng(0).standard_normal((20, 16))
    np.testing.assert_array_equal(
        plot.figure_to_image(plot.spec_to_figure(spec, title="t")),
        jplot.figure_to_image(jplot.spec_to_figure(spec, title="t")))
    f0 = np.linspace(100, 300, 40)
    np.testing.assert_array_equal(
        plot.figure_to_image(plot.f0_to_figure(f0, f0_pred=f0[::-1])),
        jplot.figure_to_image(jplot.f0_to_figure(f0, f0_pred=f0[::-1])))
    ours, theirs = meters.AvgMeter(), jmeters.AvgMeter()
    for v, n in ((1.0, 2), (4.0, 1), (0.5, 3)):
        ours.update(v, n)
        theirs.update(v, n)
    assert (ours.avg, ours.cnt) == (theirs.avg, theirs.cnt)
    with meters.Timer("x"):
        pass
    assert meters.Timer.timer_map["x"] >= 0


def test_trainer_get_keys_are_jax_trainers():
    """``READ_WITH_GET_TRAINER``: the keys and defaults JAX's trainer
    reads with ``c.get``."""
    import inspect

    src = inspect.getsource(jtr)
    for key, default in READ_WITH_GET_TRAINER.items():
        assert f'c.get("{key}", {default!r})' in src, key
    assert 'c.get("prefetch_batches", default_prefetch)' in src


_RANK = r"""
import numpy as np
from stylesinger_torch.config import tiny_test_config
from stylesinger_torch.models.stylesinger import StyleSinger
from stylesinger_torch.parallel import mesh
from stylesinger_torch.training.trainer import Trainer
mesh.init_distributed("cpu")
cfg = tiny_test_config(**{cfg!r})
batch = dict(np.load({work!r} + str(mesh.rank()) + ".npz"))
trainer = Trainer(StyleSinger(cfg, 20), cfg, {work!r} + str(mesh.rank()),
                  device="cpu")
try:
    trainer.fit([batch])
except ValueError as e:
    print("REFUSED", e)
"""


def test_two_gloo_ranks_refuse_steps_per_dispatch(tmp_path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    work = str(tmp_path / "w")
    cfg = dict(SCAN_CFG, steps_per_dispatch=2)
    for r, b in enumerate(epoch_batches(torch_tiny(**cfg))[:2]):
        np.savez(work + str(r) + ".npz", **b)
    code = _RANK.format(cfg=cfg, work=work)
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, RANK=str(r), WORLD_SIZE="2",
                 MASTER_ADDR="localhost", MASTER_PORT=str(port),
                 PYTHONPATH=str(REPO), OMP_NUM_THREADS="1"))
        for r in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert "REFUSED steps_per_dispatch > 1 under a process group" in out
