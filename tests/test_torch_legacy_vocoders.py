"""The Parallel WaveGAN and MelGAN vocoders and the PQMF filter bank of the
port against the JAX package on the CPU, with their converters, checkpoint
loaders and wrappers.

PWG at 6 layers / 3 stacks / 8 residual channels (``tests/
test_convert.py``'s size) with upsample scales 4 x 4, MelGAN at 32 base
channels with rates 4 x 2, 16 mel bins.  Same seeded weights
(``random_variables`` -> ``from_jax_params``), the same mel and the same
noise on both sides (JAX's draw of the wrapper is captured and passed to
the port).  Reference-layout state dicts are written from the flax
weights by inverting JAX's converter rules (``tests/torch_parity.py``
``reference_pwg_sd`` / ``reference_melgan_sd``), weight-normed or folded,
as an official ParallelWaveGAN checkpoint (``checkpoint-<N>steps.pkl`` with
``stats.npy`` / ``stats.h5`` and ``config.yaml``) or a reference task
checkpoint (``model_ckpt_steps_<N>.ckpt``).

Tolerances: outputs atol 2e-4 / rtol 2e-3 (``tests/test_convert.py``);
converted trees, stats and generator hyperparameters exactly equal.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stylesinger_tpu.convert as jcv
import stylesinger_tpu.vocoder_infer as jvi
from stylesinger_tpu.config import tiny_test_config
from stylesinger_tpu.models import legacy_vocoders as jlv
from torch_parity import (
    one_torch_thread, random_variables, reference_melgan_sd,
    reference_pwg_sd, stash_draws, to_np,
)

import stylesinger_torch.convert as tcv
import stylesinger_torch.vocoder_infer as tvi
from stylesinger_torch.config import tiny_test_config as torch_tiny
from stylesinger_torch.convert import from_jax_params
from stylesinger_torch.models import legacy_vocoders as tlv

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = dict(atol=2e-4, rtol=2e-3)
PWG_KW = dict(layers=6, stacks=3, residual_channels=8, gate_channels=16,
              skip_channels=8)
PWG_CFG = dict(pwg_upsample_scales=[4, 4], hop_size=16)
MELGAN_CFG = dict(melgan_upsample_scales=[4, 2], hop_size=8)
T = 12
# an official ParallelWaveGAN config.yml: the generator's keys, and others
# the loader passes over
OFFICIAL_YAML = """\
# This is the hyperparameter configuration file for Parallel WaveGAN.
sampling_rate: 24000     # Sampling rate.
fft_size: 2048
hop_size: 16
format: "hdf5"           # Feature file format.
generator_params:
    in_channels: 1        # Number of input channels.
    out_channels: 1
    kernel_size: 3
    layers: 6             # Number of residual block layers.
    stacks: 3             # Number of stacks i.e., dilation cycles.
    residual_channels: 8
    gate_channels: 16
    skip_channels: 8
    aux_channels: 16
    aux_context_window: 2
    dropout: 0.0
    use_weight_norm: true
    upsample_net: "ConvInUpsampleNetwork"
    upsample_params:
        upsample_scales: [4, 4]
discriminator_params:
    layers: 10
    nonlinear_activation_params:
        negative_slope: 0.2
lambda_adv: 4.0
generator_optimizer_params:
    lr: 0.0001
    eps: 1.0e-6
"""


def _mel(seed, t=T, m=16):
    return np.random.default_rng(seed).standard_normal(
        (t, m)).astype(np.float32)


def _params_equal(a, b):
    fa, fb = (jax.tree_util.tree_flatten_with_path(x)[0] for x in (a, b))
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=str(path))


@pytest.fixture(scope="module")
def pwg():
    """JAX PWG generators (with and without a pitch embedding) and their
    seeded variables."""
    cfg = tiny_test_config(**PWG_CFG)
    out = {}
    for pitch in (False, True):
        model = jlv.ParallelWaveGANGenerator(cfg, use_pitch_embed=pitch,
                                             **PWG_KW)
        args = (jnp.zeros((1, T, 16)), jnp.zeros((1, T * 16, 1)))
        v = random_variables(
            model.init, jax.random.PRNGKey(0), *args,
            pitch=jnp.ones((1, T), jnp.int32) if pitch else None,
            seed=3 + pitch, gain=0.5)
        out[pitch] = (model, v)
    return cfg, out


@pytest.fixture(scope="module")
def melgan():
    cfg = tiny_test_config(**MELGAN_CFG)
    model = jlv.MelGANGenerator(cfg, base_channels=32)
    v = random_variables(model.init, jax.random.PRNGKey(0),
                         jnp.zeros((1, T, 16)), seed=7, gain=0.5)
    return cfg, model, v


def test_pqmf_analysis_and_synthesis_match_jax():
    wav = np.random.default_rng(1).standard_normal((2, 400)).astype(
        np.float32)
    jp, tp = jlv.PQMF(), tlv.PQMF()
    sub = jp.analysis(jnp.asarray(wav))
    tsub = tp.analysis(torch.as_tensor(wav))
    assert tsub.shape == sub.shape == (2, 100, 4)
    np.testing.assert_allclose(to_np(tsub), np.asarray(sub), **TOL)
    back = jp.synthesis(sub)
    tback = tp.synthesis(tsub)
    assert tback.shape == back.shape == (2, 400)
    np.testing.assert_allclose(to_np(tback), np.asarray(back), **TOL)
    # near-perfect reconstruction away from the edges
    np.testing.assert_allclose(to_np(tback)[:, 100:300], wav[:, 100:300],
                               atol=0.05)


@pytest.mark.parametrize("pitch", [False, True], ids=["plain", "pitch"])
def test_pwg_generator_matches_jax(pwg, pitch):
    cfg, models = pwg
    model, v = models[pitch]
    rng = np.random.default_rng(11)
    mel = rng.standard_normal((2, T, 16)).astype(np.float32)
    noise = rng.standard_normal((2, T * 16, 1)).astype(np.float32)
    coarse = rng.integers(1, 256, (2, T)) if pitch else None
    ref = model.apply(v, jnp.asarray(mel), jnp.asarray(noise),
                      pitch=None if coarse is None else jnp.asarray(coarse))
    port = tlv.ParallelWaveGANGenerator(torch_tiny(**PWG_CFG),
                                        use_pitch_embed=pitch, **PWG_KW)
    port.load_state_dict(from_jax_params(v))
    with torch.no_grad():
        ours = port(torch.as_tensor(mel), torch.as_tensor(noise),
                    None if coarse is None else torch.as_tensor(coarse))
    assert ours.shape == ref.shape == (2, T * 16)
    np.testing.assert_allclose(to_np(ours), np.asarray(ref), **TOL)


def test_melgan_generator_matches_jax(melgan):
    cfg, model, v = melgan
    mel = np.random.default_rng(12).standard_normal((2, T, 16)).astype(
        np.float32)
    ref = jax.jit(model.apply)(v, jnp.asarray(mel))
    port = tlv.MelGANGenerator(torch_tiny(**MELGAN_CFG), base_channels=32)
    port.load_state_dict(from_jax_params(v))
    with torch.no_grad():
        ours = port(torch.as_tensor(mel))
    assert ours.shape == ref.shape == (2, T * 8)
    np.testing.assert_allclose(to_np(ours), np.asarray(ref), **TOL)


@pytest.mark.parametrize("weight_norm", [True, False],
                         ids=["weight_norm", "folded"])
def test_converters_give_jaxs_trees(pwg, melgan, weight_norm):
    """``convert_pwg`` / ``convert_melgan`` of the reference layout: the
    port's tree is JAX's exactly, and JAX's is the generator's init tree
    (up to the weight norm's rounding)."""
    _, models = pwg
    for pitch in (False, True):
        v = models[pitch][1]
        sd = reference_pwg_sd(v, weight_norm)
        ref = jcv.convert_pwg(sd, layers=6, n_scales=2)
        _params_equal(tcv.convert_pwg(sd, layers=6, n_scales=2), ref)
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-5,
                                                    atol=1e-6), ref, v)
    v = melgan[2]
    sd = reference_melgan_sd(v, weight_norm)
    ref = jcv.convert_melgan(sd, n_scales=2)
    _params_equal(tcv.convert_melgan(sd, n_scales=2), ref)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6),
        ref, v)


def _official_dir(tmp, sd, stats_kind="npy", yaml=OFFICIAL_YAML):
    os.makedirs(tmp, exist_ok=True)
    torch.save({"model": {"generator": sd}, "steps": 400},
               os.path.join(tmp, "checkpoint-400steps.pkl"))
    torch.save({"model": {"generator": {}}},
               os.path.join(tmp, "checkpoint-100steps.pkl"))
    rng = np.random.default_rng(2)
    mean = rng.standard_normal(16).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, 16).astype(np.float32)
    if stats_kind == "npy":
        np.save(os.path.join(tmp, "stats.npy"), np.stack([mean, scale]))
    else:
        import h5py
        with h5py.File(os.path.join(tmp, "stats.h5"), "w") as f:
            f["mean"], f["scale"] = mean, scale
    if yaml is not None:
        with open(os.path.join(tmp, "config.yaml"), "w") as f:
            f.write(yaml)
    return str(tmp)


def _custom_dir(tmp, sd):
    os.makedirs(tmp, exist_ok=True)
    for step, payload in ((50, {}), (100, sd)):
        torch.save({"state_dict": {f"model_gen.{k}": v
                                   for k, v in payload.items()}},
                   os.path.join(tmp, f"model_ckpt_steps_{step}.ckpt"))
    return str(tmp)


@pytest.mark.parametrize("stats", ["npy", "h5"])
def test_load_pwg_checkpoint_official_matches_jax(pwg, tmp_path, stats):
    """The official layout with its feature stats and config.yaml (read by
    the port's own YAML reader, by PyYAML in JAX)."""
    v = pwg[1][False][1]
    d = _official_dir(tmp_path, reference_pwg_sd(v), stats)
    ckpt, stats_p, cfg_p = tvi._find_legacy_ckpt(d)
    assert ckpt.endswith("checkpoint-400steps.pkl")
    for base in (d, ckpt, os.path.join(d, "missing"), ""):
        assert tvi._find_legacy_ckpt(base) == jvi._find_legacy_ckpt(base)
    ref = jcv.load_pwg_checkpoint(ckpt, stats_p, cfg_p)
    ours = tcv.load_pwg_checkpoint(ckpt, stats_p, cfg_p)
    _params_equal(ours[0], ref[0])
    assert set(ours[1]) == set(ref[1]) == {"mean", "scale"}
    for k in ref[1]:
        np.testing.assert_array_equal(ours[1][k], ref[1][k])
    assert ours[2] == ref[2]
    assert ours[2]["stacks"] == 3 and ours[2]["upsample_params"] == {
        "upsample_scales": [4, 4], "aux_context_window": 2}


def test_hdf5_stats_without_h5py_raise_naming_the_file(pwg, tmp_path,
                                                        monkeypatch):
    d = _official_dir(tmp_path, reference_pwg_sd(pwg[1][False][1]), "h5")
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="stats.h5"):
        tcv.load_pwg_checkpoint(*tvi._find_legacy_ckpt(d))


def test_load_checkpoints_custom_layout_match_jax(pwg, melgan, tmp_path):
    """Reference task checkpoints (``model_gen.*``, no stats, no yaml): the
    generator's shape read from the weights, the latest step first."""
    for name, sd, jload, tload in (
            ("pwg", reference_pwg_sd(pwg[1][True][1], False),
             jcv.load_pwg_checkpoint, tcv.load_pwg_checkpoint),
            ("melgan", reference_melgan_sd(melgan[2]),
             jcv.load_melgan_checkpoint, tcv.load_melgan_checkpoint)):
        d = _custom_dir(tmp_path / name, sd)
        ckpt, stats_p, _ = tvi._find_legacy_ckpt(d)
        assert ckpt.endswith("model_ckpt_steps_100.ckpt") and stats_p is None
        ref, ours = jload(ckpt, stats_p), tload(ckpt, stats_p)
        _params_equal(ours[0], ref[0])
        assert ours[1] is None and ref[1] is None
        assert ours[2] == ref[2]
    assert ours[2] == {"base_channels": 32, "upsample_scales": [4, 2]}
    with pytest.raises(ValueError, match="not a recognized"):
        tcv._generator_sd({"x": 1}, "bad.ckpt")


def test_get_vocoder_cls_returns_the_legacy_wrappers():
    assert tvi.get_vocoder_cls(torch_tiny(vocoder="PWG")) is tvi.PWG
    assert tvi.get_vocoder_cls(torch_tiny(vocoder="MelGAN")) is tvi.MelGAN
    assert not hasattr(tvi, "UNPORTED_VOCODERS")


def _jax_pwg_noise(wrapper, c, pitch):
    """The noise JAX's PWG wrapper draws (its fixed key), captured from an
    eager run of its generator."""
    draws = []
    with stash_draws(draws):
        wrapper.model.apply({"params": wrapper.params}, jnp.asarray(c)[None],
                            pitch=pitch, rngs={"noise": wrapper._rng})
    assert [k for k, _ in draws] == ["n"]
    return torch.tensor(np.asarray(draws[0][1]))


def test_pwg_wrapper_on_official_files_matches_jax(pwg, tmp_path, capsys):
    d = _official_dir(tmp_path, reference_pwg_sd(pwg[1][False][1]))
    cfg = tiny_test_config(vocoder="PWG", vocoder_ckpt=d, hop_size=16)
    jw = jvi.PWG(cfg)
    tw = tvi.get_vocoder_cls(cfg)(torch_tiny(vocoder="PWG", vocoder_ckpt=d,
                                             hop_size=16), device="cpu")
    out = capsys.readouterr().out
    assert "Loaded PWG vocoder" in out and "feature stats" in out
    assert "WARN" not in out
    mel = _mel(3)
    ref = jw.spec2wav(mel)
    noise = _jax_pwg_noise(jw, (mel - jw.stats["mean"]) / jw.stats["scale"],
                           None)
    ours = tw.spec2wav(mel, noise=noise)
    assert ours.shape == ref.shape == (T * 16,)
    np.testing.assert_allclose(ours, ref, **TOL)


def test_pwg_wrapper_with_pitch_on_a_task_checkpoint(pwg, tmp_path, capsys):
    """A reference task checkpoint with a pitch embedding and no
    config.yaml: the coarse pitch of f0 enters, and both wrappers warn that
    ``stacks`` is assumed."""
    d = _custom_dir(tmp_path, reference_pwg_sd(pwg[1][True][1]))
    kw = dict(vocoder="PWG", vocoder_ckpt=d, hop_size=16)
    jw = jvi.PWG(tiny_test_config(**kw))
    tw = tvi.PWG(torch_tiny(**kw), device="cpu")
    out = capsys.readouterr().out
    assert out.count("'stacks' not in config.yaml") == 2
    assert tw.model.use_pitch_embed and tw.stats is None
    mel = _mel(4)
    f0 = np.random.default_rng(5).uniform(100, 400, T).astype(np.float32)
    f0[::4] = 0.0
    ref = jw.spec2wav(mel, f0=f0)
    from stylesinger_tpu.dsp.pitch import f0_to_coarse
    noise = _jax_pwg_noise(jw, mel, f0_to_coarse(jnp.asarray(f0))[None])
    np.testing.assert_allclose(tw.spec2wav(mel, f0=f0, noise=noise), ref,
                               **TOL)


def test_melgan_wrapper_on_official_files_matches_jax(melgan, tmp_path,
                                                      capsys):
    d = _official_dir(tmp_path, reference_melgan_sd(melgan[2]), yaml=None)
    kw = dict(vocoder="MelGAN", vocoder_ckpt=d, hop_size=8)
    jw = jvi.MelGAN(tiny_test_config(**kw))
    tw = tvi.get_vocoder_cls(torch_tiny(**kw))(torch_tiny(**kw),
                                               device="cpu")
    assert "WARN" not in capsys.readouterr().out
    assert tw.cfg["melgan_upsample_scales"] == [4, 2]
    mel = _mel(6)
    np.testing.assert_allclose(tw.spec2wav(mel), jw.spec2wav(mel), **TOL)


def test_legacy_wrappers_warn_as_jax_does(tmp_path, capsys):
    """A ``vocoder_ckpt`` that holds no checkpoint: random weights with
    JAX's warning; a hop size the upsampling does not give: JAX's
    warning."""
    for name in ("PWG", "MelGAN"):
        kw = dict(vocoder=name, vocoder_ckpt=str(tmp_path), hop_size=999,
                  pwg_upsample_scales=[4, 4], melgan_upsample_scales=[2],
                  **{f"pwg_{k}": v for k, v in PWG_KW.items()})
        getattr(jvi, name)(tiny_test_config(**kw))
        jax_out = capsys.readouterr().out
        getattr(tvi, name)(torch_tiny(**kw), device="cpu")
        assert capsys.readouterr().out == jax_out
        assert "using random weights" in jax_out and "hop_size" in jax_out
