"""``vocoder_ckpt`` loading of the port against the JAX package's
``load_vocoder_params``, on the CPU.

The test writes a synthetic weight-norm ``model_gen`` state dict in the
reference (AaronZ345/StyleSinger) layout into ``model_ckpt_steps_N.ckpt``
files itself, so it needs no reference checkout.  JAX's loader (through
``from_jax_params``) and the port's give the same ``state_dict`` exactly
(both fold the weight norm in numpy f32), and the same ``spec2wav`` at atol
2e-4 / rtol 2e-3 with JAX's draws replayed.  The port's own files
(``fit_vocoder``'s ``generator.pt`` and ``gan_state.pt``) are held in
``tests/test_torch_vocoder_train.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from stylesinger_tpu.config import tiny_test_config
from stylesinger_tpu.vocoder_infer import HifiGAN_NSF as JaxHifiGAN
from stylesinger_tpu.vocoder_infer import load_vocoder_params
from torch_parity import Replay, stash_draws, to_np

from stylesinger_torch.config import tiny_test_config as torch_tiny
from stylesinger_torch.convert import from_jax_params
from stylesinger_torch.vocoder_infer import (
    HifiGAN_NSF, load_vocoder_state_dict,
)

OVER = dict(mrf_block=64)
FRAMES = 40


def reference_generator_sd(cfg, seed):
    """A reference NSF ``HifiGanGenerator`` state dict with weight norm
    (``weight_g`` / ``weight_v``) on every conv but the noise convs."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.tensor(scale * rng.standard_normal(shape),
                            dtype=torch.float32)

    sd = {}

    def wn(name, c_first, *rest, bias):
        sd[f"{name}.weight_g"] = t(c_first, 1, 1).abs() + 0.5
        sd[f"{name}.weight_v"] = t(c_first, *rest)
        sd[f"{name}.bias"] = t(bias, scale=0.1)

    ch0 = cfg["upsample_initial_channel"]
    rates = cfg["upsample_rates"]
    wn("conv_pre", ch0, cfg["audio_num_mel_bins"], 7, bias=ch0)
    for i, (u, k) in enumerate(zip(rates, cfg["upsample_kernel_sizes"])):
        c_prev, c_cur = ch0 // 2 ** i, ch0 // 2 ** (i + 1)
        wn(f"ups.{i}", c_prev, c_cur, k, bias=c_cur)  # [in, out, k]
        s = int(np.prod(rates[i + 1:]))
        sd[f"noise_convs.{i}.weight"] = t(c_cur, 1, 2 * s if s > 1 else 1,
                                          scale=0.3)
        sd[f"noise_convs.{i}.bias"] = t(c_cur, scale=0.1)
        for j, (rk, rd) in enumerate(zip(cfg["resblock_kernel_sizes"],
                                         cfg["resblock_dilation_sizes"])):
            rb = f"resblocks.{i * len(cfg['resblock_kernel_sizes']) + j}"
            for n in range(len(rd)):
                wn(f"{rb}.convs1.{n}", c_cur, c_cur, rk, bias=c_cur)
                wn(f"{rb}.convs2.{n}", c_cur, c_cur, rk, bias=c_cur)
    wn("conv_post", 1, ch0 // 2 ** len(rates), 7, bias=1)
    sd["m_source.l_linear.weight"] = t(1, cfg["harmonic_num"] + 1)
    sd["m_source.l_linear.bias"] = t(1, scale=0.1)
    return sd


def write_reference_dir(path, cfg):
    """Two reference checkpoints: steps 300 and 2000 (the highest N wins,
    which a comparison of the names as text would miss)."""
    os.makedirs(path, exist_ok=True)
    for steps, seed in ((300, 1), (2000, 2)):
        torch.save({"state_dict": {"model_gen": reference_generator_sd(
            cfg, seed)}}, os.path.join(path, f"model_ckpt_steps_{steps}.ckpt"))
    return path


def test_reference_checkpoint_loads_as_jax_loads_it(tmp_path):
    cfg = tiny_test_config(**OVER)
    ckpt_dir = write_reference_dir(str(tmp_path / "ref"), cfg)
    newest = os.path.join(ckpt_dir, "model_ckpt_steps_2000.ckpt")
    want = from_jax_params({"params": load_vocoder_params(
        dict(cfg, vocoder_ckpt=ckpt_dir))})
    assert set(want) == set(from_jax_params({"params": load_vocoder_params(
        dict(cfg, vocoder_ckpt=newest))}))
    for path in (ckpt_dir, newest):
        got = load_vocoder_state_dict(torch_tiny(vocoder_ckpt=path, **OVER))
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), (path, k)

    # spec2wav through each wrapper, JAX's draws replayed into the port
    jw = JaxHifiGAN(dict(cfg, vocoder_ckpt=ckpt_dir))
    rng = np.random.default_rng(3)
    mel = rng.standard_normal((FRAMES, 16)).astype(np.float32)
    f0 = rng.uniform(150, 250, FRAMES).astype(np.float32)
    f0[-5:] = 0.0
    ref = jw.spec2wav(mel, f0)
    kinds = []

    @jax.jit
    def run(params, mel, f0, key):
        draws = []
        with stash_draws(draws):
            wav = jw.model.apply({"params": params}, mel, f0,
                                 rngs={"noise": key})
        kinds[:] = [k for k, _ in draws]
        return wav, [v for _, v in draws]

    wav, draws = run(jw.params, jnp.asarray(mel)[None],
                     jnp.asarray(f0)[None], jw._rng)
    np.testing.assert_array_equal(np.asarray(wav)[0], ref)
    port = HifiGAN_NSF(torch_tiny(vocoder_ckpt=ckpt_dir, **OVER),
                       device="cpu")
    assert port.model.mrf_routes(FRAMES) == ["kernel"] * 4
    noise = Replay(list(zip(kinds, draws)))
    out = port.spec2wav(mel, f0, noise=noise)
    assert noise.draws == [] and np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=2e-3)


def test_missing_vocoder_ckpt_warns_and_keeps_random_weights(tmp_path,
                                                            capsys):
    """As JAX: a path that does not exist, or a directory with no
    reference checkpoint (the port's own files are named by their file),
    warns and leaves the seeded random weights."""
    seeded = HifiGAN_NSF(torch_tiny(), device="cpu", seed=4).model
    empty = tmp_path / "empty"
    empty.mkdir()
    for path, says in ((tmp_path / "nope", "not found"),
                       (empty, "has no reference")):
        voc = HifiGAN_NSF(torch_tiny(vocoder_ckpt=str(path)), device="cpu",
                          seed=4)
        assert says in capsys.readouterr().out
        for k, v in voc.model.state_dict().items():
            assert torch.equal(v, seeded.state_dict()[k]), k
    assert load_vocoder_state_dict(torch_tiny()) is None


def test_discriminator_kernels_take_the_2d_and_grouped_rules():
    """``from_jax_params``: a 2-D conv kernel [kh, kw, in, out] becomes a
    Conv2d weight [out, in, kh, kw]; a grouped 1-D kernel [k, in / g, out]
    a grouped Conv1d weight [out, in / g, k]."""
    rng = np.random.default_rng(0)
    k2 = rng.standard_normal((5, 1, 3, 4)).astype(np.float32)
    k1 = rng.standard_normal((41, 8, 32)).astype(np.float32)
    sd = from_jax_params({"a": {"kernel": k2}, "b": {"kernel": k1}})
    np.testing.assert_array_equal(to_np(sd["a.weight"]),
                                  k2.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(to_np(sd["b.weight"]),
                                  k1.transpose(2, 1, 0))
    assert sd["b.weight"].shape == torch.nn.Conv1d(32, 32, 41,
                                                   groups=4).weight.shape
