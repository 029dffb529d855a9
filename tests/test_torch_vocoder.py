"""The port's vocoder against the JAX package's: the ``ResBlock2`` and bf16
generators, the ``HifiGAN_NSF`` wrapper (whole and streamed) and the
spectral-subtraction denoiser.

Same seeded weights (``from_jax_params``) and JAX's own draws replayed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylesinger_tpu.config import tiny_test_config
from stylesinger_tpu.dsp.denoise import denoise as jax_denoise
from stylesinger_tpu.models.hifigan import HifiGanGenerator as JaxGenerator
from stylesinger_tpu.vocoder_infer import HifiGAN_NSF as JaxHifiGAN
from torch_parity import Replay, random_variables, stash_draws, to_np

from stylesinger_torch.config import tiny_test_config as torch_tiny
from stylesinger_torch.convert import from_jax_params
from stylesinger_torch.dsp.denoise import denoise
from stylesinger_torch.models.hifigan import HifiGanGenerator
from stylesinger_torch.vocoder_infer import HifiGAN_NSF

TOL = dict(atol=2e-4, rtol=2e-3)
FRAMES = 40
RESBLOCK2 = dict(resblock="2", resblock_kernel_sizes=(3, 5),
                 resblock_dilation_sizes=((1, 2), (2, 6)))


def _inputs(frames=FRAMES, bins=16, seed=0):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((frames, bins)).astype(np.float32)
    f0 = (220 * 2 ** (rng.uniform(-1, 1, frames) / 2)).astype(np.float32)
    f0[frames // 3: frames // 2] = 0.0  # an unvoiced stretch
    return mel, f0


def _variables(cfg):
    gen = JaxGenerator(cfg)
    return gen, random_variables(
        gen.init, {"params": jax.random.PRNGKey(0),
                   "noise": jax.random.PRNGKey(1)},
        jnp.zeros((1, 16, cfg["audio_num_mel_bins"])),
        jnp.full((1, 16), 200.0), seed=2, gain=0.5)


def _jax_wav(gen, variables, mel, f0):
    draws = []
    with stash_draws(draws):
        wav = gen.apply(variables, jnp.asarray(mel)[None],
                        jnp.asarray(f0)[None],
                        rngs={"noise": jax.random.PRNGKey(3)})
    return np.asarray(wav)[0], [(k, np.asarray(v)) for k, v in draws]


def _port(over, variables):
    gen = HifiGanGenerator(torch_tiny(**over))
    gen.load_state_dict(from_jax_params(variables))
    return gen


def _port_wav(gen, mel, f0, draws):
    noise = Replay(draws)
    with torch.no_grad():  # inference: the MRF stages the kernel takes
        wav = gen(torch.tensor(mel)[None], torch.tensor(f0)[None], noise)
    assert noise.draws == []
    return to_np(wav)[0]


@pytest.mark.parametrize("block", [64, 0])
def test_resblock2_generator_matches_jax(block):
    """``resblock: "2"`` runs the resblock modules on every stage, over
    overlap-save blocks (block 64) or the whole stage (block 0)."""
    over = dict(mrf_block=block, **RESBLOCK2)
    gen, variables = _variables(tiny_test_config(**over))
    mel, f0 = _inputs()
    ref, draws = _jax_wav(gen, variables, mel, f0)
    port = _port(over, variables)
    assert set(port.mrf_routes(FRAMES)) == {"blocks" if block else "modules"}
    np.testing.assert_allclose(_port_wav(port, mel, f0, draws), ref, **TOL)


def test_generator_without_nsf_matches_jax():
    """``use_nsf: false``: no harmonic source and no draws."""
    over = dict(mrf_block=64, use_nsf=False)
    gen, variables = _variables(tiny_test_config(**over))
    assert "m_source" not in variables["params"]
    mel, f0 = _inputs()
    ref, draws = _jax_wav(gen, variables, mel, f0)
    assert draws == []
    np.testing.assert_allclose(_port_wav(_port(over, variables), mel, f0, []),
                               ref, **TOL)


@pytest.fixture(scope="module")
def bf16_runs():
    """The JAX generator in f32 and in bf16 (its MRF stages through the
    Pallas kernel in interpret mode, as ``mrf_pallas`` sends them), and the
    port's bf16 generator (the MRF kernel's bf16 twin), on one input."""
    over = dict(mrf_block=64)
    mel, f0 = _inputs()
    gen32, variables = _variables(tiny_test_config(**over))
    ref32, draws = _jax_wav(gen32, variables, mel, f0)
    gen16 = JaxGenerator(tiny_test_config(vocoder_compute_dtype="bfloat16",
                                          mrf_pallas=True, **over))
    ref16, draws16 = _jax_wav(gen16, variables, mel, f0)
    port = _port(dict(vocoder_compute_dtype="bfloat16", **over), variables)
    assert set(port.mrf_routes(FRAMES)) == {"kernel"}
    out16 = _port_wav(port, mel, f0, draws16)
    return dict(ref32=ref32, ref16=ref16, out16=out16)


def test_bf16_generator_matches_jax_bf16_generator(bf16_runs):
    """Both round to bf16 at every conv, but not always at the same points
    (a torch bf16 conv rounds once after its bias, flax rounds the product
    and then the bias sum; XLA's CPU interpret path drops the rounding of
    each resblock's last residual, see tests/test_torch_kernels.py): 3 %
    of max|y|, about 8 bf16 ulps of it."""
    ref16, out16 = bf16_runs["ref16"], bf16_runs["out16"]
    assert np.abs(ref16).max() > 1e-2
    assert np.abs(out16 - ref16).max() <= 3e-2 * np.abs(ref16).max()


def test_bf16_generator_error_band_against_f32(bf16_runs):
    """Against JAX's f32 generator, the port's bf16 error is no more than
    twice JAX's own bf16 error, plus 1e-3."""
    ref32 = bf16_runs["ref32"]
    d_port = np.abs(bf16_runs["out16"] - ref32).max()
    d_jax = np.abs(bf16_runs["ref16"] - ref32).max()
    assert d_jax > 0
    assert d_port <= 2 * d_jax + 1e-3, (d_port, d_jax)


class _RecordingJit:
    """Stands in for the JAX wrapper's jitted generator call and keeps each
    call's draws."""

    def __init__(self, model):
        self.calls = []

        def traced(params, mel, f0, rng):
            draws = []
            with stash_draws(draws):
                wav = model.apply({"params": params}, mel, f0,
                                  rngs={"noise": rng})
            return wav, [v for _, v in draws]

        self.fn = jax.jit(traced)

    def __call__(self, params, mel, f0, rng):
        wav, values = self.fn(params, mel, f0, rng)
        # the generator draws the harmonic source's uniform, then normal
        self.calls.append(list(zip("un", map(np.asarray, values))))
        return wav


def _wrappers(**over):
    cfg = tiny_test_config(hop_size=64, mrf_block=64, **over)
    gen, variables = _variables(cfg)
    jw = JaxHifiGAN(cfg, params=variables["params"])
    jw._jit = _RecordingJit(jw.model)
    port = _port(dict(hop_size=64, mrf_block=64, **over), variables)
    tw = HifiGAN_NSF(torch_tiny(hop_size=64, mrf_block=64, **over),
                     model=port, device="cpu")
    return jw, tw


def test_spec2wav_matches_jax_wrapper_with_denoise():
    jw, tw = _wrappers(vocoder_denoise_c=0.01)
    mel, f0 = _inputs()
    ref = jw.spec2wav(mel, f0=f0)
    out = tw.spec2wav(mel, f0=f0, noise=Replay(jw._jit.calls[0]))
    assert out.shape == ref.shape == (FRAMES * 64,)
    np.testing.assert_allclose(out, ref, **TOL)


def test_spec2wav_streaming_matches_jax_wrapper():
    """Chunks of 64 frames overlapping by 2 x 8, crossfaded: 200 frames
    take 4 chunks, the last one aligned to the end."""
    jw, tw = _wrappers()
    mel, f0 = _inputs(frames=200, seed=4)
    ref = jw.spec2wav_streaming(mel, f0=f0, chunk_frames=64,
                                overlap_frames=8)
    assert len(jw._jit.calls) == 4
    draws = [d for call in jw._jit.calls for d in call]
    noise = Replay(draws)
    out = tw.spec2wav_streaming(mel, f0=f0, chunk_frames=64,
                                overlap_frames=8, noise=noise)
    assert noise.draws == []
    assert out.shape == ref.shape == (200 * 64,)
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("n,n_fft,hop,win", [(12288, 1024, 256, 1024),
                                             (12000, 512, 128, 400)])
def test_denoise_matches_jax(n, n_fft, hop, win):
    """A length that is not a multiple of the hop comes back shorter, as
    in JAX (the inverse STFT covers whole hops)."""
    rng = np.random.default_rng(5)
    wav = (0.3 * np.sin(np.arange(n) * 0.05) +
           0.02 * rng.standard_normal(n)).astype(np.float32)
    kw = dict(n_fft=n_fft, hop_size=hop, win_length=win)
    ref = np.asarray(jax_denoise(jnp.asarray(wav), 0.05, **kw))
    out = to_np(denoise(torch.tensor(wav), 0.05, **kw))
    assert out.shape == ref.shape == (n // hop * hop,)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-4)


def test_wrapper_refuses_a_checkpoint(capsys):
    """A ``vocoder_ckpt`` that does not exist is refused with JAX's warning
    and the seeded random weights stay (loading a checkpoint that exists:
    ``tests/test_torch_vocoder_ckpt.py``)."""
    voc = HifiGAN_NSF(torch_tiny(vocoder_ckpt="ckpt/voc"), device="cpu")
    assert "vocoder_ckpt ckpt/voc not found" in capsys.readouterr().out
    seeded = HifiGAN_NSF(torch_tiny(), device="cpu").model.state_dict()
    for k, v in voc.model.state_dict().items():
        assert torch.equal(v, seeded[k]), k
