"""The port's modules in training mode against the JAX package's, on the
CPU: dropout at the sites of ``models/common.py`` and the style and
denoiser modules (flax's keep masks replayed), the prosody aligner's
forcing band and guided loss, and ``grad_scale``.

Same seeded weights (``random_variables`` -> ``from_jax_params``), same
numpy inputs; the flax ``dropout`` stream's masks, recorded by
``torch_parity.stash_draws``, are replayed into the port.  Outputs and the
gradients of a fixed loss to the inputs are held at atol 2e-4 / rtol 2e-3
(``tests/test_convert.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    Replay, one_torch_thread, random_variables, stash_draws, to_np,
)

from stylesinger_torch.convert import from_jax_params

# the fixture, imported above, runs this module on one torch thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = dict(atol=2e-4, rtol=2e-3)
H = 32


def _rng(seed):
    return np.random.default_rng(seed)


def _close(ours, ref):
    np.testing.assert_allclose(to_np(ours), np.asarray(ref), **TOL)


def _weights(shape):
    """A fixed projection for the loss sum(y * w), the same on both sides."""
    return _rng(99).standard_normal(shape).astype(np.float32)


def _both(jmod, tmod, args, seed, **apply_kw):
    """``jmod`` with dropout on (its masks recorded) and ``tmod`` with them
    replayed: outputs, their count of dropout draws, and the gradients of
    sum(out * w) to the first input on both sides."""
    jargs = [jnp.asarray(a) for a in args]
    v = random_variables(jmod.init, {"params": jax.random.PRNGKey(0)},
                         *jargs, seed=seed)
    kinds = []

    def f(variables, x0):
        draws = []

        def loss(x0):
            with stash_draws(draws):
                out = jmod.apply(variables, x0, *jargs[1:],
                                 rngs={"dropout": jax.random.PRNGKey(5)},
                                 **apply_kw)
            first = out[0] if isinstance(out, tuple) else out
            return (first * _weights(first.shape)).sum(), out

        if jnp.issubdtype(x0.dtype, jnp.integer):
            (_, out), grad = loss(x0), None
        else:
            (_, out), grad = jax.value_and_grad(loss, has_aux=True)(x0)
        kinds[:] = [k for k, _ in draws]
        return out, grad, [d for _, d in draws]

    out, grad, draws = jax.jit(f)(v, jargs[0])
    assert kinds and set(kinds) == {"b"}
    tmod.load_state_dict(from_jax_params(v))
    x0 = torch.as_tensor(args[0]).requires_grad_(
        torch.as_tensor(args[0]).is_floating_point())
    drop = Replay(list(zip(kinds, draws)))
    tout = tmod(x0, *(torch.as_tensor(a) for a in args[1:]), drop=drop,
                **{k: v for k, v in apply_kw.items() if k != "deterministic"})
    assert not drop.draws
    tfirst = tout[0] if isinstance(tout, tuple) else tout
    if x0.requires_grad:
        (tfirst * torch.as_tensor(_weights(tuple(tfirst.shape)))).sum(
            ).backward()
    return out, grad, tout, x0.grad, len(kinds)


def test_encoder_and_decoder_dropout_match_jax():
    from stylesinger_tpu.models import common as jc

    from stylesinger_torch.models import common as tc

    tokens = np.array([[3, 5, 7, 2, 9, 0], [4, 4, 1, 0, 0, 0]])
    out, _, tout, _, n = _both(
        jc.FastspeechEncoder(10, H, 2, 3, num_heads=2, dropout=0.2),
        tc.FastspeechEncoder(10, H, 2, 3, num_heads=2, dropout=0.2),
        [tokens], 1, deterministic=False)
    # the input's, then per layer after attention, in the FFN, after it
    assert n == 1 + 2 * 3
    _close(tout, out)

    x = _rng(2).standard_normal((2, 12, H)).astype(np.float32)
    nonpadding = np.ones((2, 12), np.float32)
    nonpadding[1, 8:] = 0
    out, grad, tout, tgrad, n = _both(
        jc.FastspeechDecoder(H, 2, 3, num_heads=2, dropout=0.2),
        tc.FastspeechDecoder(H, 2, 3, num_heads=2, dropout=0.2),
        [x, nonpadding], 3, deterministic=False)
    assert n == 1 + 2 * 3
    _close(tout, out)
    _close(tgrad, grad)


@pytest.mark.parametrize("which", ["duration", "pitch"])
def test_predictor_dropout_matches_jax(which):
    from stylesinger_tpu.models import common as jc

    from stylesinger_torch.models import common as tc

    x = _rng(4).standard_normal((2, 10, H)).astype(np.float32)
    nonpadding = np.ones((2, 10), np.float32)
    nonpadding[1, 6:] = 0
    if which == "duration":
        jm = jc.DurationPredictor(H, n_layers=2, kernel_size=3, dropout=0.5)
        tm = tc.DurationPredictor(H, H, 2, 3, dropout=0.5)
    else:
        jm = jc.PitchPredictor(H, odim=2, n_layers=3, kernel_size=5,
                               dropout=0.1)
        tm = tc.PitchPredictor(H, H, odim=2, n_layers=3, kernel_size=5,
                               dropout=0.1)
    out, grad, tout, tgrad, n = _both(jm, tm, [x, nonpadding], 5,
                                      deterministic=False)
    assert n == (2 if which == "duration" else 3)
    _close(tout, out)
    _close(tgrad, grad)


def test_conv_blocks_dropout_matches_jax():
    from stylesinger_tpu.models import common as jc

    from stylesinger_torch.models import common as tc

    x = _rng(6).standard_normal((2, 14, 16)).astype(np.float32)
    nonpadding = np.ones((2, 14), np.float32)
    nonpadding[0, 10:] = 0
    out, grad, tout, tgrad, n = _both(
        jc.ConvBlocks(16, H, dilations=(1, 2), kernel_size=5, dropout=0.3),
        tc.ConvBlocks(16, H, dilations=(1, 2), kernel_size=5, dropout=0.3),
        [x, nonpadding], 7, deterministic=False)
    assert n == 2 * 2
    _close(tout, out)
    _close(tgrad, grad)


@pytest.mark.parametrize("forcing", [False, True], ids=["attention",
                                                        "forcing"])
def test_prosody_aligner_training_matches_jax(forcing):
    """Dropout on the attention weights and after both sublayers, or, with
    ``forcing``, the band in the attention's place; the guided loss and the
    attention maps too."""
    from stylesinger_tpu.models import style as js

    from stylesinger_torch.models import style as ts

    rng = _rng(8)
    src = rng.standard_normal((2, 12, H)).astype(np.float32)
    style = rng.standard_normal((2, 20, H)).astype(np.float32)
    src_np = np.array([[1] * 12, [1] * 7 + [0] * 5], np.float32)
    sty_np = np.array([[1] * 20, [1] * 15 + [0] * 5], np.float32)
    out, grad, tout, tgrad, n = _both(
        js.ProsodyAligner(H, num_layers=2, num_heads=2, ffn_dim=48),
        ts.ProsodyAligner(H, num_layers=2, num_heads=2, ffn_dim=48),
        [src, style, src_np, sty_np], 9, forcing=forcing,
        deterministic=False)
    assert n == 2 * (2 if forcing else 3)
    for o, r in zip(tout, out):
        _close(o, r)
    _close(tgrad, grad)


def test_fft_denoiser_dropout_matches_jax():
    from stylesinger_tpu.models import diffnet as jdn

    from stylesinger_torch.models import diffnet as tdn

    rng = _rng(10)
    spec = rng.standard_normal((2, 12, 16)).astype(np.float32)
    t = np.array([1, 3])
    cond = rng.standard_normal((2, 12, H)).astype(np.float32)
    cond[1, 9:] = 0
    out, grad, tout, tgrad, n = _both(
        jdn.FFTDenoiser(in_dims=16, hidden_size=H, residual_channels=16,
                        num_layers=2, kernel_size=3, num_heads=2),
        tdn.FFTDenoiser(in_dims=16, hidden_size=H, residual_channels=16,
                        num_layers=2, kernel_size=3, num_heads=2),
        [spec, t, cond], 11, deterministic=False)
    assert n == 1 + 2 * 3
    _close(tout, out)
    _close(tgrad, grad)


def test_grad_scale_matches_jax():
    from stylesinger_tpu.models.fs2 import grad_scale as jgs

    from stylesinger_torch.models.fs2 import grad_scale

    x = _rng(12).standard_normal((3, 4)).astype(np.float32)
    for scale in (1.0, 0.1):
        ref, g = jax.value_and_grad(
            lambda a: (jgs(a, scale) ** 2).sum())(jnp.asarray(x))
        xt = torch.as_tensor(x).requires_grad_(True)
        out = (grad_scale(xt, scale) ** 2).sum()
        out.backward()
        _close(out, ref)
        _close(xt.grad, g)


def test_prodiff_training_raises():
    """ProDiff's training pass, which the port used to refuse, runs: its
    diffusion draws are t, then the noise, and it returns the x0 it
    predicts (``tests/test_torch_settings.py`` holds the step to JAX's).
    A decoder the port lacks still raises."""
    from stylesinger_torch.config import tiny_test_config
    from stylesinger_torch.models.diffusion import Noise
    from stylesinger_torch.models.stylesinger import StyleSinger

    cfg = tiny_test_config(decoder="prodiff")
    model = StyleSinger(cfg, 20)
    b, t, tt = 2, 16, 4
    mel2ph = torch.repeat_interleave(torch.arange(1, tt + 1), 4)[None]
    kinds = []

    class Recording(Noise):
        def randint(self, shape, low, high):
            kinds.append(("i", tuple(shape), low, high))
            return super().randint(shape, low, high)

        def normal(self, shape):
            kinds.append(("n", tuple(shape)))
            return super().normal(shape)

    ret = model(torch.randint(1, 20, (b, tt)), torch.randn(b, 256),
                torch.randn(b, 256), torch.randn(b, t, 16) - 2,
                torch.zeros(b, t), torch.randint(40, 80, (b, tt)),
                torch.rand(b, tt), torch.ones(b, tt, dtype=torch.long),
                noise={"dropout": None, "umln": Noise(0, "cpu"),
                       "rq": Noise(1, "cpu"), "diffusion": Recording(2, "cpu")},
                infer=False, mel2ph=mel2ph.expand(b, -1),
                f0=torch.zeros(b, t), uv=torch.zeros(b, t))
    assert ret["mel_out"].shape == (b, t, 16)
    assert torch.isfinite(ret["mel_out"]).all()
    assert kinds[-2:] == [("i", (b,), 0, cfg["timesteps"] + 1),
                          ("n", (b, t, 16))]
    with pytest.raises(NotImplementedError):
        StyleSinger(tiny_test_config(decoder="wavenet"), 20)
