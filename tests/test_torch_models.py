"""Module-by-module parity of the PyTorch port with the JAX package.

Each JAX module gets seeded numpy weights shaped by its own init (training
path where it has one), the port's module loads them through
``from_jax_params``, and both run on the same numpy inputs.  Tolerance: atol
2e-4, rtol 2e-3 (the precedent of ``tests/test_convert.py``), unless a test
says otherwise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    Replay, gm_dual_draws, random_variables, shallow_draws, stash_draws,
    to_np,
)

from stylesinger_torch.convert import from_jax_params

TOL = dict(atol=2e-4, rtol=2e-3)
H = 32


def _load(module, variables):
    module.load_state_dict(from_jax_params(variables))
    return module.eval()


def _rng(seed):
    return np.random.default_rng(seed)


def _close(ours, ref, **tol):
    np.testing.assert_allclose(to_np(ours), np.asarray(ref), **(tol or TOL))


# ---------------------------------------------------------------- common

def test_fastspeech_encoder_decoder_and_durations():
    from stylesinger_tpu.models import common as jc

    from stylesinger_torch.models import common as tc

    tokens = np.array([[3, 5, 2, 7, 0, 0], [4, 4, 1, 0, 0, 0]])
    enc = jc.FastspeechEncoder(10, H, 2, 3, num_heads=2, dropout=0.0)
    ev = random_variables(enc.init, jax.random.PRNGKey(0),
                          jnp.asarray(tokens), seed=1)
    ref = jax.jit(enc.apply)(ev, jnp.asarray(tokens))
    ours = _load(tc.FastspeechEncoder(10, H, 2, 3, num_heads=2), ev)(
        torch.as_tensor(tokens))
    _close(ours, ref)

    x = _rng(2).standard_normal((2, 9, H)).astype(np.float32)
    nonpad = np.array([[1] * 9, [1] * 5 + [0] * 4], np.float32)
    dec = jc.FastspeechDecoder(H, 2, 3, num_heads=2, dropout=0.0)
    dv = random_variables(dec.init, jax.random.PRNGKey(0), jnp.asarray(x),
                          jnp.asarray(nonpad), seed=3)
    _close(_load(tc.FastspeechDecoder(H, 2, 3), dv)(
        torch.as_tensor(x), torch.as_tensor(nonpad)),
        jax.jit(dec.apply)(dv, jnp.asarray(x), jnp.asarray(nonpad)))

    dp = jc.DurationPredictor(H, n_layers=2, kernel_size=3, dropout=0.0)
    pv = random_variables(dp.init, jax.random.PRNGKey(0), jnp.asarray(x),
                          jnp.asarray(nonpad), seed=4)
    ref_dur = jax.jit(dp.apply)(pv, jnp.asarray(x), jnp.asarray(nonpad))
    ours_dur = _load(tc.DurationPredictor(H, H, 2, 3), pv)(
        torch.as_tensor(x), torch.as_tensor(nonpad))
    _close(ours_dur, ref_dur)

    dur = np.array([[2, 0, 3, 1, 4, 2, 0, 1, 1], [1, 2, 3, 0, 0, 5, 5, 5, 5]])
    pad = 1 - nonpad
    np.testing.assert_array_equal(
        to_np(tc.length_regulator(torch.as_tensor(dur),
                                  torch.as_tensor(pad), 16)),
        np.asarray(jc.length_regulator(jnp.asarray(dur), jnp.asarray(pad),
                                       16)))
    log_dur = np.log1p(_rng(5).uniform(0, 6, (2, 9))).astype(np.float32)
    np.testing.assert_array_equal(
        to_np(tc.DurationPredictor.out2dur(torch.as_tensor(log_dur))),
        np.asarray(jc.DurationPredictor.out2dur(jnp.asarray(log_dur))))


def test_encoder_padding_leak_matches_jax():
    """Padding a phone sequence moves the encoder's output at its real
    phones: the pre-FFN LayerNorm turns the zeroed padded rows into its
    bias, and the FFN's conv carries that into the neighbouring real rows.
    This is why ``infer_batch`` (which pads to a bucket) differs from
    ``infer_once``.  The port does the same as the JAX package."""
    from stylesinger_tpu.models import common as jc

    from stylesinger_torch.models import common as tc

    tokens = np.array([[3, 5, 2, 7]])
    padded = np.pad(tokens, ((0, 0), (0, 4)))
    enc = jc.FastspeechEncoder(10, H, 2, 3, num_heads=2, dropout=0.0)
    ev = random_variables(enc.init, jax.random.PRNGKey(0),
                          jnp.asarray(padded), seed=1)
    ref = np.asarray(jax.jit(enc.apply)(ev, jnp.asarray(padded)))
    leak = np.abs(ref[:, :4] - np.asarray(
        jax.jit(enc.apply)(ev, jnp.asarray(tokens)))).max()
    assert leak > 1e-3
    _close(_load(tc.FastspeechEncoder(10, H, 2, 3, num_heads=2), ev)(
        torch.as_tensor(padded)), ref)


# ----------------------------------------------------------------- style

def test_style_adaptor_and_prosody_aligner():
    from stylesinger_tpu.models import style as js

    from stylesinger_torch.models import style as ts

    mels = _rng(6).standard_normal((2, 20, 16)).astype(np.float32) - 2.0
    mels[1, 14:] = 0.0   # padded reference frames
    f0 = _rng(7).standard_normal((2, 20)).astype(np.float32)
    lsa = js.LocalStyleAdaptor(H, n_codes=8, rq_depth=2, mel_bins=16,
                               wn_layers=2, conv_dilations=(1, 2))
    lv = random_variables(lsa.init, {"params": jax.random.PRNGKey(0)},
                          jnp.asarray(mels), jnp.asarray(f0), seed=8)
    ref, ref_loss, ref_codes = jax.jit(lsa.apply)(lv, jnp.asarray(mels),
                                                  jnp.asarray(f0))
    port = _load(ts.LocalStyleAdaptor(H, n_codes=8, rq_depth=2, mel_bins=16,
                                      wn_layers=2, conv_dilations=(1, 2)), lv)
    ours, loss, codes = port(torch.as_tensor(mels), torch.as_tensor(f0))
    np.testing.assert_array_equal(to_np(codes), np.asarray(ref_codes))
    _close(ours, ref)
    _close(loss, ref_loss)

    src = _rng(9).standard_normal((2, 12, H)).astype(np.float32)
    style = _rng(10).standard_normal((2, 20, H)).astype(np.float32)
    src_np = np.array([[1] * 12, [1] * 7 + [0] * 5], np.float32)
    sty_np = (np.abs(mels[:, :, 0]) > 1e-8).astype(np.float32)
    al = js.ProsodyAligner(H, num_layers=2, num_heads=2, ffn_dim=48)
    args = [jnp.asarray(a) for a in (src, style, src_np, sty_np)]
    av = random_variables(al.init, jax.random.PRNGKey(0), *args, seed=11)
    r_out, r_loss, r_attn = jax.jit(al.apply)(av, *args)
    o_out, o_loss, o_attn = _load(
        ts.ProsodyAligner(H, num_layers=2, num_heads=2, ffn_dim=48), av)(
        *(torch.as_tensor(a) for a in (src, style, src_np, sty_np)))
    _close(o_out, r_out)
    _close(o_attn, r_attn)
    _close(o_loss, r_loss)


def test_attention_masks():
    from stylesinger_tpu.models import style as js

    from stylesinger_torch.models import style as ts

    q_len, k_len = np.array([12.0, 7.0]), np.array([20.0, 0.0])
    _close(ts.guided_attention_mask(12, torch.as_tensor(q_len), 20,
                                    torch.as_tensor(k_len), 0.3),
           js.guided_attention_mask(12, jnp.asarray(q_len), 20,
                                    jnp.asarray(k_len), 0.3))
    np.testing.assert_array_equal(
        to_np(ts.monotonic_band_attention(12, 20)),
        np.asarray(js.monotonic_band_attention(12, 20)))


# -------------------------------------------------------------- denoisers

def test_diffnet_and_ddiffnet():
    from stylesinger_tpu.models import diffnet as jd

    from stylesinger_torch.models import diffnet as td

    r = _rng(12)
    cond = r.standard_normal((2, 10, H)).astype(np.float32)
    t = np.array([3, 0])
    spec = r.standard_normal((2, 10, 16)).astype(np.float32)
    net = jd.DiffNet(in_dims=16, residual_layers=3, residual_channels=24,
                     dilation_cycle_length=2)
    args = (jnp.asarray(spec), jnp.asarray(t), jnp.asarray(cond))
    nv = random_variables(net.init, jax.random.PRNGKey(0), *args, seed=13)
    port = _load(td.DiffNet(16, H, 3, 24, 2), nv)
    _close(port(*(torch.as_tensor(a) for a in (spec, t, cond))),
           jax.jit(net.apply)(nv, *args))

    f0 = r.standard_normal((2, 10, 1)).astype(np.float32)
    uv = r.integers(0, 2, (2, 10))
    nonpad = np.array([[1] * 10, [1] * 6 + [0] * 4], np.float32)
    dnet = jd.DDiffNet(residual_layers=3, residual_channels=24,
                       dilation_cycle_length=2)
    dargs = tuple(jnp.asarray(a) for a in (f0, uv, t, cond, nonpad))
    dv = random_variables(dnet.init, jax.random.PRNGKey(0), *dargs, seed=14)
    dport = _load(td.DDiffNet(1, 2, H, 3, 24, 2), dv)
    _close(dport(*(torch.as_tensor(a) for a in (f0, uv, t, cond, nonpad))),
           jax.jit(dnet.apply)(dv, *dargs))


def test_samplers_with_replayed_noise():
    """Both chains of sample_gm_dual and sample_shallow, on a fixed linear
    denoiser, with JAX's draws replayed into the port."""
    from stylesinger_tpu.models import diffusion as jdiff

    from stylesinger_torch.models import diffusion as tdiff

    b, t, m = 2, 12, 6
    w = _rng(15).standard_normal((3, 3)).astype(np.float32) * 0.5

    def jfn(scale):
        def fn(z, uv, tt):
            feats = jnp.concatenate(
                [z, uv[..., None].astype(jnp.float32),
                 jnp.broadcast_to(tt[:, None, None] / 10.0, z.shape)], -1)
            return scale * feats @ jnp.asarray(w)
        return fn

    def tfn(scale):
        def fn(z, uv, tt):
            feats = torch.cat([z, uv[..., None].float(),
                               (tt[:, None, None] / 10.0).expand_as(z)], -1)
            return scale * feats @ torch.as_tensor(w)
        return fn

    sched_j = jdiff.make_schedule(8, 0.06)
    sched_t = tdiff.make_schedule(8, 0.06)
    lo = np.full((b, t, 1), -0.5, np.float32)
    hi = np.full((b, t, 1), 0.7, np.float32)
    key = jax.random.PRNGKey(3)
    (fa, ua), (fb, ub) = jax.jit(lambda k: jdiff.sample_gm_dual(
        jfn(1.0), jfn(-1.0), sched_j, t, b, k,
        dyn_clip=(jnp.asarray(lo), jnp.asarray(hi))))(key)
    noise = Replay(gm_dual_draws(key, 8, b, t))
    (ofa, oua), (ofb, oub) = tdiff.sample_gm_dual(
        tfn(1.0), tfn(-1.0), sched_t, t, b, noise,
        dyn_clip=(torch.as_tensor(lo), torch.as_tensor(hi)))
    assert noise.draws == []
    np.testing.assert_array_equal(to_np(oua), np.asarray(ua))
    np.testing.assert_array_equal(to_np(oub), np.asarray(ub))
    _close(ofa, fa, atol=1e-5, rtol=1e-5)
    _close(ofb, fb, atol=1e-5, rtol=1e-5)

    coarse = _rng(16).uniform(-1, 1, (b, t, m)).astype(np.float32)
    wm = _rng(17).standard_normal((m, m)).astype(np.float32) * 0.3
    x = jax.jit(lambda k: jdiff.sample_shallow(
        lambda xt, tt: xt @ jnp.asarray(wm), sched_j, jnp.asarray(coarse), k,
        8))(key)
    noise = Replay(shallow_draws(key, 8, coarse.shape))
    ours = tdiff.sample_shallow(lambda xt, tt: xt @ torch.as_tensor(wm),
                                sched_t, torch.as_tensor(coarse), noise, 8)
    assert noise.draws == []
    _close(ours, x, atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------- vocoder

@pytest.mark.parametrize("mrf_block", [0, 64])
def test_hifigan_generator(tiny_cfg, mrf_block):
    """NSF generator, monolithic and blocked MRF (the blocked Pallas path
    is covered by tests/test_torch_slice.py)."""
    from stylesinger_tpu.models.hifigan import HifiGanGenerator as JGen

    from stylesinger_torch.config import tiny_test_config
    from stylesinger_torch.models.hifigan import HifiGanGenerator

    cfg = tiny_cfg.replace(mrf_block=mrf_block)
    r = _rng(18)
    mel = r.standard_normal((1, 40, cfg["audio_num_mel_bins"])).astype(
        np.float32)
    f0 = np.where(r.uniform(size=(1, 40)) > 0.2,
                  r.uniform(100, 400, (1, 40)), 0.0).astype(np.float32)
    gen = JGen(cfg)
    keys = {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}
    gv = random_variables(gen.init, keys, jnp.asarray(mel), jnp.asarray(f0),
                          seed=19, gain=0.5)
    kinds = []

    def run(v, mel, f0):
        draws = []
        with stash_draws(draws):
            wav = gen.apply(v, mel, f0, rngs={"noise": keys["noise"]})
        kinds[:] = [k for k, _ in draws]
        return wav, [a for _, a in draws]

    ref, draws = jax.jit(run)(gv, jnp.asarray(mel), jnp.asarray(f0))
    port = _load(HifiGanGenerator(tiny_test_config(mrf_block=mrf_block)), gv)
    noise = Replay(list(zip(kinds, draws)))
    with torch.no_grad():  # inference: the MRF stages the kernel takes
        ours = port(torch.as_tensor(mel), torch.as_tensor(f0), noise)
    assert noise.draws == [] and np.abs(np.asarray(ref)).max() > 1e-3
    _close(ours, ref, atol=1e-4, rtol=0)


def test_phase_cumsum():
    from stylesinger_tpu.models.hifigan import blocked_phase_cumsum as jpc

    from stylesinger_torch.models.hifigan import blocked_phase_cumsum as tpc

    rad = _rng(20).uniform(0, 0.2, (2, 256 * 8, 3)).astype(np.float32)
    # in-block sums reach ~25, where f32 steps are 2e-6 and the two
    # cumsums add in different orders
    _close(tpc(torch.as_tensor(rad), 256), jpc(jnp.asarray(rad), 256),
           atol=1e-4, rtol=0)


# ------------------------------------------------------ reference front-end

def _voice(seconds, sr, seed):
    r = _rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    phase = 2 * np.pi * 180 * t + 4 * np.sin(2 * np.pi * 5 * t)
    wav = sum(r.uniform(0.2, 1) / h * np.sin(h * phase) for h in range(1, 6))
    wav = wav * (t > 0.25) + 0.01 * r.standard_normal(len(t))
    return (0.3 * wav / np.abs(wav).max()).astype(np.float32)


def test_pitch_tracker_and_f0_helpers():
    from stylesinger_tpu.dsp import pitch as jp

    from stylesinger_torch.dsp import pitch as tp

    wav = _voice(1.0, 24000, 21)
    kw = dict(hop_size=128, sample_rate=24000)
    ref = jax.jit(functools.partial(jp.autocorr_pitch, **kw))(
        jnp.asarray(wav))
    ours = tp.autocorr_pitch(torch.as_tensor(wav), **kw)
    ref = np.asarray(ref)
    assert (ref > 0).sum() > 50 and (ref == 0).sum() > 10
    np.testing.assert_array_equal(to_np(ours) > 0, ref > 0)
    _close(ours, ref, atol=1e-3, rtol=1e-5)

    f0 = np.array([0.0, 50.0, 110.0, 440.0, 1000.0, 2000.0], np.float32)
    np.testing.assert_array_equal(
        to_np(tp.f0_to_coarse(torch.as_tensor(f0))),
        np.asarray(jp.f0_to_coarse(jnp.asarray(f0))))
    lf0 = np.log2(f0 + 1)
    uv = (f0 == 0).astype(np.float32)
    _close(tp.denorm_f0(torch.as_tensor(lf0), torch.as_tensor(uv)),
           jp.denorm_f0(jnp.asarray(lf0), jnp.asarray(uv)))
    _close(tp.norm_f0(torch.as_tensor(f0), torch.as_tensor(uv)),
           jp.norm_f0(jnp.asarray(f0), jnp.asarray(uv)))
    for a, b in zip(tp.norm_interp_f0_np(f0), jp.norm_interp_f0_np(f0)):
        np.testing.assert_array_equal(a, b)


def test_ge2e_front_end_and_encoder():
    from stylesinger_tpu.models import encoders as je

    from stylesinger_torch.models import encoders as te

    wav48 = _voice(1.5, 48000, 22)
    wav16 = je.preprocess_wav(wav48, 48000)
    np.testing.assert_array_equal(te.preprocess_wav(wav48, 48000), wav16)
    np.testing.assert_array_equal(te.ge2e_mel_np(wav16), je.ge2e_mel_np(wav16))
    assert te.compute_partial_slices(len(wav16)) == \
        je.compute_partial_slices(len(wav16))

    enc = je.UtteranceEncoder()
    ev = random_variables(enc.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 160, 40)), seed=23)
    port = _load(te.UtteranceEncoder(), ev)
    for project in (True, False):
        ref = enc.embed_utterance(ev, wav16, project=project)
        _close(port.embed_utterance(wav16, project=project), ref)


def test_convert_layout_rules():
    """Dense, Conv and ConvTranspose kernels land in torch's layouts (the
    strict loads above catch a missing or unexpected key)."""
    import flax.linen as fnn

    x = jnp.zeros((1, 4, 8))
    cases = {
        "dense": (fnn.Dense(5), lambda k: k.T),
        "conv": (fnn.Conv(5, (3,)), lambda k: k.transpose(2, 1, 0)),
        "convT": (fnn.ConvTranspose(5, (4,), strides=(2,),
                                    transpose_kernel=True),
                  lambda k: k.transpose(2, 1, 0)),
    }
    for seed, (name, (module, layout)) in enumerate(cases.items()):
        v = random_variables(module.init, jax.random.PRNGKey(0), x,
                             seed=seed)
        sd = from_jax_params(v)
        np.testing.assert_array_equal(sd["weight"].numpy(),
                                      layout(v["params"]["kernel"]))
        np.testing.assert_array_equal(sd["bias"].numpy(),
                                      v["params"]["bias"])
