"""Whole zero-shot inference with the fast samplers and the other decoder
and pitch variants, against the JAX package at ``tiny_test_config``.

Same seeded weights, the same request and JAX's own draws replayed into
the port (``tests/torch_parity.py::inference_pair``).  mel2ph and the uv
decisions are exactly equal; mel, f0 and wav agree at atol 1e-3, as in
``tests/test_torch_slice.py``.
"""

import numpy as np
import pytest

from torch_parity import inference_pair, to_np

ATOL = 1e-3
PHONES = list("abcdefg")
REQUEST = dict(ph="a b c d e", notes=[60, 62, 0, 64, 65],
               notes_duration=[0.2, 0.3, 0.1, 0.2, 0.2],
               note_types=[1, 1, 1, 2, 2])
STEPS = dict(f0_timesteps=10, timesteps=10, K_step=10)
CONFIGS = {
    # the strided F0 sampler and PLMS: 2 x 2 + (2 + 1) denoiser calls
    "plms": dict(f0_speedup=5, pndm_speedup=5, **STEPS),
    # dpm_steps takes precedence over pndm_speedup
    "dpm": dict(f0_speedup=5, pndm_speedup=5, dpm_steps=4, **STEPS),
    # conv pitch predictors, ProDiff on the FFT denoiser
    "prodiff_fft_conv": dict(f0_gen="conv", decoder="prodiff",
                             diff_decoder_type="fft"),
    # the FFT decoder alone, no mel diffusion
    "fft_decoder": dict(decoder="fft", f0_speedup=2),
}
SAMPLER = {"plms": "sample_shallow_plms", "dpm": "sample_shallow_dpmpp",
           "prodiff_fft_conv": None, "fft_decoder": None}


def _clip(seconds=1.0, sr=48000):
    rng = np.random.default_rng(7)
    t = np.arange(int(seconds * sr)) / sr
    phase = 2 * np.pi * 220 * t + 3 * np.sin(2 * np.pi * 5 * t)
    wav = sum(rng.uniform(0.2, 1) / h * np.sin(h * phase)
              for h in range(1, 6))
    return (0.3 * wav / np.abs(wav).max()).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def run(request):
    name = request.param
    out = inference_pair(dict(hop_size=64, mrf_block=64, mrf_pallas=True,
                              **CONFIGS[name]),
                         PHONES, dict(REQUEST, ref_audio=_clip()))
    out["name"] = name
    return out


def test_variant_replays_every_draw_through_its_sampler(run):
    assert run["noise"].draws == []
    assert run["sampler"] == SAMPLER[run["name"]]


def test_variant_durations_and_uv_exact(run):
    ret, tret = run["ret"], run["tret"]
    mel2ph = np.asarray(ret["mel2ph"])
    assert (mel2ph > 0).sum() > 8
    np.testing.assert_array_equal(to_np(tret["mel2ph"]), mel2ph)
    uv = np.asarray(ret["pitch_pred"])[..., 1] > 0
    np.testing.assert_array_equal(to_np(tret["pitch_pred"])[..., 1] > 0, uv)


def test_variant_mel_f0_and_wav(run):
    for key in ("mel_out", "f0_denorm"):
        ref = np.asarray(run["ret"][key])
        np.testing.assert_allclose(to_np(run["tret"][key]), ref, atol=ATOL,
                                   rtol=0, err_msg=key)
    ref, out = np.asarray(run["wav"]), to_np(run["twav"])
    assert out.shape == ref.shape and np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
