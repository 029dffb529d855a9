"""The zero-shot synthesis slice of the PyTorch port against the JAX package.

Same weights (seeded numpy, converted with ``from_jax_params``), same
inputs and the JAX run's own noise replayed into the port: preprocessing,
``StyleSinger`` inference and the vocoder at ``tiny_test_config``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    Replay, gm_dual_draws, random_variables, sampler_keys, shallow_draws,
    stash_draws, to_np,
)

ATOL = 1e-3
PHONES = list("abcdefg")
REQUEST = dict(ph="a b c d e", notes=[60, 62, 0, 64, 65],
               notes_duration=[0.2, 0.3, 0.1, 0.2, 0.2],
               note_types=[1, 1, 1, 2, 2])


def _clip(seconds=1.0, sr=48000):
    rng = np.random.default_rng(7)
    t = np.arange(int(seconds * sr)) / sr
    phase = 2 * np.pi * 220 * t + 3 * np.sin(2 * np.pi * 5 * t)
    wav = sum(rng.uniform(0.2, 1) / h * np.sin(h * phase)
              for h in range(1, 6))
    return (0.3 * wav / np.abs(wav).max()).astype(np.float32)


@pytest.fixture(scope="module")
def slice_run():
    from stylesinger_tpu.config import tiny_test_config
    from stylesinger_tpu.inference import StyleSingerInfer as JaxInfer

    from stylesinger_torch.config import tiny_test_config as torch_tiny
    from stylesinger_torch.convert import from_jax_params
    from stylesinger_torch.inference import StyleSingerInfer

    cfg = tiny_test_config(hop_size=64, mrf_block=64, mrf_pallas=True)
    ji = JaxInfer(cfg, phone_list=PHONES)
    ex = ji._example_inputs()
    t_ref = ex["ref_mels"].shape[1]
    keys = {k: jax.random.PRNGKey(n) for n, k in enumerate(
        ["params", "dropout", "umln", "rq", "diffusion", "noise"])}
    av = random_variables(
        ji.model.init, keys, ex["txt_tokens"],
        jnp.ones((1, t_ref), jnp.int32), ex["spk_embed"], ex["emo_embed"],
        ex["ref_mels"], ex["ref_f0"], jnp.full((1, t_ref), 8.0),
        jnp.zeros((1, t_ref)), ex["note"], ex["note_dur"], ex["note_type"],
        infer=False, use_rq=True, forcing=False, use_diff=True, seed=1)
    # random weights give ~0-frame phones: make phones ~4 frames long
    av["params"]["dur_predictor"]["out"]["bias"][:] = np.log(5.0)
    vv = random_variables(
        ji.vocoder.init, {"params": keys["params"], "noise": keys["noise"]},
        jnp.zeros((1, 16, cfg["audio_num_mel_bins"])),
        jnp.full((1, 16), 200.0), seed=2, gain=0.5)
    sv = random_variables(ji.spk_encoder.init, keys["params"],
                          jnp.zeros((1, 160, 40)), seed=3)
    ev = random_variables(ji.emo_encoder.init, keys["params"],
                          jnp.zeros((1, 160, 40)), seed=4)
    ji.variables, ji.voc_variables = av, vv
    ji.spk_variables, ji.emo_variables = sv, ev

    inp = dict(REQUEST, ref_audio=_clip())
    jax_batch = ji.preprocess_input(inp)

    voc_kinds = []

    def fwd(variables, voc_variables, batch):
        keys_seen, voc_draws = {}, []
        with sampler_keys(keys_seen):
            ret = ji.model.apply(
                variables, batch["txt_tokens"], None, batch["spk_embed"],
                batch["emo_embed"], batch["ref_mels"], batch["ref_f0"], None,
                None, batch["note"], batch["note_dur"], batch["note_type"],
                infer=True, use_diff=True, max_frames=cfg["max_frames"],
                rngs={"diffusion": ji._rng, "rq": ji._rng})
        with stash_draws(voc_draws):
            wav = ji.vocoder.apply(voc_variables, ret["mel_out"],
                                   ret["f0_denorm"], rngs={"noise": ji._rng})
        outs = {k: ret[k] for k in ("mel_out", "f0_denorm", "mel2ph",
                                    "pitch_pred")}
        voc_kinds[:] = [kind for kind, _ in voc_draws]
        return (outs, wav, keys_seen["gm"], keys_seen["sh"],
                [value for _, value in voc_draws])

    jb = {k: jnp.asarray(v) for k, v in jax_batch.items()}
    ret, wav, key_gm, key_sh, voc_draws = jax.jit(fwd)(av, vv, jb)
    b, t = ret["mel2ph"].shape
    draws = (gm_dual_draws(key_gm, cfg["f0_timesteps"], b, t) +
             shallow_draws(key_sh, cfg["K_step"], ret["mel_out"].shape) +
             list(zip(voc_kinds, voc_draws)))

    ti = StyleSingerInfer(torch_tiny(hop_size=64, mrf_block=64,
                                     mrf_pallas=True),
                          phone_list=PHONES, device="cpu")
    for module, variables in ((ti.model, av), (ti.vocoder, vv),
                              (ti.spk_encoder, sv), (ti.emo_encoder, ev)):
        module.load_state_dict(from_jax_params(variables))
    tb = {k: torch.as_tensor(v) for k, v in jax_batch.items()}
    noise = Replay(draws)
    with torch.no_grad():
        tret = ti.model(**tb, noise=noise)
        twav = ti.vocoder(tret["mel_out"], tret["f0_denorm"], noise)
    return dict(cfg=cfg, inp=inp, jax_batch=jax_batch, ret=ret, wav=wav,
                ti=ti, tret=tret, twav=twav, noise=noise, ji=ji)


def test_slice_replays_every_draw(slice_run):
    assert slice_run["noise"].draws == []


def test_slice_durations_and_uv_exact(slice_run):
    ret, tret = slice_run["ret"], slice_run["tret"]
    mel2ph = np.asarray(ret["mel2ph"])
    assert (mel2ph > 0).sum() > 8  # the phones really last some frames
    np.testing.assert_array_equal(to_np(tret["mel2ph"]), mel2ph)
    uv = np.asarray(ret["pitch_pred"])[..., 1] > 0
    np.testing.assert_array_equal(to_np(tret["pitch_pred"])[..., 1] > 0, uv)


@pytest.mark.parametrize("key", ["mel_out", "f0_denorm"])
def test_slice_acoustic_outputs(slice_run, key):
    ref = np.asarray(slice_run["ret"][key])
    np.testing.assert_allclose(to_np(slice_run["tret"][key]), ref, atol=ATOL,
                               rtol=0)


def test_slice_waveform(slice_run):
    ref = np.asarray(slice_run["wav"])
    out = to_np(slice_run["twav"])
    assert out.shape == ref.shape and np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_slice_preprocess_input(slice_run):
    """Reference clip -> mel (kernel twin), F0, d-vectors."""
    jb = slice_run["jax_batch"]
    tb = slice_run["ti"].preprocess_input(slice_run["inp"])
    for k in ("txt_tokens", "note", "note_type", "note_dur"):
        np.testing.assert_array_equal(to_np(tb[k]), jb[k])
    np.testing.assert_allclose(to_np(tb["ref_mels"]), jb["ref_mels"],
                               atol=3e-3, rtol=2e-3)
    np.testing.assert_allclose(to_np(tb["ref_f0"]), jb["ref_f0"], atol=1e-4)
    for k in ("spk_embed", "emo_embed"):
        np.testing.assert_allclose(to_np(tb[k]), jb[k], atol=2e-4,
                                   rtol=2e-3)


def test_slice_forward_model_crops_to_length(slice_run):
    """forward_model returns the wav/mel/f0 cut to the predicted frames."""
    ti, cfg = slice_run["ti"], slice_run["cfg"]
    tb = {k: torch.as_tensor(v) for k, v in slice_run["jax_batch"].items()}
    out = ti.forward_model(tb)
    n = int((np.asarray(slice_run["ret"]["mel2ph"]) > 0).sum())
    assert out["mel"].shape == (n, cfg["audio_num_mel_bins"])
    assert out["f0"].shape == (n,)
    assert out["wav"].shape == (n * cfg["hop_size"],)
    assert np.isfinite(out["wav"]).all()


class _RecordingVocoder:
    """Stands in for the JAX vocoder module and records its draws."""

    def __init__(self, vocoder, draws):
        self.vocoder, self.draws = vocoder, draws

    def apply(self, *args, **kwargs):
        with stash_draws(self.draws):
            return self.vocoder.apply(*args, **kwargs)


@pytest.fixture(scope="module")
def batch_run(slice_run):
    """Two requests of different lengths through JAX's ``infer_batch`` and
    the port's, the JAX run's draws replayed into the port."""
    ji, ti, cfg = slice_run["ji"], slice_run["ti"], slice_run["cfg"]
    inp = slice_run["inp"]
    short = dict(inp, ph="a b", notes=[60, 62], notes_duration=[0.2, 0.2],
                 note_types=[1, 1])
    inps = [inp, short]
    keys_seen, voc_draws = {}, []
    vocoder = ji.vocoder
    ji.vocoder = _RecordingVocoder(vocoder, voc_draws)
    try:
        with sampler_keys(keys_seen):
            jax_outs = ji.infer_batch(inps)
    finally:
        ji.vocoder = vocoder
    b, t = len(inps), cfg["max_frames"]
    model_draws = (
        gm_dual_draws(keys_seen["gm"], cfg["f0_timesteps"], b, t) +
        shallow_draws(keys_seen["sh"], cfg["K_step"],
                      (b, t, cfg["audio_num_mel_bins"])))
    per_row = len(voc_draws) // b
    row_draws = [voc_draws[i * per_row: (i + 1) * per_row] for i in range(b)]
    noise = Replay(model_draws + voc_draws)
    outs = ti.infer_batch(inps, noise=noise)
    return dict(inps=inps, jax_outs=jax_outs, outs=outs, noise=noise,
                model_draws=model_draws, row_draws=row_draws)


@pytest.mark.parametrize("key", ["mel", "f0", "wav"])
def test_slice_infer_batch_matches_jax(batch_run, key):
    """Bucket padding, the joint forward and the per-row vocoder crop give
    what JAX's ``infer_batch`` gives, row by row."""
    assert batch_run["noise"].draws == []
    outs, jax_outs = batch_run["outs"], batch_run["jax_outs"]
    assert len(outs) == len(jax_outs) == 2
    for out, ref in zip(outs, jax_outs):
        ref = np.asarray(ref[key])
        assert out[key].shape == ref.shape and ref.shape[0] > 0
        np.testing.assert_allclose(out[key], ref, atol=ATOL, rtol=0)


def test_slice_infer_batch_matches_single(slice_run, batch_run):
    """Each row of a batch equals that request run alone with the same
    noise and padded to the same bucket, and each row's wav is the vocoder
    over its own frames.  (Unpadded, a request differs: the encoder sees
    the padding, see ``test_encoder_padding_leak_matches_jax``.)"""
    ti = slice_run["ti"]
    t_txt = max(len(inp["notes"]) for inp in batch_run["inps"])
    t_txt = min(b for b in ti.cfg["token_buckets"] if b >= t_txt)
    for row, (inp, out) in enumerate(zip(batch_run["inps"],
                                         batch_run["outs"])):
        batch = ti.preprocess_input(inp)
        for k in ("txt_tokens", "note", "note_dur", "note_type"):
            batch[k] = torch.nn.functional.pad(
                batch[k], (0, t_txt - batch[k].shape[1]))
        noise = Replay([(k, np.asarray(v)[row: row + 1])
                        for k, v in batch_run["model_draws"]])
        with torch.no_grad():
            ret = ti.model(**batch, noise=noise)
        assert noise.draws == []
        n = int((ret["mel2ph"] > 0).sum())
        mel, f0 = ret["mel_out"][:, :n], ret["f0_denorm"][:, :n]
        wav = ti.vocoder(mel, f0, Replay(batch_run["row_draws"][row]))
        for key, single in (("mel", mel[0]), ("f0", f0[0]), ("wav", wav[0])):
            assert tuple(single.shape) == out[key].shape
            np.testing.assert_allclose(to_np(single), out[key], atol=ATOL,
                                       rtol=0)


def test_entry_point_refuses_missing_gpu():
    from stylesinger_torch.config import tiny_test_config
    from stylesinger_torch.inference import StyleSingerInfer

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        StyleSingerInfer(tiny_test_config(), phone_list=PHONES)
