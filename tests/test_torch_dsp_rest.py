"""The rest of the port's ``dsp/`` against the JAX package's, on the CPU:
loudness, ``wav2spec(loud_norm=True)``, the CWT, DTW, the TextGrid
aligner, ``mel2ph_from_durs_np``, ``group_hidden_by_segs``, Griffin-Lim
and the ``GriffinLim`` vocoder with JAX's initial phases replayed.
Inputs come from seeded numpy; tolerance atol 2e-4 / rtol 2e-3 unless a
test states another."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylesinger_tpu.config import tiny_test_config as jax_tiny
from stylesinger_tpu.dsp import align as jalign
from stylesinger_tpu.dsp import cwt as jcwt
from stylesinger_tpu.dsp import dtw as jdtw
from stylesinger_tpu.dsp import griffin_lim as jgl
from stylesinger_tpu.dsp import loudness as jloud
from stylesinger_tpu.dsp import textgrid_align as jtg
from stylesinger_tpu.dsp.mel import wav2spec_np

from stylesinger_torch.config import tiny_test_config as torch_tiny
from stylesinger_torch.dsp import align, cwt, dtw, griffin_lim, loudness
from stylesinger_torch.dsp import textgrid_align as tg
from stylesinger_torch.dsp.mel import wav2spec

ATOL, RTOL = 2e-4, 2e-3


def close(ours, ref, atol=ATOL, rtol=RTOL):
    ours = ours.detach().cpu().numpy() if isinstance(ours, torch.Tensor) \
        else np.asarray(ours)
    np.testing.assert_allclose(ours, np.asarray(ref), atol=atol, rtol=rtol)


def voice(seconds, sr, seed, level=0.3):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    phase = 2 * np.pi * 200 * t + 3 * np.sin(2 * np.pi * 4 * t)
    wav = sum(rng.uniform(0.2, 1) / h * np.sin(h * phase) for h in range(1, 6))
    wav = wav * (t > 0.2) + 0.01 * rng.standard_normal(len(t))
    return (level * wav / np.abs(wav).max()).astype(np.float32)


def f0_track(n, seed):
    rng = np.random.default_rng(seed)
    f0 = 200 * 2 ** (np.cumsum(rng.normal(0, 0.02, n)))
    f0[rng.uniform(size=n) < 0.2] = 0.0
    f0[:3] = 0.0
    return f0.astype(np.float32)


# ---------------------------------------------------------------- loudness

@pytest.mark.parametrize("sr,level", [(16000, 0.3), (48000, 0.02),
                                      (44100, 0.9)])
def test_loudness_equals_jax(sr, level):
    wav = voice(1.5, sr, 1, level)
    assert loudness.integrated_loudness(wav, sr) == \
        jloud.integrated_loudness(wav, sr)
    out = loudness.normalize_loudness(wav, sr)
    np.testing.assert_array_equal(out, jloud.normalize_loudness(wav, sr))
    assert out.dtype == np.float32
    silent = np.zeros(sr // 10, np.float32)  # shorter than a 400 ms block
    assert loudness.integrated_loudness(silent, sr) == \
        jloud.integrated_loudness(silent, sr) == -70.0


def test_wav2spec_loud_norm_matches_wav2spec_np():
    wav = voice(1.0, 16000, 2, level=0.05)
    kw = dict(sample_rate=16000, n_fft=512, hop_size=128, win_length=512,
              n_mels=16, fmin=20.0, fmax=8000.0)
    for loud_norm in (True, False):
        ours = wav2spec(wav, torch.device("cpu"), loud_norm=loud_norm, **kw)
        ref = wav2spec_np(wav, loud_norm=loud_norm, **kw)
        np.testing.assert_array_equal(ours["wav"], ref["wav"])
        close(ours["mel"], ref["mel"])
    quiet = wav2spec(wav, torch.device("cpu"), **kw)["wav"]
    loud = wav2spec(wav, torch.device("cpu"), loud_norm=True, **kw)["wav"]
    assert np.abs(loud).max() > 2 * np.abs(quiet).max()


# ---------------------------------------------------------------- cwt

def test_cwt_equals_jax():
    f0 = f0_track(200, 3)
    uv, lf0 = cwt.cont_lf0_np(f0)
    juv, jlf0 = jcwt.cont_lf0_np(f0)
    np.testing.assert_array_equal(uv, juv)
    np.testing.assert_array_equal(lf0, jlf0)
    np.testing.assert_array_equal(cwt.cwt_scales(), jcwt.cwt_scales())
    x = ((lf0 - lf0.mean()) / lf0.std()).astype(np.float32)
    batch = np.stack([x, x[::-1].copy()])
    w = cwt.cwt_mexican_hat(torch.as_tensor(batch))
    jw = jcwt.cwt_mexican_hat(jnp.asarray(batch))
    assert w.shape == (2, 200, 10)
    close(w, jw, atol=1e-3 * float(np.abs(np.asarray(jw)).max()))
    close(cwt.inverse_cwt(w), jcwt.inverse_cwt(jw))
    mean = np.asarray([5.3, 5.1], np.float32)
    std = np.asarray([0.2, 0.1], np.float32)
    close(cwt.cwt2f0(w, torch.as_tensor(mean), torch.as_tensor(std)),
          jcwt.cwt2f0(jw, jnp.asarray(mean), jnp.asarray(std)), rtol=2e-3)
    all_uv = np.zeros(5, np.float32)
    for a, b in zip(cwt.cont_lf0_np(all_uv), jcwt.cont_lf0_np(all_uv)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- dtw

@pytest.mark.parametrize("tx,ty,d", [(1, 5, 2), (7, 7, 1), (23, 31, 3),
                                     (40, 9, 4)])
def test_dtw_distance_equals_jax(tx, ty, d):
    rng = np.random.default_rng(tx * 100 + ty)
    x = rng.standard_normal((tx, d)).astype(np.float32)
    y = rng.standard_normal((ty, d)).astype(np.float32)
    ours = float(dtw.dtw_distance(torch.as_tensor(x), torch.as_tensor(y)))
    ref = float(jdtw.dtw_distance(jnp.asarray(x), jnp.asarray(y)))
    assert ours == pytest.approx(ref, rel=1e-5)
    dist = np.sqrt(((x[:, None] - y[None]) ** 2).sum(-1))
    np.testing.assert_array_equal(dtw.align_from_distances(dist),
                                  jdtw.align_from_distances(dist))


def test_f0_dtw_error_equals_jax():
    a, b = f0_track(80, 4), f0_track(95, 5)
    assert dtw.f0_dtw_error(a, b) == pytest.approx(jdtw.f0_dtw_error(a, b),
                                                   rel=1e-5)
    assert np.isnan(dtw.f0_dtw_error(np.zeros(4), b))


# ---------------------------------------------------------------- align

TEXTGRID = '''File type = "ooTextFile"
Object class = "TextGrid"

xmin = 0
xmax = 1.3
tiers? <exists>
size = 2
item []:
    item [1]:
        class = "IntervalTier"
        name = "words"
        xmin = 0
        xmax = 1.3
        intervals: size = 1
        intervals [1]:
            xmin = 0
            xmax = 1.3
            text = "ni hao"
    item [2]:
        class = "IntervalTier"
        name = "phones"
        xmin = 0
        xmax = 1.3
        intervals: size = 7
        intervals [1]:
            xmin = 0
            xmax = 0.12
            text = ""
        intervals [2]:
            xmin = 0.12
            xmax = 0.31
            text = "n"
        intervals [3]:
            xmin = 0.31
            xmax = 0.55
            text = "i3"
        intervals [4]:
            xmin = 0.55
            xmax = 0.57
            text = ""
        intervals [5]:
            xmin = 0.57
            xmax = 0.80
            text = "h"
        intervals [6]:
            xmin = 0.80
            xmax = 1.21
            text = "ao3"
        intervals [7]:
            xmin = 1.21
            xmax = 1.3
            text = ""
'''


@pytest.mark.parametrize("ph,min_sil", [("<BOS> n i3 | h ao3 <EOS>", 0.0),
                                        ("<BOS> n i3 h ao3 <EOS>", 0.05),
                                        ("n i3 h ao3", 0.05)])
def test_textgrid_alignment_equals_jax(tmp_path, ph, min_sil):
    path = tmp_path / "item.TextGrid"
    path.write_text(TEXTGRID, encoding="utf-8")
    tiers = tg.parse_textgrid(str(path))
    assert [len(t) for t in tiers] == [1, 7]
    jtiers = jtg.parse_textgrid(TEXTGRID)
    assert [[vars(i) for i in t] for t in tiers] == \
        [[vars(i) for i in t] for t in jtiers]
    kw = dict(n_frames=130, hop_size=160, sample_rate=16000,
              min_sil_duration=min_sil)
    mel2ph, dur = tg.get_mel2ph_from_textgrid(str(path), ph, **kw)
    jmel2ph, jdur = jtg.get_mel2ph_from_textgrid(str(path), ph, **kw)
    np.testing.assert_array_equal(mel2ph, jmel2ph)
    np.testing.assert_array_equal(dur, jdur)
    assert mel2ph.max() >= len(dur) and dur.sum() > 0
    for p in ("", "<BOS>", "|", "sil", "a", "3x"):
        assert tg.is_sil_phoneme(p) == jtg.is_sil_phoneme(p)
    # phones that do not fit the TextGrid: JAX asserts, the port raises
    with pytest.raises(AssertionError):
        jtg.get_mel2ph_from_textgrid(str(path), "n i3 h", **kw)
    with pytest.raises(ValueError, match="non-silent intervals"):
        tg.get_mel2ph_from_textgrid(str(path), "n i3 h", **kw)


def test_mel2ph_from_durs_and_segment_means_equal_jax():
    rng = np.random.default_rng(6)
    durs = rng.uniform(0.01, 0.3, 12)
    for n_frames in (40, 200):
        kw = dict(hop_size=256, sample_rate=48000)
        np.testing.assert_array_equal(
            align.mel2ph_from_durs_np(durs, n_frames, **kw),
            jalign.mel2ph_from_durs_np(durs, n_frames, **kw))
    h = rng.standard_normal((2, 30, 5)).astype(np.float32)
    seg = np.stack([np.sort(rng.integers(0, 9, 30)),
                    np.sort(rng.integers(1, 12, 30))])  # ids past 8 drop
    sums, cnt = align.group_hidden_by_segs(torch.as_tensor(h),
                                           torch.as_tensor(seg), 8)
    jsums, jcnt = jalign.group_hidden_by_segs(jnp.asarray(h),
                                              jnp.asarray(seg), 8)
    close(sums, jsums)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))


# ---------------------------------------------------------------- griffin-lim

GL = dict(n_fft=256, hop_size=64, win_length=256)


def jax_angles(shape):
    """JAX's initial phases (``griffin_lim.py:59-60``), replayed."""
    u = jax.random.uniform(jax.random.PRNGKey(0), shape)
    return np.exp(2j * np.pi * np.asarray(u)).astype(np.complex64)


def test_griffin_lim_equals_jax_with_its_phases():
    wav = voice(0.5, 16000, 7)
    spec = np.fft.rfft(np.lib.stride_tricks.sliding_window_view(
        np.pad(wav, 128), 256)[::64] * np.hanning(256), axis=-1)
    mag = np.abs(spec).astype(np.float32)
    ref = np.asarray(jgl.griffin_lim(jnp.asarray(mag), n_iters=8, **GL))
    ours = griffin_lim.griffin_lim(torch.as_tensor(mag), n_iters=8,
                                   angles=torch.as_tensor(
                                       jax_angles(mag.shape)), **GL)
    assert ours.shape == ref.shape == ((mag.shape[0] - 1) * 64,)
    close(ours, ref, atol=1e-4 * float(np.abs(ref).max()), rtol=0)
    other = griffin_lim.griffin_lim(
        torch.as_tensor(mag), n_iters=8,
        generator=torch.Generator().manual_seed(3), **GL)
    assert float((other - ours).abs().max()) > 1e-3  # the phases matter


def test_griffin_lim_vocoder_equals_jax():
    from stylesinger_tpu.vocoder_infer import GriffinLim as JaxGriffinLim

    from stylesinger_torch.vocoder_infer import GriffinLim, get_vocoder_cls

    kw = dict(audio_sample_rate=16000, fft_size=256, win_size=256,
              hop_size=64, fmax=8000, vocoder="GriffinLim")
    jcfg, cfg = jax_tiny(**kw), torch_tiny(**kw)
    mel = wav2spec_np(voice(0.4, 16000, 8), sample_rate=16000, n_fft=256,
                      hop_size=64, win_length=256, n_mels=16,
                      fmax=8000.0)["mel"]
    ref = JaxGriffinLim(jcfg).spec2wav(mel)
    assert get_vocoder_cls(cfg) is GriffinLim
    voc = GriffinLim(cfg, device="cpu")
    n_freq = cfg["fft_size"] // 2 + 1
    ours = voc.spec2wav(mel, angles=jax_angles((mel.shape[0], n_freq)))
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=1e-4 * float(np.abs(ref).max()))
    close(griffin_lim.mel_to_linear(torch.as_tensor(mel), sample_rate=16000,
                                    n_fft=256, n_mels=16, fmax=8000.0),
          jgl.mel_to_linear(jnp.asarray(mel), sample_rate=16000, n_fft=256,
                            n_mels=16, fmax=8000.0))
    seeded = voc.spec2wav(mel)  # the wrapper's own seeded phases
    assert np.isfinite(seeded).all() and seeded.shape == ref.shape
    np.testing.assert_array_equal(seeded, voc.spec2wav(mel))
