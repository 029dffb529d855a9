"""The test split and its evaluation on the CPU, against the JAX package:
``TestRunner`` (JAX's draws replayed), the dataset's ``test_ids``,
``run.py test``, ``eval/metrics.py`` and ``eval/evaluate_gen.py``.
"""

import csv
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from stylesinger_tpu.config import tiny_test_config as jax_tiny
from stylesinger_tpu.data.dataset import StyleSingerDataset as JaxDataset
from stylesinger_tpu.eval import evaluate_gen as jeval
from stylesinger_tpu.eval import metrics as jmetrics
from stylesinger_tpu.inference import StyleSingerInfer as JaxInfer
from stylesinger_tpu.models.encoders import UtteranceEncoder as JaxEncoder
from stylesinger_tpu.training.test_runner import TestRunner as JaxRunner
from stylesinger_tpu.vocoder_infer import HifiGAN_NSF as JaxHifiGAN
from test_torch_convert_ckpt import ReferenceGE2E
from test_torch_load_params import TINY, tiny_corpus, trained_run
from test_torch_trainer import items
from torch_parity import (
    Replay, acoustic_variables, gm_dual_draws, one_torch_thread,
    random_variables, sampler_keys, shallow_draws, stash_draws,
)

from stylesinger_torch import run
from stylesinger_torch.config import tiny_test_config
from stylesinger_torch.convert import from_jax_params
from stylesinger_torch.data.batching import collate_batch
from stylesinger_torch.data.dataset import StyleSingerDataset
from stylesinger_torch.dsp.mel import load_wav, save_wav
from stylesinger_torch.eval import evaluate_gen, metrics
from stylesinger_torch.models.encoders import UtteranceEncoder
from stylesinger_torch.models.hifigan import HifiGanGenerator
from stylesinger_torch.models.stylesinger import StyleSinger
from stylesinger_torch.training.test_runner import TestRunner
from stylesinger_torch.vocoder_infer import HifiGAN_NSF

# the fixture, imported above, runs this module on one torch thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")

ATOL = 1e-3
PHONES = [f"p{i}" for i in range(17)]   # 20 tokens, as the items use


# ------------------------------------------------------------ TestRunner

class _KeyRecorder:
    """Stands in for the JAX model: records the keys it hands its samplers
    and its output shapes, call by call (the keys reach the host through
    ``jax.debug.callback`` from inside the runner's ``jax.jit``)."""

    def __init__(self, model, calls):
        self.model, self.calls = model, calls

    def apply(self, *args, **kwargs):
        keys = {}
        with sampler_keys(keys):
            ret = self.model.apply(*args, **kwargs)
        names = sorted(k for k in keys if k != "sh_name")
        shapes = (ret["mel2ph"].shape, ret["mel_out"].shape)

        def record(*values):
            self.calls.append((dict(zip(names, map(np.asarray, values))),
                               *shapes))
        jax.debug.callback(record, *[keys[n] for n in names])
        return ret


class _DrawRecorder:
    """Stands in for the JAX generator: records its draws, call by call."""

    def __init__(self, model, calls):
        self.model, self.calls = model, calls

    def apply(self, *args, **kwargs):
        draws = []
        with stash_draws(draws):
            wav = self.model.apply(*args, **kwargs)
        kinds = [k for k, _ in draws]

        def record(*values):
            self.calls.append(list(zip(kinds, map(np.asarray, values))))
        jax.debug.callback(record, *[v for _, v in draws])
        return wav


class _ReplayVocoder:
    """The port's ``HifiGAN_NSF`` with each call's recorded draws."""

    def __init__(self, vocoder, calls):
        self.vocoder, self.calls = vocoder, list(calls)

    def spec2wav(self, mel, f0=None):
        return self.vocoder.spec2wav(mel, f0=f0,
                                     noise=Replay(self.calls.pop(0)))


def _batches(cfg):
    """Two batches: two items, then three padded to four rows (the fourth
    past ``nsamples``)."""
    ds = StyleSingerDataset(cfg, "test", items=items(12, 5))
    return [collate_batch([ds[i] for i in idxs], cfg["frame_buckets"],
                          cfg["token_buckets"])
            for idxs in ([0, 1], [2, 3, 4])]


@pytest.fixture(scope="module")
def runner_pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("runner")
    cfg = jax_tiny(**TINY)
    ji = JaxInfer(cfg, phone_list=PHONES)
    av = acoustic_variables(ji, seed=6)
    vv = random_variables(
        ji.vocoder.init, {"params": jax.random.PRNGKey(0),
                          "noise": jax.random.PRNGKey(1)},
        np.zeros((1, 16, cfg["audio_num_mel_bins"]), np.float32),
        np.full((1, 16), 200.0, np.float32), seed=7, gain=0.5)
    tcfg = tiny_test_config(**TINY)
    batches = _batches(tcfg)

    model_calls, voc_calls = [], []
    jvoc = JaxHifiGAN(cfg, params=vv["params"])
    jvoc.model = _DrawRecorder(jvoc.model, voc_calls)
    jrun = JaxRunner(_KeyRecorder(ji.model, model_calls), cfg, jvoc,
                     str(root / "jax"), gen_dir_name="7")
    jax_dir = jrun.run(av, batches)
    model_draws = [
        gm_dual_draws(keys["gm"], cfg["f0_timesteps"], *mel2ph) +
        shallow_draws(keys["sh"], cfg["K_step"], mel)
        for keys, mel2ph, mel in model_calls]

    model = StyleSinger(tcfg, len(PHONES) + 3)
    model.load_state_dict(from_jax_params(av))
    gen = HifiGanGenerator(tcfg)
    gen.load_state_dict(from_jax_params(vv))
    voc = _ReplayVocoder(HifiGAN_NSF(tcfg, model=gen, device="cpu"),
                         voc_calls)
    noise = [Replay(d) for d in model_draws]
    port_dir = TestRunner(model, tcfg, voc, str(root / "port"),
                          gen_dir_name="7").run(
        batches, noise=lambda idx: noise.pop(0))
    return dict(jax_dir=jax_dir, port_dir=port_dir, voc=voc)


def test_test_runner_writes_what_jax_writes(runner_pair):
    jd, pd = runner_pair["jax_dir"], runner_pair["port_dir"]
    assert os.path.basename(pd) == os.path.basename(jd) == "generated_7"
    names = sorted(os.listdir(os.path.join(jd, "wavs")))
    # two items, then three (the padding row skipped)
    assert names == sorted(f"item_{i:04d}{s}.wav" for i in range(5)
                           for s in ("", "_gt"))
    assert sorted(os.listdir(os.path.join(pd, "wavs"))) == names
    with open(os.path.join(jd, "meta.csv")) as f:
        meta = f.read()
    with open(os.path.join(pd, "meta.csv")) as f:
        assert f.read() == meta
    assert runner_pair["voc"].calls == []


def test_test_runner_wavs_and_f0s_match_jax(runner_pair):
    jd, pd = runner_pair["jax_dir"], runner_pair["port_dir"]
    for name in sorted(os.listdir(os.path.join(jd, "wavs"))):
        ref = load_wav(os.path.join(jd, "wavs", name), 48000)
        out = load_wav(os.path.join(pd, "wavs", name), 48000)
        assert out.shape == ref.shape and np.abs(ref).max() > 1e-3, name
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0,
                                   err_msg=name)
    ref = np.load(os.path.join(jd, "result_f0s.npy"), allow_pickle=True)
    out = np.load(os.path.join(pd, "result_f0s.npy"), allow_pickle=True)
    assert len(out) == len(ref) == 5
    for a, b in zip(out, ref):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32), atol=ATOL,
                                   rtol=0)


def test_get_vocoder_cls_covers_jax_registry():
    """Every wrapper JAX registers, under its name: ``HifiGAN_NSF`` by
    default, and ``PWG`` and ``MelGAN``."""
    from stylesinger_tpu.vocoder_infer import VOCODERS as JAX_VOCODERS

    from stylesinger_torch.vocoder_infer import (
        MelGAN, PWG, VOCODERS, get_vocoder_cls,
    )

    assert set(JAX_VOCODERS) == set(VOCODERS)
    assert get_vocoder_cls(tiny_test_config()) is HifiGAN_NSF
    for name, cls in (("PWG", PWG), ("MelGAN", MelGAN)):
        assert get_vocoder_cls(tiny_test_config(vocoder=name)) is cls


# ---------------------------------------------------------------- test_ids

def test_test_ids_select_the_items_jax_selects(tmp_path):
    data_dir = tiny_corpus(tmp_path / "binary")
    for test_ids in (None, [0, 2, 3], [3, 1]):
        jds = JaxDataset(jax_tiny(test_ids=test_ids), "test",
                         data_dir=data_dir)
        tds = StyleSingerDataset(tiny_test_config(test_ids=test_ids), "test",
                                 data_dir=data_dir)
        assert tds.avail_idxs == jds.avail_idxs and tds.sizes == jds.sizes
        assert [tds[i]["item_name"] for i in range(len(tds))] == \
            [jds[i]["item_name"] for i in range(len(jds))]
        np.testing.assert_array_equal(tds[len(tds) - 1]["mels"],
                                      jds[len(jds) - 1]["mels"])
    # the other splits ignore it
    cfg = tiny_test_config(test_ids=[1])
    assert len(StyleSingerDataset(cfg, "valid", data_dir=data_dir)) == 2


# ------------------------------------------------------------ run.py test

def test_run_test_refuses_without_a_checkpoint(tmp_path, capsys):
    cfg_dir = tiny_corpus(tmp_path / "binary")
    assert run.main(["test", "--device", "cpu", "--hparams",
                     f"binary_data_dir={cfg_dir}", "--work_dir_root",
                     str(tmp_path / "none")]) == 2
    assert "no checkpoint" in capsys.readouterr().err
    assert not (tmp_path / "none").exists()


def test_run_test_writes_the_generation_dir(tmp_path, capsys):
    cfg, state, hparams = trained_run(tmp_path)
    assert run.main(["test", "--device", "cpu", "--hparams",
                     hparams + ",test_ids=[0,2,3]", "--exp_name", "tiny",
                     "--work_dir_root", str(tmp_path / "ckpts")]) == 0
    gen = tmp_path / "ckpts" / "tiny" / "generated_2"
    assert f"| wrote {gen}" in capsys.readouterr().out
    with open(gen / "meta.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["item_name"] for r in rows] == [f"item_{i:04d}"
                                              for i in range(3)]
    assert sorted(os.listdir(gen / "wavs")) == sorted(
        f"item_{i:04d}{s}.wav" for i in range(3) for s in ("", "_gt"))
    f0s = np.load(gen / "result_f0s.npy", allow_pickle=True)
    assert [len(f) for f in f0s] == [int(r["n_frames"]) for r in rows]


# -------------------------------------------------------------- metrics

def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def test_metrics_match_jax():
    rng = np.random.default_rng(21)
    scores = rng.standard_normal(300)
    labels = (scores + rng.standard_normal(300) > 0).astype(int)
    for got, want in zip(metrics.compute_eer(scores, labels),
                         jmetrics.compute_eer(scores, labels)):
        assert _rel(got, want) <= 1e-6
    f0_a = rng.uniform(100, 300, 200) * (rng.uniform(size=200) > 0.2)
    f0_b = f0_a * rng.uniform(0.7, 1.3, 200) * (rng.uniform(size=200) > 0.2)
    for tol in (0.2, 0.05):
        assert _rel(metrics.ffe(f0_a, f0_b, tol),
                    jmetrics.ffe(f0_a, f0_b, tol)) <= 1e-6
    a, b = rng.standard_normal(64), rng.standard_normal(64)
    assert _rel(metrics.cosine(a, b), jmetrics.cosine(a, b)) <= 1e-6
    mel_a = rng.standard_normal((50, 80)).astype(np.float32)
    mel_b = rng.standard_normal((45, 80)).astype(np.float32)
    assert _rel(metrics.mcd(mel_a, mel_b), jmetrics.mcd(mel_a, mel_b)) <= 1e-6
    assert np.isnan(metrics.ffe(f0_a[:0], f0_b)) and \
        np.isnan(metrics.mcd(mel_a[:0], mel_b))


def test_speaker_cosine_matches_jax():
    sr = 16000
    t = np.arange(2 * sr) / sr
    wav_a = (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    wav_b = (0.3 * np.sin(2 * np.pi * 330 * t + np.sin(2 * np.pi * 4 * t))
             ).astype(np.float32)
    jenc = JaxEncoder(hidden_size=32, embed_size=32, num_layers=1)
    variables = random_variables(jenc.init, jax.random.PRNGKey(0),
                                 np.zeros((1, 160, 40), np.float32), seed=8)
    enc = UtteranceEncoder(hidden_size=32, embed_size=32, num_layers=1)
    enc.load_state_dict(from_jax_params(variables))
    for x, y in ((wav_a, wav_a), (wav_a, wav_b)):
        assert _rel(metrics.speaker_cosine(x, y, sr, enc),
                    jmetrics.speaker_cosine(x, y, sr, variables, jenc)) \
            <= 1e-6


# ----------------------------------------------------------- evaluate_gen

EVAL_CFG = dict(audio_sample_rate=24000, fft_size=512, hop_size=128,
                win_size=512, audio_num_mel_bins=40, fmin=20, fmax=12000)


def _gen_dir(root, sr=24000):
    """Seeded pairs, each against a vibrato tone: the tone a third sharper
    over its second half, the tone with its middle third silent, and an
    item without its ``_gt`` twin."""
    rng = np.random.default_rng(4)
    wavs = root / "wavs"
    wavs.mkdir(parents=True)
    n = int(1.5 * sr)
    t = np.arange(n) / sr
    for i, f in enumerate((220.0, 180.0)):
        gt = 0.3 * np.sin(2 * np.pi * f * t + 2 * np.sin(2 * np.pi * 5 * t))
        if i == 0:
            pred = 0.3 * np.sin(2 * np.pi * f * np.where(
                t < t[n // 2], t, t[n // 2] + 1.3 * (t - t[n // 2])))
        else:
            pred = gt * ((t < t[n // 3]) | (t > t[2 * n // 3]))
        pred = pred + 1e-3 * rng.standard_normal(n)
        save_wav(gt, str(wavs / f"item_{i:04d}_gt.wav"), sr)
        save_wav(pred, str(wavs / f"item_{i:04d}.wav"), sr)
    save_wav(0.1 * np.sin(2 * np.pi * 300 * t), str(wavs / "item_0002.wav"),
             sr)
    return root


def test_evaluate_dir_matches_jax(tmp_path):
    torch.manual_seed(9)
    spk = str(tmp_path / "pretrained.pt")
    torch.save({"model_state": ReferenceGE2E().state_dict()}, spk)
    jax_dir = str(_gen_dir(tmp_path / "jax"))
    port_dir = str(tmp_path / "port")
    shutil.copytree(jax_dir, port_dir)
    want = jeval.evaluate_dir(jax_dir, sr=24000, cfg=EVAL_CFG,
                              spk_encoder_path=spk)
    got = evaluate_gen.evaluate_dir(port_dir, sr=24000, cfg=EVAL_CFG,
                                    spk_encoder_path=spk, device="cpu")
    assert got.keys() == want.keys() and got["n"] == want["n"] == 2
    with open(os.path.join(jax_dir, "metrics.json")) as f:
        jm = json.load(f)
    with open(os.path.join(port_dir, "metrics.json")) as f:
        tm = json.load(f)
    assert tm.keys() == jm.keys() and tm["summary"].keys() == \
        jm["summary"].keys()
    frames = len(load_wav(os.path.join(jax_dir, "wavs", "item_0000.wav"),
                          24000)) // EVAL_CFG["hop_size"]
    for t_row, j_row in zip(tm["items"], jm["items"]):
        assert t_row.keys() == j_row.keys() and \
            t_row["item"] == j_row["item"]
        assert abs(t_row["mcd"] - j_row["mcd"]) <= 1e-2
        assert abs(t_row["ffe"] - j_row["ffe"]) <= 1.0 / frames
        assert _rel(t_row["spk_cos"], j_row["spk_cos"]) <= 1e-6
    assert abs(got["mcd_mean"] - want["mcd_mean"]) <= 1e-2
    assert abs(got["ffe_mean"] - want["ffe_mean"]) <= 1.0 / frames
