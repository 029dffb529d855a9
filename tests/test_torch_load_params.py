"""Trained weights into the port's ``StyleSingerInfer`` on the CPU:
``load_params`` of a reference ``.ckpt`` (against the JAX package's
``StyleSingerInfer`` on the same file, JAX's draws replayed), of a
``Trainer.fit`` work dir and of a ``TrainState``; ``vocoder_ckpt`` and the
GE2E encoder paths (against JAX's ``_init_vocoder`` / ``_init_encoders``);
and ``run.py infer`` from a work dir.
"""

import json
import os
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from stylesinger_tpu.config import tiny_test_config as jax_tiny
from stylesinger_tpu.inference import StyleSingerInfer as JaxInfer
from test_torch_convert_ckpt import REFERENCE_STYLE, ReferenceGE2E
from test_torch_trainer import CURRICULUM, items
from test_torch_vocoder_ckpt import write_reference_dir
from torch_parity import Replay, inference_pair, one_torch_thread, to_np

from stylesinger_torch import run
from stylesinger_torch.config import load_config, tiny_test_config
from stylesinger_torch.convert import from_jax_params
from stylesinger_torch.data.indexed_dataset import IndexedDatasetBuilder
from stylesinger_torch.dsp.mel import save_wav
from stylesinger_torch.inference import StyleSingerInfer, init_random_
from stylesinger_torch.models.hifigan import HifiGanGenerator

# the fixture, imported above, runs this module on one torch thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")

ATOL = 1e-3
PHONES = list("abcdefg")
REQUEST = dict(ph="a b c d e", notes=[60, 62, 0, 64, 65],
               notes_duration=[0.2, 0.3, 0.1, 0.2, 0.2],
               note_types=[1, 1, 1, 2, 2])
VOCAB = 20   # the phones of the tiny corpus: VOCAB - 3 and the reserved 3
TINY = dict(hop_size=64, mrf_block=64)


def _clip(seconds=1.0, sr=48000):
    rng = np.random.default_rng(7)
    t = np.arange(int(seconds * sr)) / sr
    phase = 2 * np.pi * 220 * t + 3 * np.sin(2 * np.pi * 5 * t)
    wav = sum(rng.uniform(0.2, 1) / h * np.sin(h * phase)
              for h in range(1, 6))
    return (0.3 * wav / np.abs(wav).max()).astype(np.float32)


# ------------------------------------------------------ a tiny trained run

def tiny_corpus(root: Path) -> str:
    """``phone_set.json`` and the train, valid and test shards of seeded
    items at ``tiny_test_config``'s width; returns the directory."""
    root.mkdir(parents=True)
    (root / "phone_set.json").write_text(json.dumps(
        [f"p{i}" for i in range(VOCAB - 3)]))
    for prefix, seed, n in (("train", 8, 4), ("valid", 9, 2),
                            ("test", 10, 4)):
        builder = IndexedDatasetBuilder(str(root / prefix))
        data = items(seed, n)
        for it in data:
            builder.add_item(it)
        builder.finalize()
        np.save(root / f"{prefix}_lengths.npy",
                np.asarray([len(it["mel"]) for it in data]))
    return str(root)


def trained_run(root: Path):
    """``run.py train`` of the tiny corpus for 2 steps into
    ``<root>/ckpts/tiny`` (checkpoints at steps 1 and 2).  Returns (cfg,
    the final TrainState, the --hparams string that gives cfg)."""
    cfg = tiny_test_config(**dict(
        CURRICULUM, val_check_interval=1, max_updates=2,
        binary_data_dir=tiny_corpus(root / "binary"), **TINY))
    work = root / "ckpts" / "tiny"
    state = run.train(dict(cfg, work_dir=str(work)), str(work),
                      device="cpu")
    base = load_config()
    hparams = ",".join(
        f"{k}={json.dumps(v) if isinstance(v, (list, tuple)) else v}"
        for k, v in cfg.items() if json.dumps(v) != json.dumps(base[k]))
    return cfg, state, hparams


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("trained")
    cfg, state, hparams = trained_run(root)
    return dict(root=root, cfg=cfg, state=state, hparams=hparams,
                work=root / "ckpts" / "tiny")


def _same(a: torch.nn.Module, b: torch.nn.Module) -> bool:
    sb = b.state_dict()
    return all(torch.equal(v, sb[k]) for k, v in a.state_dict().items())


# --------------------------------------------------- a reference .ckpt file

@pytest.fixture(scope="module")
def ckpt_run(tmp_path_factory):
    return inference_pair(dict(TINY, mrf_pallas=True, **REFERENCE_STYLE),
                          PHONES,
                          dict(REQUEST, ref_audio=_clip()),
                          ckpt_dir=str(tmp_path_factory.mktemp("ref")))


def test_reference_ckpt_durations_and_uv_exact(ckpt_run):
    ret, tret = ckpt_run["ret"], ckpt_run["tret"]
    assert ckpt_run["noise"].draws == []
    mel2ph = np.asarray(ret["mel2ph"])
    assert (mel2ph > 0).sum() > 8
    np.testing.assert_array_equal(to_np(tret["mel2ph"]), mel2ph)
    uv = np.asarray(ret["pitch_pred"])[..., 1] > 0
    np.testing.assert_array_equal(to_np(tret["pitch_pred"])[..., 1] > 0, uv)


def test_reference_ckpt_infer_matches_jax(ckpt_run):
    """``forward_model`` (``infer_once`` on JAX's preprocessed request,
    which ``test_torch_slice.py`` holds apart) after ``load_params`` of the
    file, against JAX's ``StyleSingerInfer`` after ``load_params`` of it."""
    ti, ret = ckpt_run["ti"], ckpt_run["ret"]
    tb = {k: torch.as_tensor(v) for k, v in ckpt_run["jax_batch"].items()}
    noise = Replay(ckpt_run["draws"])
    out = ti.forward_model(tb, noise=noise)
    assert noise.draws == []
    n = int((np.asarray(ret["mel2ph"]) > 0).sum())
    hop = ckpt_run["cfg"]["hop_size"]
    wav = np.asarray(ckpt_run["wav"])[0, : n * hop]
    assert out["wav"].shape == wav.shape and np.abs(wav).max() > 1e-3
    np.testing.assert_allclose(out["wav"], wav, atol=ATOL, rtol=0)
    for key, want in (("mel", ret["mel_out"]), ("f0", ret["f0_denorm"])):
        np.testing.assert_allclose(out[key], np.asarray(want)[0, :n],
                                   atol=ATOL, rtol=0, err_msg=key)


# ------------------------------------------------ work dirs and TrainStates

def test_load_params_of_a_work_dir_is_the_trainers_latest_state(trained):
    infer = StyleSingerInfer(trained["cfg"], device="cpu")
    assert len(infer.ph_encoder) == VOCAB  # the corpus's phone_set.json
    infer.load_params(str(trained["work"]))
    assert sorted(os.listdir(trained["work"] / "ckpt")) == [
        "model_ckpt_steps_1.pt", "model_ckpt_steps_2.pt"]
    assert _same(infer.model, trained["state"].model)
    other = StyleSingerInfer(trained["cfg"], device="cpu")
    other.load_params(trained["state"])
    assert _same(other.model, trained["state"].model)


def test_load_params_refuses_a_work_dir_without_a_checkpoint(tmp_path):
    infer = StyleSingerInfer(tiny_test_config(**TINY), phone_list=PHONES,
                             device="cpu")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        infer.load_params(str(tmp_path))
    assert not (tmp_path / "ckpt").exists()
    (tmp_path / "ckpt").mkdir()
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        infer.load_params(str(tmp_path))


def test_load_params_not_clobbered_by_infer(trained):
    """The JAX regression (``tests/test_pipeline.py``): ``load_params``
    followed by inference keeps the loaded weights, the same tensors with
    the same values."""
    infer = StyleSingerInfer(trained["cfg"], device="cpu")
    infer.load_params(trained["state"])
    before = {k: (v, v.clone()) for k, v in infer.model.state_dict(
        keep_vars=True).items()}
    out = infer.infer_once(dict(
        ph="p1 p2 p3", notes=[60, 62, 64], notes_duration=[0.2] * 3,
        note_types=[1] * 3, ref_audio=_clip(0.5)))
    assert np.isfinite(out).all()
    after = infer.model.state_dict(keep_vars=True)
    for k, (tensor, value) in before.items():
        assert after[k] is tensor and torch.equal(after[k], value), k


# --------------------------------------------- vocoder_ckpt and GE2E paths

def _ge2e_file(path: Path, seed: int) -> str:
    torch.manual_seed(seed)
    torch.save({"model_state": ReferenceGE2E().state_dict(), "step": 1},
               path)
    return str(path)


def test_vocoder_and_encoders_load_as_jax_loads_them(tmp_path):
    paths = dict(vocoder_ckpt=write_reference_dir(
        str(tmp_path / "voc"), jax_tiny(**TINY)),
        speaker_encoder_path=_ge2e_file(tmp_path / "pretrained.pt", 1),
        emotion_encoder_path=_ge2e_file(tmp_path / "global.pt", 2))
    ji = JaxInfer(jax_tiny(**TINY, **paths), phone_list=PHONES)
    ji._init_vocoder()
    ji._init_encoders()
    infer = StyleSingerInfer(tiny_test_config(**TINY, **paths),
                             phone_list=PHONES, device="cpu")
    for module, variables in ((infer.vocoder, ji.voc_variables),
                              (infer.spk_encoder, ji.spk_variables),
                              (infer.emo_encoder, ji.emo_variables)):
        want = from_jax_params(variables)
        got = module.state_dict()
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(got[k], v), k
    # init_random keeps the weights that came from the configured files
    assert infer.from_files == {"vocoder", "spk_encoder", "emo_encoder"}
    loaded = [{k: v.clone() for k, v in m.state_dict().items()}
              for m in infer.modules()[1:]]
    infer.init_random(5)
    for m, sd in zip(infer.modules()[1:], loaded):
        assert all(torch.equal(v, sd[k]) for k, v in m.state_dict().items())


def test_vocoder_ckpt_reads_the_ports_generator_file(tmp_path):
    gen = HifiGanGenerator(tiny_test_config(**TINY))
    init_random_(gen, torch.Generator().manual_seed(3), conv_std=0.05)
    torch.save(gen.state_dict(), tmp_path / "generator.pt")
    infer = StyleSingerInfer(tiny_test_config(
        vocoder_ckpt=str(tmp_path / "generator.pt"), **TINY),
        phone_list=PHONES, device="cpu")
    assert _same(infer.vocoder, gen)


def test_missing_paths_warn_as_jax_and_keep_random_weights(tmp_path,
                                                          capsys):
    paths = dict(speaker_encoder_path=str(tmp_path / "nope_spk.pt"),
                 emotion_encoder_path=str(tmp_path / "nope_emo.pt"))
    JaxInfer(jax_tiny(**TINY, **paths), phone_list=PHONES)._init_encoders()
    jax_lines = capsys.readouterr().out.splitlines()
    cfg = tiny_test_config(vocoder_ckpt=str(tmp_path / "nope_voc"), **TINY,
                           **paths)
    infer = StyleSingerInfer(cfg, phone_list=PHONES, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert len(jax_lines) == 2 and all(line in lines for line in jax_lines)
    assert f"| WARN: vocoder_ckpt {tmp_path / 'nope_voc'} not found; " \
        "using random vocoder weights" in lines
    infer.init_random(5)
    assert capsys.readouterr().out == ""  # each missing path warns once
    assert infer.from_files == set()
    plain = StyleSingerInfer(tiny_test_config(**TINY), phone_list=PHONES,
                             device="cpu")
    plain.init_random(5)
    for a, b in zip(infer.modules(), plain.modules()):
        assert _same(a, b)


# ----------------------------------------------------------- run.py infer

def _read_pcm(path):
    with wave.open(path, "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def test_run_infer_sings_from_the_latest_checkpoint(trained, tmp_path):
    ref = str(tmp_path / "ref.wav")
    save_wav(_clip(), ref, 48000)
    out = str(tmp_path / "out.wav")
    assert run.main(["infer", "--hparams", trained["hparams"], "--ref_audio",
                     ref, "--out", out, "--device", "cpu", "--exp_name",
                     "tiny", "--work_dir_root",
                     str(trained["root"] / "ckpts")]) == 0
    infer = StyleSingerInfer(trained["cfg"], device="cpu")
    infer.load_params(trained["state"])
    wav = infer.infer_once(dict(run.EXAMPLE, ref_audio=ref))
    assert wav.shape[0] > 0
    np.testing.assert_array_equal(
        _read_pcm(out), (np.clip(wav, -1, 1) * 32767.0).astype(np.int16))


def test_run_infer_refuses_without_a_checkpoint(trained, tmp_path, capsys):
    ref = str(tmp_path / "ref.wav")
    save_wav(_clip(), ref, 48000)
    args = ["infer", "--hparams", trained["hparams"], "--ref_audio", ref,
            "--device", "cpu", "--exp_name", "tiny", "--work_dir_root"]
    out = str(tmp_path / "out.wav")
    assert run.main(args + [str(tmp_path / "none"), "--out", out]) == 2
    assert "--allow_random" in capsys.readouterr().err
    assert not os.path.exists(out)
    assert run.main(args + [str(tmp_path / "none"), "--out", out,
                            "--allow_random"]) == 0
    assert os.path.exists(out)
    # a work dir whose ckpt/ holds no step refuses even so
    (tmp_path / "empty" / "tiny" / "ckpt").mkdir(parents=True)
    assert run.main(args + [str(tmp_path / "empty"), "--out", out,
                            "--allow_random"]) == 2
    assert "no checkpoint" in capsys.readouterr().err
