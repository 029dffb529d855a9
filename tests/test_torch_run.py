"""The port's ``infer`` command on the CPU at a tiny setting."""

import json
import wave

import numpy as np
import pytest
import torch

from stylesinger_torch import run
from stylesinger_torch.config import (
    load_config, parse_hparams, tiny_test_config,
)
from stylesinger_torch.dsp.mel import save_wav
from stylesinger_torch.inference import StyleSingerInfer


def _tiny_hparams():
    """--hparams that turn the defaults into tiny_test_config (hop 64, the
    tiny vocoder's upsampling), with the fast samplers."""
    tiny = tiny_test_config(hop_size=64, mrf_block=64, f0_timesteps=10,
                            f0_speedup=5, timesteps=10, K_step=10,
                            dpm_steps=3)
    base = load_config()

    def text(v):
        return json.dumps(v) if isinstance(v, (list, tuple)) else str(v)
    return ",".join(f"{k}={text(v)}" for k, v in tiny.items()
                    if json.dumps(v) != json.dumps(base[k]))


@pytest.fixture
def ref_wav(tmp_path):
    t = np.arange(48000) / 48000
    path = str(tmp_path / "ref.wav")
    save_wav(0.3 * np.sin(2 * np.pi * 220 * t), path, 48000)
    return path


def test_infer_writes_the_example_wav(tmp_path, ref_wav):
    out = str(tmp_path / "out" / "test.wav")
    hparams = _tiny_hparams()
    assert run.main(["infer", "--hparams", hparams, "--ref_audio", ref_wav,
                     "--out", out, "--allow_random", "--device", "cpu"]) == 0
    with wave.open(out, "rb") as w:
        n, sr = w.getnframes(), w.getframerate()
    # the same seeded weights and input, run directly
    infer = StyleSingerInfer(load_config(**parse_hparams(hparams)),
                             device="cpu")
    infer.init_random()
    frames = infer.forward_model(infer.preprocess_input(
        dict(run.EXAMPLE, ref_audio=ref_wav)))["mel"].shape[0]
    assert sr == 48000 and frames > 0 and n == frames * 64


def test_infer_refuses_random_weights_without_allow_random(tmp_path,
                                                           ref_wav, capsys):
    out = str(tmp_path / "test.wav")
    assert run.main(["infer", "--ref_audio", ref_wav, "--out", out,
                     "--device", "cpu", "--hparams", _tiny_hparams()]) == 2
    assert "--allow_random" in capsys.readouterr().err
    assert not (tmp_path / "test.wav").exists()


def test_infer_on_cuda_raises_without_a_gpu(tmp_path, ref_wav):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        run.main(["infer", "--ref_audio", ref_wav, "--allow_random",
                  "--out", str(tmp_path / "x.wav"), "--hparams",
                  _tiny_hparams()])
