"""``python -m stylesinger_torch.convert`` against the JAX package's
converters, on the CPU.

A reference ``model_ckpt_steps_N.ckpt`` (its ``model`` child written by
``tests/torch_parity.py::reference_stylesinger_sd`` from seeded flax
weights, its ``model_gen`` child by ``tests/test_torch_vocoder_ckpt.py``)
goes through the CLI into the port's own layout; ``load_params`` on the
written work dir, and ``vocoder_ckpt`` on the written ``generator.pt``,
give exactly what the port's model holds after ``from_jax_params`` of
JAX's ``convert_stylesinger`` / ``convert_hifigan`` on the same state
dicts.
"""

import os
import subprocess
import sys
from pathlib import Path

import torch

import stylesinger_tpu.convert as jcv
from stylesinger_tpu.config import tiny_test_config
from stylesinger_tpu.inference import StyleSingerInfer as JaxInfer
from test_torch_convert_ckpt import PHONES, REFERENCE_STYLE
from reference_layout import flax_tree
from test_torch_vocoder_ckpt import reference_generator_sd
from torch_parity import acoustic_variables, reference_stylesinger_sd

from stylesinger_torch.config import (
    load_work_dir_config, save_config, tiny_test_config as torch_tiny,
)
from stylesinger_torch.convert import (
    convert_stylesinger, from_jax_params, main,
)
from stylesinger_torch.inference import StyleSingerInfer, init_random_
from stylesinger_torch.models.stylesinger import StyleSinger
from stylesinger_torch.vocoder_infer import GENERATOR_FILE, HifiGAN_NSF

REPO = Path(__file__).resolve().parents[1]


def _assert_same(state, ref):
    assert set(state) == set(ref)
    for k, v in ref.items():
        assert torch.equal(state[k].cpu(), v), k


def test_convert_cli_round_trip(tmp_path):
    cfg = tiny_test_config(**REFERENCE_STYLE)
    tcfg = torch_tiny(**REFERENCE_STYLE)
    sd = reference_stylesinger_sd(acoustic_variables(
        JaxInfer(cfg, phone_list=PHONES), seed=5))
    gen_sd = reference_generator_sd(tcfg, 1)
    ckpt = str(tmp_path / "model_ckpt_steps_1200.ckpt")
    torch.save({"state_dict": {"model": sd, "model_gen": gen_sd},
                "global_step": 1200}, ckpt)
    cfg_path = save_config(tcfg, str(tmp_path / "recipe"))

    out = tmp_path / "work"
    main([ckpt, str(out), "--config", cfg_path])
    assert (out / "ckpt" / "model_ckpt_steps_1200.pt").exists()
    wcfg = load_work_dir_config(str(out))
    assert {k: list(wcfg[k]) for k in ("style_conv_dilations",
                                        "upsample_rates")} == {
        k: list(tcfg[k]) for k in ("style_conv_dilations", "upsample_rates")}
    assert wcfg["style_wn_layers"] == 4
    ti = StyleSingerInfer(wcfg, phone_list=PHONES, device="cpu")
    ti.load_params(str(out))
    _assert_same(ti.model.state_dict(),
                 from_jax_params(jcv.convert_stylesinger(sd, cfg)))

    voc = tmp_path / "voc"   # the module entry point, in a process of its own
    subprocess.run([sys.executable, "-m", "stylesinger_torch.convert", ckpt,
                    str(voc), "--config", cfg_path, "--hifigan"], check=True,
                   cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
                   timeout=300)
    wrapper = HifiGAN_NSF(torch_tiny(**REFERENCE_STYLE, vocoder_ckpt=str(
        voc / GENERATOR_FILE)), device="cpu")
    _assert_same(wrapper.model.state_dict(),
                 from_jax_params(jcv.convert_hifigan(gen_sd, cfg)))


def test_a_port_model_writes_a_reference_checkpoint_without_jax():
    """What ``chip_smoke.py``'s ``convert cli`` phase does without JAX:
    ``flax_tree`` inverts ``from_jax_params`` exactly, and the reference
    state dict written from it converts back to the model's weights (the
    style WaveNet's weight norm within f32 rounding)."""
    tcfg = torch_tiny()
    model = StyleSinger(tcfg, 20)
    init_random_(model, torch.Generator().manual_seed(3))
    state = model.state_dict()
    _assert_same(state, from_jax_params(flax_tree(model)))
    back = from_jax_params(convert_stylesinger(
        reference_stylesinger_sd(flax_tree(model)), tcfg))
    assert set(back) == set(state)
    for k, v in back.items():
        torch.testing.assert_close(v, state[k], rtol=1e-6, atol=1e-7)
