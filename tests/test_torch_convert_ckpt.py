"""Reference checkpoints into the port, against the JAX package's
converters, on the CPU.

``tests/torch_parity.py::reference_stylesinger_sd`` writes a ``StyleSinger``
state dict in the reference (AaronZ345/StyleSinger) layout from seeded flax
weights, by inverting the JAX converter's layout rules, so no reference
checkout is needed.  The JAX converter reads every key of it and gives the
tree of the JAX model's init; the port's copy of the converter gives the
same tree exactly, which ``from_jax_params`` loads into the port's model.
The GE2E loaders read the reference's ``{"model_state": sd}`` wrapper, a
bare state dict and a pickled module as the JAX loader does, and the
loaded encoder embeds an utterance as JAX's does at atol 2e-4 / rtol 2e-3.
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn as nn

import stylesinger_tpu.convert as jcv
from stylesinger_tpu.config import tiny_test_config
from stylesinger_tpu.inference import StyleSingerInfer as JaxInfer
from stylesinger_tpu.models.encoders import UtteranceEncoder as JaxEncoder
from torch_parity import acoustic_variables, reference_stylesinger_sd

import stylesinger_torch.convert as tcv
from stylesinger_torch.config import tiny_test_config as torch_tiny
from stylesinger_torch.models.encoders import UtteranceEncoder
from stylesinger_torch.models.stylesinger import StyleSinger

PHONES = list("abcdefg")
# the reference's style adaptor: 4 WaveNet layers and 5 conv blocks, which
# the JAX converter takes as fixed
REFERENCE_STYLE = dict(style_wn_layers=4, style_conv_dilations=(1,) * 5)
CONFIGS = {
    # the style encoder's channel norms as gamma/beta
    "gmdiff_diffsinger": (dict(), "gamma"),
    # ... and as weight/bias
    "conv_fft": (dict(f0_gen="conv", decoder="fft"), "weight"),
}


def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def case(request):
    over, norm = CONFIGS[request.param]
    kw = dict(REFERENCE_STYLE, **over)
    cfg = tiny_test_config(**kw)
    av = acoustic_variables(JaxInfer(cfg, phone_list=PHONES), seed=5)
    sd = reference_stylesinger_sd(av, channel_norm=norm)
    return dict(cfg=cfg, kw=kw, av=av, sd=sd,
                jv=jcv.convert_stylesinger(sd, cfg))


def test_jax_converter_reads_the_written_sd_into_the_init_tree(case):
    """The written state dict holds the reference layout: JAX's converter
    gives the tree of the JAX model's init, with its values up to the
    weight norm's rounding, and every key of the file reaches that tree."""
    init, got = _paths(case["av"]), _paths(case["jv"])
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in init.items()}
    for k, v in init.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    for key, value in case["sd"].items():
        poisoned = dict(case["sd"], **{key: torch.full_like(value, np.nan)})
        leaves = _paths(jcv.convert_stylesinger(poisoned, case["cfg"]))
        assert any(np.isnan(v).any() for v in leaves.values()), key


def test_port_converter_equals_jax(case):
    """The port's ``convert_stylesinger`` builds JAX's tree exactly, and
    ``from_jax_params`` of it loads into the port's model, every key."""
    tv = _paths(tcv.convert_stylesinger(case["sd"], torch_tiny(**case["kw"])))
    jv = _paths(case["jv"])
    assert tv.keys() == jv.keys()
    for k, v in jv.items():
        np.testing.assert_array_equal(tv[k], v, err_msg=k)
    model = StyleSinger(torch_tiny(**case["kw"]), len(PHONES) + 3)
    model.load_state_dict(tcv.from_jax_params(case["jv"]))


def test_load_torch_checkpoint_reads_the_model_child(case, tmp_path):
    path = str(tmp_path / "model_ckpt_steps_100.ckpt")
    torch.save({"state_dict": {"model": case["sd"]}, "global_step": 100},
               path)
    port, jax_sd = tcv.load_torch_checkpoint(path), \
        jcv.load_torch_checkpoint(path)
    assert port.keys() == jax_sd.keys() == case["sd"].keys()
    for k, v in case["sd"].items():
        assert torch.equal(port[k], v) and torch.equal(jax_sd[k], v), k


class ReferenceGE2E(nn.Module):
    """The GE2E encoder's layout (the reference's emotion encoder and
    resemblyzer's ``VoiceEncoder``): a 3-layer LSTM(40 -> 256) and a
    linear head."""

    def __init__(self):
        super().__init__()
        self.lstm = nn.LSTM(40, 256, 3, batch_first=True)
        self.linear = nn.Linear(256, 256)


def _utterance(seconds=2.0, sr=16000):
    rng = np.random.default_rng(11)
    t = np.arange(int(seconds * sr)) / sr
    wav = 0.3 * np.sin(2 * np.pi * 180 * t + 2 * np.sin(2 * np.pi * 3 * t))
    return (wav + 0.01 * rng.standard_normal(t.shape)).astype(np.float32)


def _ge2e_reference():
    torch.manual_seed(3)
    ref = ReferenceGE2E()
    with torch.no_grad():  # both biases matter: torch adds them
        for name, p in ref.lstm.named_parameters():
            if name.startswith("bias"):
                p.normal_(0.0, 0.2)
    return ref


@pytest.mark.parametrize("layout", ["model_state", "bare", "module"])
def test_ge2e_loader_matches_jax(layout, tmp_path):
    """The reference's ``{"model_state": sd, "step": N}`` wrapper, a bare
    state dict and a pickled module load as JAX's loader loads them."""
    ref = _ge2e_reference()
    payload = {"model_state": ref.state_dict(), "step": 1000,
               "bare": ref.state_dict(), "module": ref}
    path = str(tmp_path / "global.pt")
    torch.save(payload if layout == "model_state" else payload[layout],
               path)
    sd = tcv.from_jax_params(tcv.load_ge2e_checkpoint(path))
    want = tcv.from_jax_params(jax.tree_util.tree_map(
        np.asarray, jcv.load_ge2e_checkpoint(path)))
    assert sd.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(sd[k], v), k


def test_ge2e_loaded_encoder_embeds_as_jax(tmp_path):
    """The loaded encoder's speaker (projected) and emotion (raw)
    embeddings of one utterance against JAX's on its loaded variables."""
    path = str(tmp_path / "global.pt")
    torch.save({"model_state": _ge2e_reference().state_dict()}, path)
    jvars = jcv.load_ge2e_checkpoint(path)
    enc = UtteranceEncoder()
    enc.load_state_dict(tcv.from_jax_params(tcv.load_ge2e_checkpoint(path)))
    wav = _utterance()
    for project in (True, False):
        np.testing.assert_allclose(
            enc.embed_utterance(wav, project=project),
            np.asarray(JaxEncoder().embed_utterance(jvars, wav,
                                                    project=project)),
            atol=2e-4, rtol=2e-3)
