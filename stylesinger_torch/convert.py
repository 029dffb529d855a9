"""flax parameter tree -> ``state_dict`` of the port's modules.

The port's modules carry the flax names of the JAX modules, so the walk is
generic.  Layout rules (flax -> torch):

- ``Dense`` kernel [in, out]               -> Linear weight [out, in]
- ``Conv`` kernel [k, in, out]             -> conv weight [out, in, k]
  (grouped: [k, in / g, out]                  -> [out, in / g, k])
- 2-D ``Conv`` kernel [kh, kw, in, out]     -> Conv2d weight [out, in, kh, kw]
- ``ConvTranspose`` kernel [k, out, in]    -> ConvTranspose1d weight
  (``transpose_kernel=True``)                 [in, out, k]
- ``LayerNorm`` scale / ``Embed`` embedding -> weight
- ``OptimizedLSTMCell`` ``lstm_<l>/{ii,if,ig,io,hi,hf,hg,ho}`` ->
  ``nn.LSTM`` ``weight_ih_l<l>`` / ``weight_hh_l<l>`` (gates i, f, g, o),
  the hidden-side bias as ``bias_hh_l<l>`` and a zero ``bias_ih_l<l>``.
- the ``codebook`` collection's leaves (``embedding``, ``cluster_size_ema``,
  ``embed_ema``) -> the RQ codebooks' buffers of the same names, as they
  are, so that training resumes from the converted EMA statistics.

The LayerNorm eps differs between flax (1e-6) and torch (1e-5); the port
builds every LayerNorm with eps=1e-6.

A reference (AaronZ345/StyleSinger) checkpoint reaches the port through the
JAX package's converters, copied here: :func:`load_torch_checkpoint` reads a
``model_ckpt_steps_N.ckpt``; :func:`convert_stylesinger` (the acoustic
model), :func:`convert_hifigan` (the NSF HiFi-GAN, weight norm ``g * v /
||v||`` folded), :func:`convert_ge2e_encoder` (a GE2E d-vector encoder,
:func:`load_ge2e_checkpoint`), :func:`convert_pwg` and
:func:`convert_melgan` (the Parallel WaveGAN and MelGAN generators, read by
:func:`load_pwg_checkpoint` / :func:`load_melgan_checkpoint` from an
official ParallelWaveGAN checkpoint or a reference task checkpoint) build
the flax tree of the JAX module from the torch ``state_dict``, and
:func:`from_jax_params` maps that tree to the port module's
``state_dict``.

``python -m stylesinger_torch.convert <model.ckpt> <out_dir> [--config
path] [--hifigan]`` writes a reference checkpoint in the port's own layout
(:func:`main`).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

_GATES = "ifgo"


def _leaves(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _lstm(prefix: str, layer: int, cell: Mapping) -> Dict[str, np.ndarray]:
    def cat(side, leaf):
        return np.concatenate([np.asarray(cell[f"{side}{g}"][leaf]).T
                               if leaf == "kernel"
                               else np.asarray(cell[f"{side}{g}"][leaf])
                               for g in _GATES], axis=0)

    b_hh = cat("h", "bias")
    return {f"{prefix}lstm.weight_ih_l{layer}": cat("i", "kernel"),
            f"{prefix}lstm.weight_hh_l{layer}": cat("h", "kernel"),
            f"{prefix}lstm.bias_ih_l{layer}": np.zeros_like(b_hh),
            f"{prefix}lstm.bias_hh_l{layer}": b_hh}


def _convert_params(params: Mapping, prefix: str = ""
                    ) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for name, value in params.items():
        if isinstance(value, Mapping) and name.startswith("lstm_") \
                and "ii" in value:
            out.update(_lstm(prefix, int(name.split("_")[1]), value))
        elif isinstance(value, Mapping):
            out.update(_convert_params(value, f"{prefix}{name}."))
        else:
            a = np.asarray(value, np.float32)
            if name == "kernel":
                out[f"{prefix}weight"] = a.transpose(
                    {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}[a.ndim])
            elif name in ("scale", "embedding"):
                out[f"{prefix}weight"] = a
            else:
                out[f"{prefix}{name}"] = a
    return out


def from_jax_params(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``variables`` ({'params': ..., 'codebook': ...}) or a bare
    params tree, as numpy arrays -> a ``state_dict`` for ``StyleSinger``,
    ``HifiGanGenerator`` or ``UtteranceEncoder``."""
    is_collections = "params" in variables or "codebook" in variables
    params = variables.get("params", {}) if is_collections else variables
    sd = _convert_params(params)
    for name, value in _leaves(variables.get("codebook", {})):
        sd[name] = np.asarray(value, np.float32)
    return {k: torch.tensor(np.ascontiguousarray(v))
            for k, v in sd.items()}


# ---------------------------------------------------------------------------
# Reference torch checkpoints (copy of stylesinger_tpu/convert.py:29-437,
# :648-657): torch state_dict -> flax tree
# ---------------------------------------------------------------------------

def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


def lin(sd: Mapping, name: str, bias: bool = True) -> Dict:
    out = {"kernel": _np(sd[f"{name}.weight"]).T}
    if bias and f"{name}.bias" in sd:
        out["bias"] = _np(sd[f"{name}.bias"])
    return out


def conv1d(sd: Mapping, name: str) -> Dict:
    out = {"kernel": _np(sd[f"{name}.weight"]).transpose(2, 1, 0)}
    if f"{name}.bias" in sd:
        out["bias"] = _np(sd[f"{name}.bias"])
    return out


def _fold_weight_norm(sd: Mapping, name: str) -> np.ndarray:
    """torch ``weight_norm(dim=0)``: g * v / ||v||, the norm over every
    axis but the first."""
    g = _np(sd[f"{name}.weight_g"])
    v = _np(sd[f"{name}.weight_v"])
    norm = np.sqrt((v ** 2).sum(axis=(1, 2), keepdims=True))
    return g * v / np.maximum(norm, 1e-12)


def conv1d_wn(sd: Mapping, name: str) -> Dict:
    """Weight-normed Conv1d (or one already folded) -> flax Conv."""
    if f"{name}.weight" in sd:
        return conv1d(sd, name)
    out = {"kernel": _fold_weight_norm(sd, name).transpose(2, 1, 0)}
    if f"{name}.bias" in sd:
        out["bias"] = _np(sd[f"{name}.bias"])
    return out


def convT1d_wn(sd: Mapping, name: str) -> Dict:
    """Weight-normed ConvTranspose1d [in, out, k] -> flax kernel
    [k, out, in]: weight_norm's first axis is the input channels here."""
    w = _np(sd[f"{name}.weight"]) if f"{name}.weight" in sd \
        else _fold_weight_norm(sd, name)
    out = {"kernel": w.transpose(2, 1, 0)}
    if f"{name}.bias" in sd:
        out["bias"] = _np(sd[f"{name}.bias"])
    return out


def ln(sd: Mapping, name: str) -> Dict:
    return {"scale": _np(sd[f"{name}.weight"]),
            "bias": _np(sd[f"{name}.bias"])}


def emb(sd: Mapping, name: str) -> Dict:
    return {"embedding": _np(sd[f"{name}.weight"])}


def convert_enc_sa_layer(sd: Mapping, p: str) -> Dict:
    """Reference ``EncSALayer``: the fused ``in_proj_weight`` [3c, c] is the
    qkv Dense kernel [c, 3c].  ``p`` like 'layers.0.op'."""
    return {
        "LayerNorm_0": ln(sd, f"{p}.layer_norm1"),
        "MultiheadSelfAttention_0": {
            "qkv": {"kernel": _np(sd[f"{p}.self_attn.in_proj_weight"]).T},
            "out": {"kernel": _np(sd[f"{p}.self_attn.out_proj.weight"]).T},
        },
        "LayerNorm_1": ln(sd, f"{p}.layer_norm2"),
        "TransformerFFN_0": {
            "Conv_0": conv1d(sd, f"{p}.ffn.ffn_1"),
            "LambdaDense_0": {"Dense_0": lin(sd, f"{p}.ffn.ffn_2")},
        },
    }


def convert_fft_blocks(sd: Mapping, prefix: str, num_layers: int,
                       use_pos_embed: bool = True,
                       use_last_norm: bool = True) -> Dict:
    """Reference ``FFTBlocks``: the layers, the positional scale and the
    last LayerNorm where the checkpoint has them."""
    sd = {k[len(prefix):]: v for k, v in sd.items()
          if k.startswith(prefix)}
    out: Dict[str, Any] = {}
    for i in range(num_layers):
        out[f"layer_{i}"] = convert_enc_sa_layer(sd, f"layers.{i}.op")
    if use_pos_embed and "pos_embed_alpha" in sd:
        out["pos_embed_alpha"] = _np(sd["pos_embed_alpha"])
    if use_last_norm and "layer_norm.weight" in sd:
        out["LayerNorm_0"] = ln(sd, "layer_norm")
    return out


def convert_fastspeech_encoder(sd: Mapping, prefix: str,
                               num_layers: int) -> Dict:
    return {"embed_tokens": emb(sd, f"{prefix}embed_tokens"),
            "blocks": convert_fft_blocks(sd, prefix, num_layers,
                                         use_pos_embed=False)}


def _convert_conv_predictor(sd: Mapping, prefix: str, n_layers: int
                            ) -> Dict:
    """``conv.<i>`` = Sequential [pad, Conv1d, ReLU, LayerNorm, Dropout],
    then ``linear``."""
    out: Dict[str, Any] = {}
    for i in range(n_layers):
        out[f"conv_{i}"] = conv1d(sd, f"{prefix}conv.{i}.1")
        out[f"ln_{i}"] = ln(sd, f"{prefix}conv.{i}.3")
    out["out"] = lin(sd, f"{prefix}linear")
    return out


def convert_duration_predictor(sd: Mapping, prefix: str,
                               n_layers: int = 2) -> Dict:
    return _convert_conv_predictor(sd, prefix, n_layers)


def convert_pitch_predictor(sd: Mapping, prefix: str,
                            n_layers: int = 5) -> Dict:
    out = _convert_conv_predictor(sd, prefix, n_layers)
    if f"{prefix}pos_embed_alpha" in sd:
        out["pos_embed_alpha"] = _np(sd[f"{prefix}pos_embed_alpha"])
    return out


def convert_wn(sd: Mapping, prefix: str, n_layers: int = 4,
               has_cond: bool = False) -> Dict:
    out: Dict[str, Any] = {}
    for i in range(n_layers):
        out[f"in_{i}"] = conv1d_wn(sd, f"{prefix}in_layers.{i}")
        out[f"res_skip_{i}"] = conv1d_wn(sd, f"{prefix}res_skip_layers.{i}")
    if has_cond:
        out["cond"] = conv1d_wn(sd, f"{prefix}cond_layer")
    return out


def _channel_norm(sd: Mapping, name: str) -> Dict:
    """A channel LayerNorm stored as ``gamma``/``beta`` [1, C, 1] or as
    ``weight``/``bias``: flax's flat (scale, bias)."""
    scale = sd.get(f"{name}.gamma", sd.get(f"{name}.weight"))
    bias = sd.get(f"{name}.beta", sd.get(f"{name}.bias"))
    return {"scale": _np(scale).reshape(-1), "bias": _np(bias).reshape(-1)}


def convert_conv_blocks(sd: Mapping, prefix: str, n_dilations: int = 5,
                        n_inner: int = 2) -> Dict:
    """Reference ``ConvBlocks`` of the style encoder:
    ``res_blocks.<i>.blocks.<j>`` = Sequential [LayerNorm(dim=1),
    Conv1d(c -> 2c), Lambda, GELU, Conv1d(2c -> c, 1)]."""
    out: Dict[str, Any] = {}
    for i in range(n_dilations):
        res: Dict[str, Any] = {}
        for j in range(n_inner):
            base = f"{prefix}res_blocks.{i}.blocks.{j}"
            res[f"ln_{j}"] = _channel_norm(sd, f"{base}.0")
            res[f"conv_a_{j}"] = conv1d(sd, f"{base}.1")
            res[f"conv_b_{j}"] = conv1d(sd, f"{base}.4")
        out[f"res_{i}"] = res
    out["last_norm"] = _channel_norm(sd, f"{prefix}last_norm")
    out["post"] = conv1d(sd, f"{prefix}post_net1")
    return out


def convert_rq(sd: Mapping, prefix: str, depth: int = 4) -> Dict:
    """Reference ``RQBottleneck`` -> the codebook collection: each
    codebook's last (padding) row is cut off; the EMA buffers as they
    are."""
    codebook: Dict[str, Any] = {}
    for i in range(depth):
        cb = f"{prefix}codebooks.{i}"
        codebook[f"codebook_{i}"] = {
            "embedding": _np(sd[f"{cb}.weight"])[:-1],
            "cluster_size_ema": _np(sd[f"{cb}.cluster_size_ema"]),
            "embed_ema": _np(sd[f"{cb}.embed_ema"]),
        }
    return codebook


def convert_cross_atten_layer(sd: Mapping, p: str) -> Dict:
    """Reference ``CrossAttenLayer``: torch ``nn.MultiheadAttention`` (its
    ``in_proj`` split into q, k, v) + a post-norm FFN."""
    w = _np(sd[f"{p}.multihead_attn.in_proj_weight"])  # [3c, c]
    b = _np(sd[f"{p}.multihead_attn.in_proj_bias"])    # [3c]
    c = w.shape[1]
    mha = {name: {"kernel": w[i * c:(i + 1) * c].T,
                  "bias": b[i * c:(i + 1) * c]}
           for i, name in enumerate("qkv")}
    mha["out"] = lin(sd, f"{p}.multihead_attn.out_proj")
    return {"mha": mha, "linear1": lin(sd, f"{p}.linear1"),
            "linear2": lin(sd, f"{p}.linear2"),
            "norm1": ln(sd, f"{p}.norm1"), "norm2": ln(sd, f"{p}.norm2")}


def convert_prosody_aligner(sd: Mapping, prefix: str,
                            num_layers: int = 2) -> Dict:
    return {f"layer_{i}": convert_cross_atten_layer(sd, f"{prefix}layers.{i}")
            for i in range(num_layers)}


def convert_local_style_adaptor(sd: Mapping, prefix: str, *,
                                rq_depth: int = 4, wn_layers: int = 4,
                                n_dilations: int = 5):
    """(params, codebook) of the reference ``LocalStyleAdaptor``."""
    params = {
        "wavenet": convert_wn(sd, f"{prefix}wavenet.", n_layers=wn_layers),
        "encoder": convert_conv_blocks(sd, f"{prefix}encoder.",
                                       n_dilations=n_dilations),
    }
    codebook = {"rq": convert_rq(sd, f"{prefix}rqvae.", depth=rq_depth)}
    return params, codebook


def convert_umln(sd: Mapping, prefix: str) -> Dict:
    return {"affine": lin(sd, f"{prefix}affine_layer.linear_layer")}


def _convert_diff_residual(sd: Mapping, p: str) -> Dict:
    return {
        "dilated_conv": conv1d(sd, f"{p}.dilated_conv"),
        "diffusion_projection": lin(sd, f"{p}.diffusion_projection"),
        "conditioner_projection": conv1d(sd, f"{p}.conditioner_projection"),
        "output_projection": conv1d(sd, f"{p}.output_projection"),
    }


def convert_diffnet(sd: Mapping, prefix: str, n_layers: int = 20) -> Dict:
    """Reference ``DiffNet`` (the mel denoiser)."""
    out: Dict[str, Any] = {
        "input_projection": conv1d(sd, f"{prefix}input_projection"),
        "mlp": {"fc1": lin(sd, f"{prefix}mlp.0"),
                "fc2": lin(sd, f"{prefix}mlp.2")},
        "skip_projection": conv1d(sd, f"{prefix}skip_projection"),
        "output_projection": conv1d(sd, f"{prefix}output_projection"),
    }
    for i in range(n_layers):
        out[f"residual_{i}"] = _convert_diff_residual(
            sd, f"{prefix}residual_layers.{i}")
    return out


def convert_ddiffnet(sd: Mapping, prefix: str, n_layers: int = 10) -> Dict:
    """Reference ``DDiffNet`` (an F0 denoiser): ``DiffNet`` + ``uv_embed``."""
    out = convert_diffnet(sd, prefix, n_layers)
    out["uv_embed"] = emb(sd, f"{prefix}uv_embed")
    return out


def convert_note_encoder(sd: Mapping, prefix: str) -> Dict:
    return {"emb": emb(sd, f"{prefix}emb"),
            "type_emb": emb(sd, f"{prefix}type_emb"),
            "dur_ln": lin(sd, f"{prefix}dur_ln")}


def convert_stylesinger(sd: Mapping, cfg: Any) -> Dict:
    """Reference ``StyleSinger`` state_dict -> the flax ``variables``
    ({'params': ..., 'codebook': ...}) of the JAX model, for
    :func:`from_jax_params`.  The style adaptor's layer counts come from
    ``style_wn_layers`` / ``style_conv_dilations`` (the reference's 4 and
    5, which the JAX converter fixes)."""
    c = cfg
    params: Dict[str, Any] = {
        "encoder": convert_fastspeech_encoder(sd, "encoder.",
                                              c["enc_layers"]),
        "note_encoder": convert_note_encoder(sd, "note_encoder."),
        "spk_embed_proj": lin(sd, "spk_embed_proj"),
        "dur_predictor": convert_duration_predictor(
            sd, "dur_predictor.", c["dur_predictor_layers"]),
        "pitch_embed": emb(sd, "pitch_embed"),
        "decoder": {"blocks": convert_fft_blocks(
            sd, "decoder.", c["dec_layers"], use_pos_embed=True)},
        "mel_out": lin(sd, "mel_out"),
    }
    codebook: Dict[str, Any] = {}
    if c["emo"]:
        params["emo_embed_proj"] = lin(sd, "emo_embed_proj")
    if c["umln"]:
        params["norm"] = convert_umln(sd, "norm.")
    if c["style"]:
        lsa_p, lsa_cb = convert_local_style_adaptor(
            sd, "style_extractor.", rq_depth=c["rq_depth"],
            wn_layers=c.get("style_wn_layers", 4),
            n_dilations=len(c.get("style_conv_dilations", (1,) * 5)))
        params["style_extractor"] = lsa_p
        codebook["style_extractor"] = lsa_cb
        params["l1"] = lin(sd, "l1")
        params["align"] = convert_prosody_aligner(
            sd, "align.", c["aligner_layers"])
    if c["f0_gen"] == "gmdiff":
        for name in ("gm_diffnet", "gm_diffnet_inpainte"):
            params[name] = convert_ddiffnet(sd, f"{name}.",
                                            c["f0_residual_layers"])
    else:
        for name in ("pitch_predictor", "pitch_inpainter_predictor"):
            params[name] = convert_pitch_predictor(sd, f"{name}.")
    if c["decoder"] == "diffsinger":
        params["ln_proj"] = lin(sd, "ln_proj")
        params["postdiff"] = convert_diffnet(
            sd, "postdiff.denoise_fn.", c["residual_layers"])
    return {"params": params, "codebook": codebook}


def convert_hifigan(sd: Mapping, cfg: Any) -> Dict:
    """Reference NSF ``HifiGanGenerator`` state_dict -> the flax tree of
    the JAX generator ({'params': ...}), for :func:`from_jax_params`."""
    rk = tuple(cfg["resblock_kernel_sizes"])
    rd = tuple(tuple(d) for d in cfg["resblock_dilation_sizes"])
    params: Dict[str, Any] = {
        "conv_pre": conv1d_wn(sd, "conv_pre"),
        "conv_post": conv1d_wn(sd, "conv_post"),
    }
    if any(k.startswith("m_source.") for k in sd):
        params["m_source"] = {"merge": lin(sd, "m_source.l_linear")}
    for i in range(len(cfg["upsample_rates"])):
        params[f"up_{i}"] = convT1d_wn(sd, f"ups.{i}")
        if f"noise_convs.{i}.weight" in sd:
            params[f"noise_conv_{i}"] = conv1d(sd, f"noise_convs.{i}")
        for j in range(len(rk)):
            rb = f"resblocks.{i * len(rk) + j}"
            block: Dict[str, Any] = {}
            for k in range(len(rd[j])):
                block[f"conv1_{k}"] = conv1d_wn(sd, f"{rb}.convs1.{k}")
                block[f"conv2_{k}"] = conv1d_wn(sd, f"{rb}.convs2.{k}")
            params[f"resblock_{i}_{j}"] = block
    return {"params": params}


def load_torch_checkpoint(path: str, child: Optional[str] = "model",
                          map_location: Any = "cpu"):
    """The flat state_dict of ``child`` in a reference
    ``model_ckpt_steps_N.ckpt`` (its ``state_dict`` entry, by child).  The
    reference pickles more than tensors, so ``weights_only`` is off: load
    only checkpoints from a source you trust."""
    ckpt = torch.load(path, map_location=map_location, weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    if child is not None and child in sd:
        sd = sd[child]
    return dict(sd.items())


def convert_ge2e_lstm(sd: Mapping, prefix: str = "lstm",
                      num_layers: int = 3) -> Dict:
    """torch ``nn.LSTM`` -> the flax ``OptimizedLSTMCell`` stack, one
    ``lstm_<k>`` per layer: the gate rows (i, f, g, o) split per gate, and
    torch's two biases added into flax's one (on the hidden side)."""
    out: Dict[str, Any] = {}
    for layer in range(num_layers):
        w_ih = _np(sd[f"{prefix}.weight_ih_l{layer}"])
        w_hh = _np(sd[f"{prefix}.weight_hh_l{layer}"])
        b = (_np(sd[f"{prefix}.bias_ih_l{layer}"]) +
             _np(sd[f"{prefix}.bias_hh_l{layer}"]))
        h = w_hh.shape[1]
        cell: Dict[str, Any] = {}
        for gi, gate in enumerate(_GATES):
            rows = slice(gi * h, (gi + 1) * h)
            cell[f"i{gate}"] = {"kernel": w_ih[rows].T}
            cell[f"h{gate}"] = {"kernel": w_hh[rows].T, "bias": b[rows]}
        out[f"lstm_{layer}"] = cell
    return out


def convert_ge2e_encoder(sd: Mapping, num_layers: int = 3) -> Dict:
    """GE2E d-vector encoder state_dict (3-layer LSTM(40 -> 256) +
    linear(256 -> 256): the reference's emotion encoder ``global.pt`` and
    resemblyzer's ``VoiceEncoder`` ``pretrained.pt`` alike) -> the flax
    ``UtteranceEncoder`` variables."""
    params = convert_ge2e_lstm(sd, "lstm", num_layers)
    params["proj"] = lin(sd, "linear")
    return {"params": params}


def load_ge2e_checkpoint(path: str, map_location: Any = "cpu") -> Dict:
    """A GE2E encoder checkpoint (.pt) converted to flax variables: the
    ``{"model_state": sd, "step": N}`` wrapper of ``global.pt``, a bare
    state_dict, or a pickled module."""
    ckpt = torch.load(path, map_location=map_location, weights_only=False)
    sd = ckpt.get("model_state", ckpt) if isinstance(ckpt, dict) else ckpt
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return convert_ge2e_encoder(sd)


# ---------------------------------------------------------------------------
# Parallel WaveGAN and MelGAN (copy of stylesinger_tpu/convert.py:440-657)
# ---------------------------------------------------------------------------

def conv2d_time_wn(sd: Mapping, name: str) -> np.ndarray:
    """PWG's upsample smoothing Conv2d(1, 1, (1, K)) (weight-normed or
    folded) -> the time kernel [K, 1, 1]."""
    if f"{name}.weight" in sd:
        w = _np(sd[f"{name}.weight"])
    else:
        g = _np(sd[f"{name}.weight_g"])
        v = _np(sd[f"{name}.weight_v"])
        norm = np.sqrt((v ** 2).sum(axis=(1, 2, 3), keepdims=True))
        w = g * v / np.maximum(norm, 1e-12)
    return w[0, 0, 0][:, None, None]


def convert_pwg(sd: Mapping, layers: int = 30, n_scales: int = 4) -> Dict:
    """Reference ``ParallelWaveGANGenerator`` state_dict (weight-normed or
    folded) -> the flax tree of the JAX ``ParallelWaveGANGenerator``."""
    up: Dict[str, Any] = {"conv_in": conv1d_wn(sd, "upsample_net.conv_in")}
    for i in range(n_scales):
        # up_layers interleaves [Stretch2d, Conv2d]: the conv is at 2i+1
        up[f"up_conv_{i}"] = conv2d_time_wn(
            sd, f"upsample_net.upsample.up_layers.{2 * i + 1}")
    params: Dict[str, Any] = {
        "upsample_net": up,
        "first": conv1d_wn(sd, "first_conv"),
        "post1": conv1d_wn(sd, "last_conv_layers.1"),
        "post2": conv1d_wn(sd, "last_conv_layers.3"),
    }
    if "pitch_embed.weight" in sd:
        params["pitch_embed"] = emb(sd, "pitch_embed")
        params["c_proj"] = lin(sd, "c_proj")
    for i in range(layers):
        p = f"conv_layers.{i}"
        params[f"block_{i}"] = {
            "conv": conv1d_wn(sd, f"{p}.conv"),
            "aux": conv1d_wn(sd, f"{p}.conv1x1_aux"),
            "res": conv1d_wn(sd, f"{p}.conv1x1_out"),
            "skip": conv1d_wn(sd, f"{p}.conv1x1_skip"),
        }
    return {"params": params}


def convert_melgan(sd: Mapping, n_scales: int = 4, stacks: int = 3) -> Dict:
    """Reference ``MelGANGenerator`` state_dict (the non-causal
    ``torch.nn.Sequential`` ``melgan``: [pad, conv_pre], per scale [leaky,
    convT, stack x3], then [leaky, pad, conv_post, tanh]) -> the flax tree
    of the JAX ``MelGANGenerator``."""
    params: Dict[str, Any] = {"conv_pre": conv1d_wn(sd, "melgan.1")}
    idx = 2
    for i in range(n_scales):
        params[f"up_{i}"] = convT1d_wn(sd, f"melgan.{idx + 1}")
        for j in range(stacks):
            p = f"melgan.{idx + 2 + j}"
            params[f"res_{i}_{j}"] = {
                # a stack: Sequential [leaky, pad, conv k, leaky, conv 1x1]
                "conv1": conv1d_wn(sd, f"{p}.stack.2"),
                "conv2": conv1d_wn(sd, f"{p}.stack.4"),
                "skip": conv1d_wn(sd, f"{p}.skip_layer"),
            }
        idx += 2 + stacks
    params["conv_post"] = conv1d_wn(sd, f"melgan.{idx + 2}")
    return {"params": params}


def _generator_sd(ckpt, ckpt_path: str = "<ckpt>"):
    """(generator state_dict, is_official) of a reference task checkpoint
    (``{"state_dict": {"model_gen.*": ...}}``) or an official
    ParallelWaveGAN checkpoint (``{"model": {"generator": sd}}``)."""
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        sd = {k[len("model_gen."):]: v
              for k, v in ckpt["state_dict"].items()
              if k.startswith("model_gen.")}
        official = False
    elif isinstance(ckpt, dict) and isinstance(ckpt.get("model"), dict) \
            and "generator" in ckpt["model"]:
        sd = ckpt["model"]["generator"]
        official = True
    else:
        raise ValueError(
            f"{ckpt_path}: not a recognized vocoder checkpoint (expected "
            "'state_dict' with model_gen.* keys or model.generator)")
    if not sd:
        raise ValueError(f"{ckpt_path}: generator state_dict is empty")
    return sd, official


def _wn_weight(sd: Mapping, name: str) -> np.ndarray:
    """A conv weight as stored (``weight`` or ``weight_v``), for shapes."""
    key = f"{name}.weight" if f"{name}.weight" in sd else f"{name}.weight_v"
    return _np(sd[key])


def _load_feature_stats(stats_path: str) -> Dict[str, np.ndarray]:
    """Official ParallelWaveGAN mel feature stats: npy ([mean, scale]) or
    hdf5 ("mean" / "scale"), the latter through ``h5py``, which raises
    naming the file where it is not installed."""
    if stats_path.endswith(".npy"):
        arr = np.load(stats_path)
        return {"mean": np.asarray(arr[0], np.float32),
                "scale": np.asarray(arr[1], np.float32)}
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            f"{stats_path}: reading hdf5 feature stats needs h5py, which is "
            "not installed; convert them to stats.npy ([mean, scale])") from e
    with h5py.File(stats_path, "r") as f:
        return {"mean": np.asarray(f["mean"], np.float32),
                "scale": np.asarray(f["scale"], np.float32)}


def _read_ckpt(ckpt_path: str, stats_path: Optional[str]):
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    sd, official = _generator_sd(ckpt, ckpt_path)
    stats = (_load_feature_stats(stats_path)
             if official and stats_path and os.path.exists(stats_path)
             else None)
    return sd, stats


def load_pwg_checkpoint(ckpt_path: str, stats_path: Optional[str] = None,
                        config_path: Optional[str] = None):
    """A Parallel WaveGAN checkpoint: an official one (with its feature
    stats, which normalize the input mel) or a reference task checkpoint
    (no stats).  Returns (flax variables, stats or None, generator
    hyperparameters): those of ``config.yaml``'s ``generator_params``
    (read with the port's ``yaml_io``), overlaid with what the weights'
    shapes show (layers, upsample scales, channel widths, the aux context
    window, a pitch embedding).  ``stacks`` leaves no trace in the shapes
    and comes from ``config.yaml`` alone."""
    gen_params: Dict[str, Any] = {}
    if config_path and os.path.exists(config_path):
        from stylesinger_torch import yaml_io
        gen_params = dict((yaml_io.load(config_path) or {}).get(
            "generator_params", {}))
    sd, stats = _read_ckpt(ckpt_path, stats_path)
    gen_params["layers"] = len(
        {k.split(".")[1] for k in sd if k.startswith("conv_layers.")})
    up_idx = sorted({int(k.split(".")[3]) for k in sd
                     if k.startswith("upsample_net.upsample.up_layers.")})
    up = dict(gen_params.get("upsample_params", {}))
    if up_idx:
        # an upsample Conv2d kernel is (freq_k, 2 * scale + 1)
        up["upsample_scales"] = [
            (int(_wn_weight(
                sd, f"upsample_net.upsample.up_layers.{i}").shape[-1]) - 1)
            // 2 for i in up_idx]
    # conv_in's kernel is 2 * aux_context_window + 1
    up["aux_context_window"] = (int(_wn_weight(
        sd, "upsample_net.conv_in").shape[-1]) - 1) // 2
    gen_params["upsample_params"] = up
    gen_params["residual_channels"] = int(_wn_weight(
        sd, "first_conv").shape[0])
    gen_params["gate_channels"] = int(_wn_weight(
        sd, "conv_layers.0.conv").shape[0])
    gen_params["skip_channels"] = int(_wn_weight(
        sd, "conv_layers.0.conv1x1_skip").shape[0])
    gen_params["use_pitch_embed"] = any(
        k.startswith("pitch_embed.") for k in sd)
    return convert_pwg(sd, layers=gen_params["layers"],
                       n_scales=len(up_idx)), stats, gen_params


def load_melgan_checkpoint(ckpt_path: str,
                           stats_path: Optional[str] = None):
    """A MelGAN checkpoint, official or reference, with the optional feature
    stats.  Returns (flax variables, stats or None, generator
    hyperparameters read from the weights: ``base_channels`` from
    ``conv_pre``, ``upsample_scales`` from each transposed conv's k =
    2r)."""
    sd, stats = _read_ckpt(ckpt_path, stats_path)
    # conv_pre at 1, then 5 entries per scale, conv_post at 5n + 4
    tops = [int(k.split(".")[1]) for k in sd if k.startswith("melgan.")]
    if not tops:
        raise ValueError(
            f"{ckpt_path}: no 'melgan.*' keys: not a MelGAN generator "
            "checkpoint")
    n_scales = (max(tops) - 4) // 5
    gen_params = {
        "base_channels": int(_wn_weight(sd, "melgan.1").shape[0]),
        # a ConvTranspose1d weight is [in, out, k] with k = 2 * rate
        "upsample_scales": [
            int(_wn_weight(sd, f"melgan.{3 + 5 * i}").shape[2]) // 2
            for i in range(n_scales)],
    }
    return convert_melgan(sd, n_scales=n_scales), stats, gen_params


def main(argv=None) -> None:
    """``python -m stylesinger_torch.convert <model.ckpt> <out_dir>
    [--config path] [--hifigan]``: a reference ``model_ckpt_steps_N.ckpt``
    in the port's own layout under ``out_dir``:

    - the acoustic model (its ``model`` child): ``ckpt/model_ckpt_steps_<N>
      .pt`` (``training/checkpoint.py``), with the config beside it as
      ``config.yaml``: a work dir that ``StyleSingerInfer.load_params`` and
      ``run.py infer`` read;
    - ``--hifigan`` (its ``model_gen`` child): ``generator.pt``, which
      ``vocoder_ckpt`` reads.
    """
    import argparse

    from stylesinger_torch.config import load_config, save_config
    from stylesinger_torch.training.checkpoint import save_model
    from stylesinger_torch.vocoder_infer import GENERATOR_FILE

    ap = argparse.ArgumentParser("stylesinger_torch.convert")
    ap.add_argument("ckpt")
    ap.add_argument("out_dir")
    ap.add_argument("--config", default=None)
    ap.add_argument("--hifigan", action="store_true",
                    help="the checkpoint is a vocoder (model_gen child)")
    a = ap.parse_args(argv)
    cfg = load_config(a.config)
    ckpt = torch.load(a.ckpt, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    sd = sd.get("model_gen" if a.hifigan else "model", sd)
    os.makedirs(a.out_dir, exist_ok=True)
    if a.hifigan:
        path = os.path.join(a.out_dir, GENERATOR_FILE)
        torch.save(from_jax_params(convert_hifigan(sd, cfg)), path)
    else:
        path = save_model(a.out_dir, ckpt.get("global_step", 0),
                          from_jax_params(convert_stylesinger(sd, cfg)))
        save_config(cfg, a.out_dir)
    print(f"| wrote {path}")


if __name__ == "__main__":
    main()
