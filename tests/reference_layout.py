"""Reference-layout state dicts from flax-layout weights, without JAX.

The reference (AaronZ345/StyleSinger, ParallelWaveGAN) stores torch
modules; the JAX package's converters (``stylesinger_tpu/convert.py``, and
the port's copy in ``stylesinger_torch/convert.py``) read those state dicts
into flax trees.  The writers here invert the converters' layout rules, so
a test (or ``chip_smoke.py``, which runs without JAX) can make a reference
checkpoint from seeded weights:

- :func:`flax_tree`: a port module's parameters and buffers as the flax
  ``variables`` ({'params': ..., 'codebook': ...}) of the JAX module, the
  inverse of ``stylesinger_torch/convert.py::from_jax_params``;
- :func:`reference_stylesinger_sd`, :func:`reference_pwg_sd`,
  :func:`reference_melgan_sd`: the reference ``StyleSinger``,
  ``ParallelWaveGANGenerator`` and ``MelGANGenerator`` state dicts of flax
  ``variables``, the inverses of ``convert_stylesinger``, ``convert_pwg``
  and ``convert_melgan``.
"""

import numpy as np
import torch
import torch.nn as nn


def _set(tree, path, value):
    *parents, leaf = path
    for key in parents:
        tree = tree.setdefault(key, {})
    tree[leaf] = value


def flax_tree(module: nn.Module) -> dict:
    """``module``'s weights as flax ``variables``: a 2-D weight is a Dense
    kernel [in, out] (an embedding table where the module embeds), a 3-D
    weight a conv kernel [k, in, out] (or a transposed conv's [k, out,
    in]), a 4-D weight a 2-D conv kernel [kh, kw, in, out], a LayerNorm's
    weight its scale; other parameters as they are; the buffers in the
    ``codebook`` collection."""
    out = {"params": {}, "codebook": {}}
    for mname, m in module.named_modules():
        prefix = mname.split(".") if mname else []
        for name, p in m.named_parameters(recurse=False):
            a = p.detach().cpu().numpy()
            if name == "weight" and isinstance(m, nn.LayerNorm):
                name = "scale"
            elif name == "weight" and a.ndim == 2 and \
                    "embed" in type(m).__name__.lower():
                name = "embedding"
            elif name == "weight":
                name = "kernel"
                a = a.transpose({2: (1, 0), 3: (2, 1, 0),
                                 4: (2, 3, 1, 0)}[a.ndim])
            _set(out["params"], prefix + [name], np.ascontiguousarray(a))
        for name, b in m.named_buffers(recurse=False):
            if name in m._non_persistent_buffers_set:
                continue
            _set(out["codebook"], prefix + [name],
                 b.detach().cpu().numpy().copy())
    return out


def _layers(tree, stem):
    """The indices of ``<stem><i>`` children, in order."""
    return sorted(int(k[len(stem):]) for k in tree
                  if k.startswith(stem) and k[len(stem):].isdigit())


def reference_stylesinger_sd(variables, channel_norm: str = "gamma"):
    """A state dict in the reference (AaronZ345/StyleSinger) layout of
    ``StyleSinger`` from the JAX model's flax ``variables``, by inverting
    the layout rules of ``stylesinger_tpu/convert.py::convert_stylesinger``:
    Dense kernels transposed, conv kernels [k, in, out] -> [out, in, k], the
    self-attention's qkv kernel and the aligner's q/k/v fused into
    ``in_proj_*``, the style WaveNet's convs weight-normed (``weight_v`` the
    kernel, ``weight_g`` its norm), a padding row under each codebook, and
    the style encoder's channel norms as ``gamma``/``beta`` [1, C, 1]
    (``channel_norm="gamma"``) or ``weight``/``bias``."""
    p = variables["params"]
    sd = {}

    def put(name, a):
        sd[name] = torch.tensor(np.ascontiguousarray(np.asarray(a,
                                                                np.float32)))

    def lin(name, leaf):
        put(f"{name}.weight", np.asarray(leaf["kernel"]).T)
        if "bias" in leaf:
            put(f"{name}.bias", leaf["bias"])

    def conv(name, leaf, weight_norm=False):
        w = np.asarray(leaf["kernel"]).transpose(2, 1, 0)
        if weight_norm:
            put(f"{name}.weight_v", w)
            put(f"{name}.weight_g", np.sqrt(
                (w.astype(np.float64) ** 2).sum(axis=(1, 2), keepdims=True)))
        else:
            put(f"{name}.weight", w)
        if "bias" in leaf:
            put(f"{name}.bias", leaf["bias"])

    def ln(name, leaf):
        put(f"{name}.weight", leaf["scale"])
        put(f"{name}.bias", leaf["bias"])

    def channel_ln(name, leaf):
        if channel_norm == "gamma":
            put(f"{name}.gamma", np.asarray(leaf["scale"])[None, :, None])
            put(f"{name}.beta", np.asarray(leaf["bias"])[None, :, None])
        else:
            ln(name, leaf)

    def emb(name, leaf):
        put(f"{name}.weight", leaf["embedding"])

    def fft_blocks(prefix, blocks):
        for i in _layers(blocks, "layer_"):
            lay, q = blocks[f"layer_{i}"], f"{prefix}layers.{i}.op"
            attn = lay["MultiheadSelfAttention_0"]
            ln(f"{q}.layer_norm1", lay["LayerNorm_0"])
            put(f"{q}.self_attn.in_proj_weight",
                np.asarray(attn["qkv"]["kernel"]).T)
            put(f"{q}.self_attn.out_proj.weight",
                np.asarray(attn["out"]["kernel"]).T)
            ln(f"{q}.layer_norm2", lay["LayerNorm_1"])
            conv(f"{q}.ffn.ffn_1", lay["TransformerFFN_0"]["Conv_0"])
            lin(f"{q}.ffn.ffn_2",
                lay["TransformerFFN_0"]["LambdaDense_0"]["Dense_0"])
        if "pos_embed_alpha" in blocks:
            put(f"{prefix}pos_embed_alpha", blocks["pos_embed_alpha"])
        if "LayerNorm_0" in blocks:
            ln(f"{prefix}layer_norm", blocks["LayerNorm_0"])

    def conv_predictor(prefix, tree):
        for i in _layers(tree, "conv_"):
            conv(f"{prefix}conv.{i}.1", tree[f"conv_{i}"])
            ln(f"{prefix}conv.{i}.3", tree[f"ln_{i}"])
        lin(f"{prefix}linear", tree["out"])
        if "pos_embed_alpha" in tree:
            put(f"{prefix}pos_embed_alpha", tree["pos_embed_alpha"])

    def diffnet(prefix, tree):
        conv(f"{prefix}input_projection", tree["input_projection"])
        if "uv_embed" in tree:
            emb(f"{prefix}uv_embed", tree["uv_embed"])
        lin(f"{prefix}mlp.0", tree["mlp"]["fc1"])
        lin(f"{prefix}mlp.2", tree["mlp"]["fc2"])
        conv(f"{prefix}skip_projection", tree["skip_projection"])
        conv(f"{prefix}output_projection", tree["output_projection"])
        for i in _layers(tree, "residual_"):
            r, q = tree[f"residual_{i}"], f"{prefix}residual_layers.{i}"
            conv(f"{q}.dilated_conv", r["dilated_conv"])
            lin(f"{q}.diffusion_projection", r["diffusion_projection"])
            conv(f"{q}.conditioner_projection", r["conditioner_projection"])
            conv(f"{q}.output_projection", r["output_projection"])

    emb("encoder.embed_tokens", p["encoder"]["embed_tokens"])
    fft_blocks("encoder.", p["encoder"]["blocks"])
    fft_blocks("decoder.", p["decoder"]["blocks"])
    ne = p["note_encoder"]
    emb("note_encoder.emb", ne["emb"])
    emb("note_encoder.type_emb", ne["type_emb"])
    lin("note_encoder.dur_ln", ne["dur_ln"])
    for name in ("spk_embed_proj", "emo_embed_proj", "l1", "ln_proj",
                 "mel_out"):
        if name in p:
            lin(name, p[name])
    emb("pitch_embed", p["pitch_embed"])
    conv_predictor("dur_predictor.", p["dur_predictor"])
    for name in ("pitch_predictor", "pitch_inpainter_predictor"):
        if name in p:
            conv_predictor(f"{name}.", p[name])
    if "norm" in p:
        lin("norm.affine_layer.linear_layer", p["norm"]["affine"])
    if "style_extractor" in p:
        wn = p["style_extractor"]["wavenet"]
        for i in _layers(wn, "in_"):
            conv(f"style_extractor.wavenet.in_layers.{i}", wn[f"in_{i}"],
                 weight_norm=True)
            conv(f"style_extractor.wavenet.res_skip_layers.{i}",
                 wn[f"res_skip_{i}"], weight_norm=True)
        enc = p["style_extractor"]["encoder"]
        for i in _layers(enc, "res_"):
            for j in _layers(enc[f"res_{i}"], "ln_"):
                q = f"style_extractor.encoder.res_blocks.{i}.blocks.{j}"
                channel_ln(f"{q}.0", enc[f"res_{i}"][f"ln_{j}"])
                conv(f"{q}.1", enc[f"res_{i}"][f"conv_a_{j}"])
                conv(f"{q}.4", enc[f"res_{i}"][f"conv_b_{j}"])
        channel_ln("style_extractor.encoder.last_norm", enc["last_norm"])
        conv("style_extractor.encoder.post_net1", enc["post"])
        rq = variables["codebook"]["style_extractor"]["rq"]
        for i in _layers(rq, "codebook_"):
            cb, q = rq[f"codebook_{i}"], f"style_extractor.rqvae.codebooks.{i}"
            table = np.asarray(cb["embedding"])
            put(f"{q}.weight", np.concatenate(
                [table, np.zeros_like(table[:1])]))
            put(f"{q}.cluster_size_ema", cb["cluster_size_ema"])
            put(f"{q}.embed_ema", cb["embed_ema"])
        for i in _layers(p["align"], "layer_"):
            lay, q = p["align"][f"layer_{i}"], f"align.layers.{i}"
            mha = lay["mha"]
            put(f"{q}.multihead_attn.in_proj_weight", np.concatenate(
                [np.asarray(mha[n]["kernel"]).T for n in "qkv"]))
            put(f"{q}.multihead_attn.in_proj_bias", np.concatenate(
                [np.asarray(mha[n]["bias"]) for n in "qkv"]))
            lin(f"{q}.multihead_attn.out_proj", mha["out"])
            for name in ("linear1", "linear2"):
                lin(f"{q}.{name}", lay[name])
            for name in ("norm1", "norm2"):
                ln(f"{q}.{name}", lay[name])
    for name in ("gm_diffnet", "gm_diffnet_inpainte"):
        if name in p:
            diffnet(f"{name}.", p[name])
    if "postdiff" in p:
        diffnet("postdiff.denoise_fn.", p["postdiff"])
    return sd


def _torch_leaf(sd, name, leaf, weight_norm, axes=(1, 2)):
    """A flax conv leaf as a torch conv (weight [out, in, k], or a
    transposed conv's [in, out, k], from the flax kernel by reversing its
    axes), weight-normed over ``axes`` when asked: ``weight_v`` the
    kernel, ``weight_g`` its norm."""
    w = np.asarray(leaf["kernel"]).transpose(2, 1, 0)
    t = np.ascontiguousarray
    if weight_norm:
        sd[f"{name}.weight_v"] = torch.tensor(t(w))
        sd[f"{name}.weight_g"] = torch.tensor(t(np.sqrt(
            (w.astype(np.float64) ** 2).sum(axis=axes, keepdims=True)
        ).astype(np.float32)))
    else:
        sd[f"{name}.weight"] = torch.tensor(t(w))
    if "bias" in leaf:
        sd[f"{name}.bias"] = torch.tensor(t(np.asarray(leaf["bias"])))


def reference_pwg_sd(variables, weight_norm: bool = True):
    """A reference ``ParallelWaveGANGenerator`` state dict from the JAX
    generator's flax variables (the inverse of ``convert_pwg``): each
    ``up_conv_<i>`` as the Conv2d(1, 1, (1, 2s+1)) at ``up_layers.<2i+1>``,
    the 1-D convs weight-normed when asked."""
    p = variables["params"]
    sd = {}
    up = p["upsample_net"]
    _torch_leaf(sd, "upsample_net.conv_in", up["conv_in"], weight_norm)
    for i in _layers(up, "up_conv_"):
        w = np.asarray(up[f"up_conv_{i}"])[:, 0, 0][None, None, None]
        name = f"upsample_net.upsample.up_layers.{2 * i + 1}"
        if weight_norm:
            sd[f"{name}.weight_v"] = torch.tensor(np.ascontiguousarray(w))
            sd[f"{name}.weight_g"] = torch.tensor(np.sqrt(
                (w.astype(np.float64) ** 2).sum(axis=(1, 2, 3),
                                                keepdims=True)
            ).astype(np.float32))
        else:
            sd[f"{name}.weight"] = torch.tensor(np.ascontiguousarray(w))
    for name, key in (("first_conv", "first"), ("last_conv_layers.1",
                                                 "post1"),
                      ("last_conv_layers.3", "post2")):
        _torch_leaf(sd, name, p[key], weight_norm)
    if "pitch_embed" in p:
        sd["pitch_embed.weight"] = torch.tensor(
            np.asarray(p["pitch_embed"]["embedding"]))
        sd["c_proj.weight"] = torch.tensor(np.ascontiguousarray(
            np.asarray(p["c_proj"]["kernel"]).T))
        sd["c_proj.bias"] = torch.tensor(np.asarray(p["c_proj"]["bias"]))
    for i in _layers(p, "block_"):
        blk, q = p[f"block_{i}"], f"conv_layers.{i}"
        for name, key in (("conv", "conv"), ("conv1x1_aux", "aux"),
                          ("conv1x1_out", "res"), ("conv1x1_skip", "skip")):
            _torch_leaf(sd, f"{q}.{name}", blk[key], weight_norm)
    return sd


def reference_melgan_sd(variables, weight_norm: bool = True,
                        stacks: int = 3):
    """A reference ``MelGANGenerator`` state dict (the ``melgan``
    Sequential) from the JAX generator's flax variables (the inverse of
    ``convert_melgan``); a transposed conv's weight norm is over its output
    channels and taps, its first axis being the input channels."""
    p = variables["params"]
    sd = {}
    _torch_leaf(sd, "melgan.1", p["conv_pre"], weight_norm)
    idx = 2
    for i in _layers(p, "up_"):
        _torch_leaf(sd, f"melgan.{idx + 1}", p[f"up_{i}"], weight_norm)
        for j in range(stacks):
            r, q = p[f"res_{i}_{j}"], f"melgan.{idx + 2 + j}"
            _torch_leaf(sd, f"{q}.stack.2", r["conv1"], weight_norm)
            _torch_leaf(sd, f"{q}.stack.4", r["conv2"], weight_norm)
            _torch_leaf(sd, f"{q}.skip_layer", r["skip"], weight_norm)
        idx += 2 + stacks
    _torch_leaf(sd, f"melgan.{idx + 2}", p["conv_post"], weight_norm)
    return sd
