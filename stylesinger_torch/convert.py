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

A reference (AaronZ345/StyleSinger) HiFi-GAN checkpoint reaches the port
through the JAX package's converter, copied here: :func:`load_torch_checkpoint`
reads a ``model_ckpt_steps_N.ckpt``, :func:`convert_hifigan` folds its weight
norm (``g * v / ||v||``) into the flax tree, and :func:`from_jax_params` maps
that tree to the generator's ``state_dict``.
"""

from __future__ import annotations

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
# Reference torch checkpoints (copy of stylesinger_tpu/convert.py:29-79,
# :362-385, :648-657): torch state_dict -> flax tree
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


def load_torch_checkpoint(path: str, child: Optional[str] = "model"):
    """The flat state_dict of ``child`` in a reference
    ``model_ckpt_steps_N.ckpt`` (its ``state_dict`` entry, by child)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    if child is not None and child in sd:
        sd = sd[child]
    return dict(sd.items())
