"""flax parameter tree -> ``state_dict`` of the port's modules.

The port's modules carry the flax names of the JAX modules, so the walk is
generic.  Layout rules (flax -> torch):

- ``Dense`` kernel [in, out]               -> Linear weight [out, in]
- ``Conv`` kernel [k, in, out]             -> conv weight [out, in, k]
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
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

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
                out[f"{prefix}weight"] = a.T if a.ndim == 2 \
                    else a.transpose(2, 1, 0)
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
