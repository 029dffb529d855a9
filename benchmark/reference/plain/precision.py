"""The activation compute dtype of training (frozen from
the port's ``models/precision.py``).

``compute_dtype: bfloat16`` runs the model's activations in bf16 while the
parameters and the optimizer stay f32.  ``training/step.py`` enters
:func:`activation_dtype` around the model's pass; the modules read
:func:`compute_dtype` where the JAX modules pass ``dtype=
precision.compute_dtype()`` to flax, and :func:`cast` where the JAX
modules call ``precision.cast``.  The rules the modules follow are flax's:

- a ``Dense`` / ``Conv`` with the compute dtype casts its input, kernel and
  bias to it and returns it (:func:`module_dtype`); one without a dtype
  computes in the promotion of its input and its f32 parameters, so a bf16
  input comes back f32;
- a ``LayerNorm`` takes its mean and variance in f32 and returns the
  compute dtype, or f32 without one;
- the attention logits are f32: q.k of bf16 inputs is taken on f32 copies,
  where products of bf16 values are exact;
- a constant that JAX rounds to an activation's dtype
  (``jnp.asarray(k ** -0.5, y.dtype)``) is rounded the same way
  (:func:`const`).

Outside a context, and at ``float32``, every rule is the identity on f32
tensors.  Inference does not read the setting.  This is not autocast:
``torch.autocast`` returns f32 from ``layer_norm`` and leaves elementwise
ops in f32, where flax rounds them to bf16.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Union

import torch

_DTYPE: Optional[torch.dtype] = None   # None: full f32

DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def parse(dtype: Union[str, torch.dtype, None]) -> Optional[torch.dtype]:
    """``"float32"`` / None -> None, ``"bfloat16"`` -> ``torch.bfloat16``;
    any other value raises."""
    if dtype is None or dtype == torch.float32:
        return None
    if dtype == torch.bfloat16:
        return dtype
    if dtype not in DTYPES:
        raise ValueError(f"compute_dtype {dtype!r}: the port trains in "
                         f"{sorted(DTYPES)}")
    return DTYPES[dtype]


def compute_dtype() -> Optional[torch.dtype]:
    """The current activation dtype, or None for full precision."""
    return _DTYPE


def cast(x):
    """``x`` in the compute dtype (the identity outside a context or for
    None)."""
    if _DTYPE is None or x is None:
        return x
    return x.to(_DTYPE)


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32, or in its own dtype where that is wider (f64): flax
    takes statistics and logits in ``promote_types(float32, x.dtype)``."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


@functools.lru_cache(maxsize=None)
def const(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as ``jnp.asarray(value, dtype)``."""
    return float(torch.tensor(value, dtype=dtype))


def module_dtype(x: torch.Tensor, param: torch.Tensor,
                 compute: bool) -> torch.dtype:
    """The dtype a flax layer computes in: the compute dtype when the layer
    takes it (``compute``) and one is set, else the promotion of its input
    and its parameters."""
    if compute and _DTYPE is not None:
        return _DTYPE
    return torch.promote_types(x.dtype, param.dtype)


@contextlib.contextmanager
def activation_dtype(dtype: Union[str, torch.dtype, None]):
    """Run model code inside with ``dtype`` activations (``"float32"`` or
    ``"bfloat16"``; anything else raises)."""
    global _DTYPE
    new = parse(dtype)
    old = _DTYPE
    _DTYPE = new
    try:
        yield
    finally:
        _DTYPE = old


@contextlib.contextmanager
def compute_layer_dtypes(model: torch.nn.Module):
    """Inside, record the output dtype of every layer of ``model`` that
    takes the compute dtype (built with ``compute=True``): yields a dict
    {module name: set of dtypes}, filled as the layers run.  A check that
    a step ran at its ``compute_dtype`` reads it."""
    seen: dict = {}
    hooks = [m.register_forward_hook(
        lambda m, i, o, name=name: seen.setdefault(name, set()).add(o.dtype))
        for name, m in model.named_modules()
        if getattr(m, "compute", False) is True]
    try:
        yield seen
    finally:
        for h in hooks:
            h.remove()
