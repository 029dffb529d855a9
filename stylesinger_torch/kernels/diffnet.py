"""One residual layer of the diffusion denoisers: CUDA kernel and plain twin.

Replaces no kernel of ``stylesinger_tpu``: JAX leaves
``models/diffnet.py::ResidualBlock`` to XLA.  ``csrc/diffnet.cu`` takes the
layer's inference forward whole (the dilated conv, the gate, the output
projection, the residual and the skip sum) on [B, T, C] channels-last rows
at f32 accuracy (3xTF32 on the tensor cores); see its header for the
design.  :func:`diffnet_layer` runs it behind the registered operator
``torch.ops.stylesinger.diffnet_layer`` (CUDA: the kernel, one counted
launch; CPU: :func:`layer_plain`, the same arithmetic in plain PyTorch; a
fake implementation for tracing), so ``torch.export`` records one node per
layer call.

The conditioner projection ``cp`` (both biases of the layer's pre-gate sum
included, :func:`cond_projection`) is an input: it does not change over a
sampler's chain, so ``models/diffnet.py::cond_cache`` computes it once per
chain.  The weights are laid out for the kernel once, and again when a
weight's storage or version changes (:func:`laid_out`).

:func:`takes_layer` is the shape rule by which ``_Stack.run`` routes a
layer here: C a multiple of 64 up to 256, a kernel of 3 at a dilation of
at most 8 (the 16 halo rows the kernel stages).  :func:`engages` is the
rest: f32 tensors on CUDA, no autograd recording, no activation dtype.
"""

from __future__ import annotations

import math
import weakref
from typing import Iterable

import torch
import torch.nn.functional as F

from stylesinger_torch.kernels._build import (
    LaunchCounter, check, library, refuse_autograd,
)
from stylesinger_torch.kernels.mrf import _round_tf32
from stylesinger_torch.models import precision

MAX_C = 256
MAX_DILATION = 8  # (k - 1) * d <= 16 halo rows
KC, BN = 16, 128  # rows and columns of one laid-out weight chunk
SQRT2 = precision.const(math.sqrt(2.0), torch.float32)
# the residual's scale as PyTorch's CUDA division by a scalar applies it
SCALE = float(torch.tensor(1.0) / torch.tensor(SQRT2))
counter = LaunchCounter("kernel.diffnet")


def takes_layer(channels: int, kernel_size: int, dilation: int) -> bool:
    """Whether the kernel takes a residual layer of this shape."""
    return (channels % 64 == 0 and 0 < channels <= MAX_C and
            kernel_size == 3 and 1 <= dilation <= MAX_DILATION)


def engages(tensors: Iterable[torch.Tensor]) -> bool:
    """Whether a layer on ``tensors`` (its inputs and weights) goes to the
    kernel: all on CUDA, and :func:`inference_f32`."""
    tensors = list(tensors)
    return all(t.is_cuda for t in tensors) and inference_f32(tensors)


def inference_f32(tensors: Iterable[torch.Tensor]) -> bool:
    """Whether ``tensors`` are an f32 inference call: all f32, no
    ``precision.activation_dtype`` set, and autograd off or none of them
    requiring grad."""
    tensors = list(tensors)
    return (precision.compute_dtype() is None and
            all(t.dtype == torch.float32 for t in tensors) and
            not (torch.is_grad_enabled() and
                 any(t.requires_grad for t in tensors)))


def cond_projection(cond: torch.Tensor, w_cond: torch.Tensor,
                    b_cond: torch.Tensor, b_dil: torch.Tensor
                    ) -> torch.Tensor:
    """cond [B, T, Dc] through the 1x1 conditioner conv ``w_cond`` [2C, Dc,
    1], plus both biases of the pre-gate sum: [B, T, 2C]."""
    return F.linear(cond, w_cond[:, :, 0], b_cond + b_dil)


def layer_plain(x: torch.Tensor, pstep: torch.Tensor, cp: torch.Tensor,
                w_dil: torch.Tensor, w_out: torch.Tensor,
                b_out: torch.Tensor, skips: torch.Tensor, *, dilation: int,
                first: bool, conv=F.conv1d) -> torch.Tensor:
    """What one launch of ``csrc/diffnet.cu`` computes, in plain PyTorch:
    x [B, T, C], pstep [B, C] (the diffusion projection), cp [B, T, 2C]
    (:func:`cond_projection`), w_dil [2C, C, 3], w_out [2C, C, 1], b_out
    [2C]; returns the layer's output and writes (``first``) or adds its
    skip into ``skips`` [B, T, C].  ``conv(input, weight, padding=,
    dilation=)`` computes both convs (a test swaps in TF32-rounded ones)."""
    c = x.shape[-1]
    y = (x + pstep[:, None, :]).transpose(1, 2)
    a = conv(y, w_dil, padding=dilation, dilation=dilation).transpose(1, 2)
    a = a + cp
    g = torch.sigmoid(a[..., :c]) * torch.tanh(a[..., c:])
    o = conv(g.transpose(1, 2), w_out, padding=0, dilation=1)
    o = o.transpose(1, 2) + b_out
    if first:
        skips.copy_(o[..., c:])
    else:
        skips.add_(o[..., c:])
    return (x + o[..., :c]) / SQRT2


def _chunks(b: torch.Tensor) -> torch.Tensor:
    """B [n, K, 128] (input row, column) -> [n, K / 16, 2, 2048]: per 16
    rows the TF32 halves (hi, lo), each K-major in 8 x 4 core matrices,
    (row k, column n) at ((n // 8) * 4 + k // 4) * 32 + (n % 8) * 4 +
    k % 4."""
    n, k = b.shape[:2]
    b = b.reshape(n, k // KC, KC // 4, 4, BN // 8, 8)
    b = b.permute(0, 1, 4, 2, 5, 3).reshape(n, k // KC, KC * BN)
    hi = _round_tf32(b)
    return torch.stack([hi, _round_tf32(b - hi)], dim=2)


def layout(w_dil: torch.Tensor, w_out: torch.Tensor) -> torch.Tensor:
    """The weights as the stream of 16 KB chunks that the kernel reads
    (1-D, f32): for each of the C / 64 conv passes, its 128 columns (gate
    channels [64 j, 64 j + 64), then the filter channels C above them)
    over K = 3 taps x C input channels; then for each of the C / 64 output
    passes, its 128 columns (residual channels [64 j, 64 j + 64), then the
    skip channels C above them) over K = C.  Each 16 rows of K are one
    chunk (:func:`_chunks`)."""
    c = w_dil.shape[1]
    cols = torch.stack([torch.cat([torch.arange(64 * j, 64 * j + 64),
                                   torch.arange(c + 64 * j, c + 64 * j + 64)])
                        for j in range(c // 64)]).to(w_dil.device)
    rows = w_dil.permute(2, 1, 0).reshape(3 * c, 2 * c)  # (tap, in) x out
    first = rows[:, cols].permute(1, 0, 2)               # [C/64, K, 128]
    second = w_out[:, :, 0].t()[:, cols].permute(1, 0, 2)
    return torch.cat([_chunks(first).reshape(-1),
                      _chunks(second).reshape(-1)]).contiguous()


_LAYOUTS: dict = {}


def laid_out(w_dil: torch.Tensor, w_out: torch.Tensor) -> torch.Tensor:
    """:func:`layout` of the pair, kept while both tensors live and laid
    out again when either's storage or version changes (a
    ``load_state_dict`` after the model was built, an optimizer step)."""
    key = (id(w_dil), id(w_out))
    stamp = (w_dil.data_ptr(), w_dil._version, w_out.data_ptr(),
             w_out._version)
    hit = _LAYOUTS.get(key)
    if hit is not None and hit[0]() is w_dil and hit[1]() is w_out \
            and hit[2] == stamp:
        return hit[3]

    def drop(_ref, key=key):
        _LAYOUTS.pop(key, None)

    with torch.no_grad():
        laid = layout(w_dil.detach(), w_out.detach())
    _LAYOUTS[key] = (weakref.ref(w_dil, drop), weakref.ref(w_out, drop),
                     stamp, laid)
    return laid


def _launch(x, pstep, cp, w, b_out, out, skips, *, dilation: int,
            first: bool) -> None:
    """One launch of ``csrc/diffnet.cu`` on the weights ``w`` laid out by
    :func:`layout`, writing the layer's output into ``out``."""
    nb, t, c = x.shape
    status = library().ss_diffnet_layer(
        x.data_ptr(), pstep.data_ptr(), cp.data_ptr(), w.data_ptr(),
        b_out.data_ptr(), out.data_ptr(), skips.data_ptr(), nb, t, c,
        dilation, int(first), SCALE,
        torch.cuda.current_stream(x.device).cuda_stream)
    check(status, "diffnet_layer")
    counter.add()


@torch.library.custom_op("stylesinger::diffnet_layer", mutates_args=("skips",),
                         device_types="cpu")
def _layer_op(x: torch.Tensor, pstep: torch.Tensor, cp: torch.Tensor,
              w_dil: torch.Tensor, w_out: torch.Tensor, b_out: torch.Tensor,
              skips: torch.Tensor, dilation: int, first: bool
              ) -> torch.Tensor:
    """The registered operator behind :func:`diffnet_layer`.  CPU: the
    plain twin."""
    return layer_plain(x, pstep, cp, w_dil, w_out, b_out, skips,
                       dilation=dilation, first=first)


@_layer_op.register_kernel("cuda")
def _layer_op_cuda(x, pstep, cp, w_dil, w_out, b_out, skips, dilation,
                   first):
    """CUDA: ``csrc/diffnet.cu``, one counted launch."""
    out = torch.empty_like(x)
    _launch(x, pstep, cp, laid_out(w_dil, w_out), b_out, out, skips,
            dilation=dilation, first=first)
    return out


@_layer_op.register_fake
def _layer_op_fake(x, pstep, cp, w_dil, w_out, b_out, skips, dilation,
                   first):
    return torch.empty_like(x)


def _check_args(x, pstep, cp, w_dil, w_out, b_out, skips, dilation) -> None:
    if x.ndim != 3:
        raise ValueError(f"diffnet_layer: x must be [B, T, C], got "
                         f"{tuple(x.shape)}")
    nb, t, c = x.shape
    if not takes_layer(c, w_dil.shape[-1], dilation):
        raise ValueError(f"diffnet_layer: C={c}, kernel {w_dil.shape[-1]}, "
                         f"dilation {dilation} is not a layer it takes")
    shapes = {"pstep": (pstep, (nb, c)), "cp": (cp, (nb, t, 2 * c)),
              "w_dil": (w_dil, (2 * c, c, 3)), "w_out": (w_out, (2 * c, c, 1)),
              "b_out": (b_out, (2 * c,)), "skips": (skips, (nb, t, c))}
    for name, (v, shape) in shapes.items():
        if tuple(v.shape) != shape:
            raise ValueError(f"diffnet_layer: {name} must be {shape}, got "
                             f"{tuple(v.shape)}")
    for v in (x, *(v for v, _ in shapes.values())):
        if v.device != x.device or v.dtype != torch.float32:
            raise ValueError(f"diffnet_layer: tensors must be float32 on "
                             f"{x.device}")
        if not v.is_contiguous():
            raise ValueError("diffnet_layer: tensors must be contiguous")


def diffnet_layer(x: torch.Tensor, pstep: torch.Tensor, cp: torch.Tensor,
                  w_dil: torch.Tensor, w_out: torch.Tensor,
                  b_out: torch.Tensor, skips: torch.Tensor, *,
                  dilation: int, first: bool) -> torch.Tensor:
    """One residual layer (:func:`layer_plain`'s arguments): returns the
    layer's output and writes (``first``) or adds the skip into ``skips``
    in place.  CUDA tensor: the ``csrc/diffnet.cu`` kernel; it has no
    backward, so it raises while autograd records a tensor that requires
    grad.  CPU tensor: the plain twin.  Either goes through the operator
    ``torch.ops.stylesinger.diffnet_layer``."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"diffnet_layer: unsupported device {x.device}")
    if x.device.type == "cuda":
        refuse_autograd("diffnet_layer",
                        [x, pstep, cp, w_dil, w_out, b_out, skips])
    _check_args(x, pstep, cp, w_dil, w_out, b_out, skips, dilation)
    return _layer_op(x, pstep, cp, w_dil, w_out, b_out, skips, dilation,
                     first)
