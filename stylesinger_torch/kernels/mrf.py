"""HiFi-GAN MRF group over overlap-save blocks: CUDA kernel and plain twin.

Counterpart of ``stylesinger_tpu/ops/mrf_pallas.py::fused_mrf_blocks``.  One
MRF group is 3 ``ResBlock1`` (kernels 3/7/11, dilations 1/3/5): per dilation
``x += conv(lrelu(conv_d(lrelu(x) * m)) * m)``, then the mean of the blocks'
outputs, cropped to the block's centre.  The mask ``m`` carries the SAME
zero padding at the true sequence ends (``models/hifigan._blockify``).

On a CUDA tensor :func:`fused_mrf_blocks` launches ``csrc/mrf.cu`` once per
dilation step, both convs of the step in one launch (9 launches for the
flagship group, in the order :func:`mrf_schedule` sets); residual adds, the
block sum, the mean and the halo crop ride in the kernel's epilogue.  On a
CPU tensor it runs :func:`mrf_blocks_plain`, the same arithmetic in plain
PyTorch.  :func:`mrf_step_plain` is what one launch computes, so the
schedule can be checked without the card.  Both run behind the registered
operator ``torch.ops.stylesinger.fused_mrf_blocks`` (its CUDA and CPU
implementations, with a fake one for tracing), so ``torch.export`` records
a call as one node of its graph and an exported program launches the
kernel, counted as any other call (``serving/export.py``).

``compute_dtype=torch.bfloat16`` is the Pallas kernel's bf16 form (the
recipe's ``vocoder_compute_dtype``): bf16 operands and buffers, f32 sums,
rounded to bf16 after each conv's bias, after lrelu and the mask, after
each residual add and at the output, with the resblocks summed in f32.
Its plain twin, :func:`mrf_blocks_plain_bf16`, runs in f32 arithmetic and
rounds at those points, so the CPU never computes a bf16 conv.

:func:`takes_stage` is the rule by which the generator routes a blocked
stage to this kernel: ``ResBlock1``, C <= 128 and every (k - 1) * d <= 64.
"""

from __future__ import annotations

import ctypes
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from stylesinger_torch.kernels._build import (
    LaunchCounter, check, library, refuse_autograd,
)

LRELU_SLOPE = 0.1
BF16_SLOPE = 0.10009765625  # the slope as bf16, as jax.nn.leaky_relu uses it
MAX_REACH = 64  # the kernel stages (k - 1) * d <= 64 extra rows
MAX_C = 128     # a thread block holds all channels of its rows
DTYPES = (torch.float32, torch.bfloat16)
counter = LaunchCounter("kernel.mrf")            # launches of the f32 mode
counter_bf16 = LaunchCounter("kernel.mrf_bf16")  # of the bf16 mode

# per resblock, per dilation: ((kernel1 [k, C, C], bias1 [C]),
#                              (kernel2 [k, C, C], bias2 [C]))
Weights = Sequence[Sequence[Tuple[Tuple[torch.Tensor, torch.Tensor],
                                  Tuple[torch.Tensor, torch.Tensor]]]]


def mrf_blocks_plain(xb: torch.Tensor, mask: torch.Tensor, weights: Weights,
                     *, kernels: Sequence[int],
                     dilations: Sequence[Sequence[int]], block: int,
                     halo: int) -> torch.Tensor:
    """Plain PyTorch twin: xb [Nb, L, C], mask [Nb, L, 1] -> [Nb, block, C].

    Kernels are in the JAX layout [k, C_in, C_out]."""
    x = xb.transpose(1, 2)
    m = mask.transpose(1, 2)
    acc = None
    for rb, k, dils in zip(weights, kernels, dilations):
        xj = x
        for ((w1, b1), (w2, b2)), d in zip(rb, dils):
            y = F.leaky_relu(xj, LRELU_SLOPE) * m
            y = F.conv1d(y, w1.permute(2, 1, 0), b1,
                         padding=(k - 1) // 2 * d, dilation=d)
            y = F.leaky_relu(y, LRELU_SLOPE) * m
            y = F.conv1d(y, w2.permute(2, 1, 0), b2, padding=(k - 1) // 2)
            xj = xj + y
        acc = xj if acc is None else acc + xj
    out = acc / len(kernels)
    return out[:, :, halo:halo + block].transpose(1, 2)


def takes_stage(c: int, kernels: Sequence[int],
                dilations: Sequence[Sequence[int]]) -> bool:
    """Whether the kernel takes a blocked ``ResBlock1`` stage of C channels:
    C <= MAX_C and every step's reach (k - 1) * d <= MAX_REACH."""
    return c <= MAX_C and all((k - 1) * d <= MAX_REACH
                              for k, ds in zip(kernels, dilations)
                              for d in ds)


def _bf16(a: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest bf16 value (ties to even), kept as f32."""
    return a.to(torch.bfloat16).float()


def _act_bf16(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """lrelu(v) * m for bf16 values v, each product rounded to bf16."""
    return _bf16(torch.where(v > 0, v, _bf16(v * BF16_SLOPE)) * m)


def mrf_blocks_plain_bf16(xb: torch.Tensor, mask: torch.Tensor,
                          weights: Weights, *, kernels: Sequence[int],
                          dilations: Sequence[Sequence[int]], block: int,
                          halo: int) -> torch.Tensor:
    """Plain twin of the bf16 mode: xb, mask bf16 -> [Nb, block, C] bf16.

    f32 arithmetic on bf16 values, rounded where ``_mrf_kernel`` rounds at
    ``compute_dtype=bfloat16``: weights to bf16; conv sums in f32, + bias,
    to bf16; lrelu and mask in bf16; x + y to bf16; the resblocks summed in
    f32; the mean to bf16."""
    x = xb.float().transpose(1, 2)
    m = mask.float().transpose(1, 2)
    acc = None
    for rb, k, dils in zip(weights, kernels, dilations):
        xj = x
        for ((w1, b1), (w2, b2)), d in zip(rb, dils):
            y = F.conv1d(_act_bf16(xj, m), _bf16(w1).permute(2, 1, 0),
                         padding=(k - 1) // 2 * d, dilation=d)
            y = _act_bf16(_bf16(y + b1[:, None]), m)
            y = F.conv1d(y, _bf16(w2).permute(2, 1, 0),
                         padding=(k - 1) // 2)
            xj = _bf16(xj + _bf16(y + b2[:, None]))
        acc = xj if acc is None else acc + xj
    out = acc * (1.0 / len(kernels))
    return out[:, :, halo:halo + block].transpose(1, 2).to(torch.bfloat16)


def _check_args(xb, mask, weights, kernels, dilations, block, halo,
                dtype) -> None:
    if xb.dtype != dtype or xb.ndim != 3:
        raise ValueError(f"fused_mrf_blocks: xb must be {dtype} [Nb, L, C], "
                         f"got {xb.dtype} {tuple(xb.shape)}")
    nb, length, c = xb.shape
    if c > MAX_C:
        raise ValueError(f"fused_mrf_blocks: C={c} > {MAX_C}")
    if length != block + 2 * halo:
        raise ValueError(f"fused_mrf_blocks: L={length} != block + 2*halo")
    if tuple(mask.shape) != (nb, length, 1) or mask.dtype != dtype:
        raise ValueError(f"fused_mrf_blocks: mask must be {dtype} "
                         f"[{nb}, {length}, 1], got {tuple(mask.shape)}")
    if mask.device != xb.device:
        raise ValueError(f"fused_mrf_blocks: mask must be on {xb.device}")
    tensors = [xb, mask]
    for rb, k, dils in zip(weights, kernels, dilations):
        if len(rb) != len(dils):
            raise ValueError("fused_mrf_blocks: weights/dilations mismatch")
        for ((w1, b1), (w2, b2)), d in zip(rb, dils):
            if (k - 1) * d > MAX_REACH:
                raise ValueError(f"fused_mrf_blocks: (k-1)*d > {MAX_REACH}")
            for w, b in ((w1, b1), (w2, b2)):
                if tuple(w.shape) != (k, c, c) or tuple(b.shape) != (c,):
                    raise ValueError("fused_mrf_blocks: bad weight shape "
                                     f"{tuple(w.shape)}/{tuple(b.shape)}")
                tensors += [w, b]
    for t in tensors[2:]:
        if t.device != xb.device or t.dtype != torch.float32:
            raise ValueError("fused_mrf_blocks: weights and biases must be "
                             f"float32 on {xb.device}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("fused_mrf_blocks: tensors must be contiguous")


Step = Callable[..., None]


def mrf_step_plain(x: torch.Tensor, mask: torch.Tensor, w1: torch.Tensor,
                   b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                   out: torch.Tensor, *, k: int, d: int,
                   acc_in: Optional[torch.Tensor] = None, t_begin: int = 0,
                   t_len: Optional[int] = None, out_off: int = 0,
                   scale: float = 1.0, conv: Callable = F.conv1d) -> None:
    """What one launch of ``csrc/mrf.cu`` computes, in plain PyTorch.

    For rows t in [t_begin, t_begin + t_len) of x [Nb, L, C]:
    ``out[:, t - out_off] = (x + conv_1(h) + b2 (+ acc_in)) * scale`` with
    ``h = lrelu(conv_d(lrelu(x) * m) + b1) * m``.  ``conv(input, weight,
    padding=, dilation=)`` does the bias-free convolutions (F.conv1d by
    default; a test swaps in TF32-rounded ones).  A bf16 x (and mask) is
    the bf16 mode: the weights, h, conv + bias and x + y are rounded to
    bf16 as in :func:`mrf_blocks_plain_bf16`; acc_in is f32, and ``out``
    (bf16 or f32) takes the result rounded to its own type."""
    t_len = x.shape[1] - t_begin if t_len is None else t_len
    xt = x.float().transpose(1, 2)
    m = mask.float().transpose(1, 2)
    if x.dtype == torch.bfloat16:
        rnd, w1, w2 = _bf16, _bf16(w1), _bf16(w2)

        def act(v):
            return _act_bf16(v, m)
    else:
        def rnd(v):
            return v

        def act(v):
            return F.leaky_relu(v, LRELU_SLOPE) * m
    y = conv(act(xt), w1.permute(2, 1, 0), padding=(k - 1) // 2 * d,
             dilation=d)
    h = act(rnd(y + b1[:, None]))
    y = conv(h, w2.permute(2, 1, 0), padding=(k - 1) // 2, dilation=1)
    v = rnd(xt + rnd(y + b2[:, None])).transpose(1, 2)[
        :, t_begin:t_begin + t_len]
    if acc_in is not None:
        v = v + acc_in[:, t_begin:t_begin + t_len]
    out[:, t_begin - out_off:t_begin - out_off + t_len] = v * scale


def mrf_schedule(xb: torch.Tensor, mask: torch.Tensor, weights: Weights, *,
                 kernels: Sequence[int], dilations: Sequence[Sequence[int]],
                 block: int, halo: int, step: Step) -> torch.Tensor:
    """Runs an MRF group as one ``step`` per dilation (9 for the flagship
    group) and returns [Nb, block, C].

    Each resblock starts from xb and ping-pongs its residual stream between
    two buffers (a step reads rows around its own, so it never writes the
    buffer it reads).  The last step of a resblock adds the stream into the
    running block sum (f32 in both modes); the last step of the group adds
    the sum, scales by 1 / len(kernels) and writes only the halo-cropped
    centre, in xb's type."""
    ping, pong = torch.empty_like(xb), torch.empty_like(xb)
    acc = torch.empty(xb.shape, dtype=torch.float32, device=xb.device)
    out = xb.new_empty((xb.shape[0], block, xb.shape[2]))
    n_blocks = len(kernels)
    for j, (rb, k, dils) in enumerate(zip(weights, kernels, dilations)):
        cur = xb
        for i, (((w1, b1), (w2, b2)), d) in enumerate(zip(rb, dils)):
            args = (cur, mask, w1, b1, w2, b2)
            if i < len(dils) - 1:
                nxt = pong if cur is ping else ping
                step(*args, nxt, k=k, d=d)
                cur = nxt
            elif j < n_blocks - 1:
                step(*args, acc, k=k, d=d, acc_in=acc if j > 0 else None)
            else:
                step(*args, out, k=k, d=d, acc_in=acc if j > 0 else None,
                     t_begin=halo, t_len=block, out_off=halo,
                     scale=1.0 / n_blocks)
    return out


def tile_n(c: int) -> int:
    """The kernel's tile width for C channels: the least of 32, 64, 128 that
    holds C (the kernel checks it)."""
    return 32 if c <= 32 else 64 if c <= 64 else 128


def _round_tf32(a: torch.Tensor) -> torch.Tensor:
    """Round f32 to the nearest TF32 value (ties away from zero), as
    ``cvt.rna.tf32.f32`` does: add half of the dropped 13 bits, clear them."""
    return ((a.view(torch.int32) + 0x1000) & -8192).view(torch.float32)


def _kernel_layout(weights: Weights, c: int):
    """The weights with each kernel [k, C, C] (tap, in, out) replaced by the
    image that ``csrc/mrf.cu`` copies into shared memory chunk by chunk:
    [k, kpad / 32, 2, 32 * bn], chunk (tap, ci0) = the TF32 halves (hi, lo)
    of W[tap, ci0:ci0 + 32, :bn], zero-padded to bn = tile_n(C) outputs
    and kpad (C rounded up to 32) inputs, each half K-major in 8 x 4 core
    matrices: (co, ci) at ((co // 8) * 8 + ci // 4) * 32 + (co % 8) * 4 +
    ci % 4.  One pass per resblock."""
    bn = tile_n(c)
    kpad = -(-c // 32) * 32
    out = []
    for rb in weights:
        w = torch.stack([w for pair in rb for w, _ in pair])  # [n, k, C, C]
        n, k = w.shape[:2]
        w = F.pad(w, (0, bn - c, 0, kpad - c))
        # [n, k, chunk, ci // 4, ci % 4, co // 8, co % 8] -> core matrices
        w = w.view(n, k, kpad // 32, 8, 4, bn // 8, 8)
        w = w.permute(0, 1, 2, 5, 3, 6, 4).reshape(n, k, kpad // 32, -1)
        hi = _round_tf32(w)
        laid = iter(torch.stack([hi, _round_tf32(w - hi)], dim=3))
        out.append([tuple((next(laid), b) for _, b in pair) for pair in rb])
    return out


def _kernel_layout_bf16(weights: Weights, c: int):
    """The weights with each kernel [k, C, C] (tap, in, out) replaced by the
    bf16 image that the bf16 mode copies into shared memory chunk by chunk:
    [k, kpad / 32, 32 * bn], chunk (tap, ci0) = W[tap, ci0:ci0 + 32, :bn]
    as bf16, zero-padded as in :func:`_kernel_layout`, K-major in 8 x 8
    core matrices of 16 bytes: (co, ci) at ((co // 8) * 4 + ci // 8) * 64 +
    (co % 8) * 8 + ci % 8.  The biases stay f32."""
    bn = tile_n(c)
    kpad = -(-c // 32) * 32
    out = []
    for rb in weights:
        w = torch.stack([w for pair in rb for w, _ in pair])  # [n, k, C, C]
        n, k = w.shape[:2]
        w = F.pad(w, (0, bn - c, 0, kpad - c))
        # [n, k, chunk, ci // 8, ci % 8, co // 8, co % 8] -> core matrices
        w = w.view(n, k, kpad // 32, 4, 8, bn // 8, 8)
        w = w.permute(0, 1, 2, 5, 3, 6, 4).reshape(n, k, kpad // 32, -1)
        laid = iter(w.to(torch.bfloat16).contiguous())
        out.append([tuple((next(laid), b) for _, b in pair) for pair in rb])
    return out


def _launch_step(x, mask, w1, b1, w2, b2, out, *, k: int, d: int,
                 acc_in: Optional[torch.Tensor] = None, t_begin: int = 0,
                 t_len: Optional[int] = None, out_off: int = 0,
                 scale: float = 1.0) -> None:
    """One launch of ``csrc/mrf.cu``: the same step as mrf_step_plain, with
    w1 and w2 laid out by :func:`_kernel_layout`."""
    nb, length, c = x.shape
    status = library().ss_mrf_step(
        x.data_ptr(), mask.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(),
        None if acc_in is None else acc_in.data_ptr(), out.data_ptr(),
        nb, length, c, w1.shape[-1] // 32, k, d, t_begin,
        length - t_begin if t_len is None
        else t_len, out.shape[1], out_off, scale,
        torch.cuda.current_stream(x.device).cuda_stream)
    check(status, "fused_mrf_blocks")
    counter.add()


def _launch_step_bf16(x, mask, w1, b1, w2, b2, out, *, k: int, d: int,
                      acc_in: Optional[torch.Tensor] = None,
                      t_begin: int = 0, t_len: Optional[int] = None,
                      out_off: int = 0, scale: float = 1.0) -> None:
    """One launch of the bf16 mode: x, mask bf16, w1 and w2 laid out by
    :func:`_kernel_layout_bf16`, acc_in f32, out f32 or bf16."""
    nb, length, c = x.shape
    status = library().ss_mrf_step_bf16(
        x.data_ptr(), mask.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(),
        None if acc_in is None else acc_in.data_ptr(), out.data_ptr(),
        int(out.dtype == torch.float32), nb, length, c, w1.shape[-1] // 32,
        k, d, t_begin, length - t_begin if t_len is None else t_len,
        out.shape[1], out_off, scale,
        torch.cuda.current_stream(x.device).cuda_stream)
    check(status, "fused_mrf_blocks")
    counter_bf16.add()


def occupancy(c: int, k: int, d: int,
              compute_dtype: torch.dtype = torch.float32) -> Tuple[int, int]:
    """(blocks of the step kernel that fit on one SM, dynamic shared memory
    of one block in bytes) for C channels and a step of kernel k, dilation
    d (needs the card)."""
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    check(library().ss_mrf_occupancy(
        c, k, d, int(compute_dtype == torch.bfloat16), ctypes.byref(blocks),
        ctypes.byref(smem)), "occupancy")
    return blocks.value, smem.value


def _flat_weights(weights: Weights) -> List[torch.Tensor]:
    return [t for rb in weights for step in rb for wb in step for t in wb]


def _nested_weights(flat: Sequence[torch.Tensor], steps: Sequence[int]
                    ) -> Weights:
    """The inverse of :func:`_flat_weights`: ``steps`` dilation steps per
    resblock, four tensors (w1, b1, w2, b2) per step."""
    out, i = [], 0
    for n in steps:
        rb = []
        for _ in range(n):
            w1, b1, w2, b2 = flat[i:i + 4]
            rb.append(((w1, b1), (w2, b2)))
            i += 4
        out.append(rb)
    return out


def _op_kwargs(kernels: Sequence[int], dilations: Sequence[int],
               steps: Sequence[int], block: int, halo: int) -> dict:
    flat, dils = list(dilations), []
    for n in steps:
        dils.append(tuple(flat[:n]))
        flat = flat[n:]
    return dict(kernels=tuple(kernels), dilations=dils, block=block,
                halo=halo)


@torch.library.custom_op("stylesinger::fused_mrf_blocks", mutates_args=(),
                         device_types="cpu")
def _mrf_op(xb: torch.Tensor, mask: torch.Tensor,
            weights: List[torch.Tensor], kernels: List[int],
            dilations: List[int], steps: List[int], block: int,
            halo: int) -> torch.Tensor:
    """The registered operator behind :func:`fused_mrf_blocks`, so that
    ``torch.export`` records one graph node per call (``serving/export.py``).
    ``weights`` flat (w1, b1, w2, b2 per step), ``dilations`` flat with
    ``steps`` per resblock; the mode is xb's dtype.  CPU: the plain twin."""
    plain = mrf_blocks_plain_bf16 if xb.dtype == torch.bfloat16 \
        else mrf_blocks_plain
    return plain(xb, mask, _nested_weights(weights, steps),
                 **_op_kwargs(kernels, dilations, steps, block,
                              halo)).contiguous()


@_mrf_op.register_kernel("cuda")
def _mrf_op_cuda(xb, mask, weights, kernels, dilations, steps, block, halo):
    """CUDA: ``csrc/mrf.cu``, one counted launch per dilation step."""
    bf16 = xb.dtype == torch.bfloat16
    layout = _kernel_layout_bf16 if bf16 else _kernel_layout
    return mrf_schedule(xb, mask, layout(_nested_weights(weights, steps),
                                         xb.shape[2]),
                        step=_launch_step_bf16 if bf16 else _launch_step,
                        **_op_kwargs(kernels, dilations, steps, block, halo))


@_mrf_op.register_fake
def _mrf_op_fake(xb, mask, weights, kernels, dilations, steps, block, halo):
    return xb.new_empty((xb.shape[0], block, xb.shape[2]))


def fused_mrf_blocks(xb: torch.Tensor, mask: torch.Tensor, weights: Weights,
                     *, kernels: Sequence[int],
                     dilations: Sequence[Sequence[int]], block: int,
                     halo: int,
                     compute_dtype: torch.dtype = torch.float32
                     ) -> torch.Tensor:
    """Fused MRF group: xb [Nb, block + 2*halo, C] haloed blocks, mask
    [Nb, block + 2*halo, 1] -> [Nb, block, C] (mean of the resblocks,
    halo-cropped), all in ``compute_dtype`` (f32 or bf16; the weights and
    biases are f32).  CUDA tensor: the ``csrc/mrf.cu`` kernel, one launch
    per dilation step (:func:`mrf_schedule`); it has no backward, so it
    raises while autograd records a tensor that requires grad.  CPU
    tensor: the plain twin of that mode.  Either goes through the
    operator ``torch.ops.stylesinger.fused_mrf_blocks`` (its fake
    implementation gives ``torch.export`` the output's shape)."""
    if compute_dtype not in DTYPES:
        raise ValueError(f"fused_mrf_blocks: compute_dtype {compute_dtype} "
                         "is neither float32 nor bfloat16")
    if xb.device.type == "cpu":
        if xb.dtype != compute_dtype or mask.dtype != compute_dtype:
            raise ValueError(f"fused_mrf_blocks: xb and mask must be "
                             f"{compute_dtype}")
    elif xb.device.type == "cuda":
        refuse_autograd("fused_mrf_blocks", [xb, mask] +
                        _flat_weights(weights))
        _check_args(xb, mask, weights, kernels, dilations, block, halo,
                    compute_dtype)
    else:
        raise ValueError(f"fused_mrf_blocks: unsupported device {xb.device}")
    return _mrf_op(xb, mask, _flat_weights(weights), list(kernels),
                   [d for ds in dilations for d in ds],
                   [len(ds) for ds in dilations], block, halo)
