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
schedule can be checked without the card.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from stylesinger_torch.kernels._build import LaunchCounter, check, library

LRELU_SLOPE = 0.1
MAX_REACH = 64  # the kernel stages (k - 1) * d <= 64 extra rows
MAX_C = 128     # a thread block holds all channels of its rows
counter = LaunchCounter()

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


def _check_args(xb, mask, weights, kernels, dilations, block, halo) -> None:
    if xb.dtype != torch.float32 or xb.ndim != 3:
        raise ValueError("fused_mrf_blocks: xb must be float32 [Nb, L, C], "
                         f"got {xb.dtype} {tuple(xb.shape)}")
    nb, length, c = xb.shape
    if c > MAX_C:
        raise ValueError(f"fused_mrf_blocks: C={c} > {MAX_C}")
    if length != block + 2 * halo:
        raise ValueError(f"fused_mrf_blocks: L={length} != block + 2*halo")
    if tuple(mask.shape) != (nb, length, 1) or mask.dtype != torch.float32:
        raise ValueError("fused_mrf_blocks: mask must be float32 "
                         f"[{nb}, {length}, 1], got {tuple(mask.shape)}")
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
    for t in tensors:
        if t.device != xb.device or t.dtype != torch.float32:
            raise ValueError("fused_mrf_blocks: all tensors must be float32 "
                             f"on {xb.device}")
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
    default; a test swaps in TF32-rounded ones)."""
    t_len = x.shape[1] - t_begin if t_len is None else t_len
    xt = x.transpose(1, 2)
    m = mask.transpose(1, 2)
    y = conv(F.leaky_relu(xt, LRELU_SLOPE) * m, w1.permute(2, 1, 0),
             padding=(k - 1) // 2 * d, dilation=d)
    h = F.leaky_relu(y + b1[:, None], LRELU_SLOPE) * m
    y = conv(h, w2.permute(2, 1, 0), padding=(k - 1) // 2, dilation=1)
    v = (xt + (y + b2[:, None])).transpose(1, 2)[:, t_begin:t_begin + t_len]
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
    running block sum; the last step of the group adds the sum, scales by
    1 / len(kernels) and writes only the halo-cropped centre."""
    ping, pong, acc = (torch.empty_like(xb) for _ in range(3))
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
    counter.count += 1


def fused_mrf_blocks(xb: torch.Tensor, mask: torch.Tensor, weights: Weights,
                     *, kernels: Sequence[int],
                     dilations: Sequence[Sequence[int]], block: int,
                     halo: int) -> torch.Tensor:
    """Fused MRF group: xb [Nb, block + 2*halo, C] haloed blocks, mask
    [Nb, block + 2*halo, 1] -> [Nb, block, C] (mean of the resblocks,
    halo-cropped).  CUDA tensor: the ``csrc/mrf.cu`` kernel, one launch per
    dilation step (:func:`mrf_schedule`).  CPU tensor: the plain twin."""
    if xb.device.type == "cpu":
        return mrf_blocks_plain(xb, mask, weights, kernels=kernels,
                                dilations=dilations, block=block, halo=halo)
    if xb.device.type != "cuda":
        raise ValueError(f"fused_mrf_blocks: unsupported device {xb.device}")
    _check_args(xb, mask, weights, kernels, dilations, block, halo)
    return mrf_schedule(xb, mask, _kernel_layout(weights, xb.shape[2]),
                        kernels=kernels,
                        dilations=dilations, block=block, halo=halo,
                        step=_launch_step)
