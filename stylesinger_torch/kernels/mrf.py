"""HiFi-GAN MRF group over overlap-save blocks: CUDA kernel and plain twin.

Counterpart of ``stylesinger_tpu/ops/mrf_pallas.py::fused_mrf_blocks``.  One
MRF group is 3 ``ResBlock1`` (kernels 3/7/11, dilations 1/3/5): per dilation
``x += conv(lrelu(conv_d(lrelu(x) * m)) * m)``, then the mean of the blocks'
outputs, cropped to the block's centre.  The mask ``m`` carries the SAME
zero padding at the true sequence ends (``models/hifigan._blockify``).

On a CUDA tensor :func:`fused_mrf_blocks` launches ``csrc/mrf.cu`` once per
conv (18 launches for the flagship group); residual adds, the block mean
and the halo crop ride in the kernel's epilogue.  On a CPU tensor it runs
:func:`mrf_blocks_plain`, the same arithmetic in plain PyTorch.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from stylesinger_torch.kernels._build import LaunchCounter, check, library

LRELU_SLOPE = 0.1
MAX_REACH = 64  # the kernel stages (k - 1) * d <= 64 extra rows
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


def _conv(lib, stream, x, mask, w, b, out, *, k: int, d: int,
          res: Optional[torch.Tensor] = None,
          acc_in: Optional[torch.Tensor] = None, t_begin: int = 0,
          t_len: Optional[int] = None, out_off: int = 0,
          scale: float = 1.0) -> None:
    nb, length, c = x.shape
    status = lib.ss_mrf_conv(
        x.data_ptr(), mask.data_ptr(), w.data_ptr(), b.data_ptr(),
        None if res is None else res.data_ptr(),
        None if acc_in is None else acc_in.data_ptr(), out.data_ptr(),
        nb, length, c, k, d, t_begin, length if t_len is None else t_len,
        out.shape[1], out_off, scale, stream)
    check(status, "fused_mrf_blocks")
    counter.count += 1


def fused_mrf_blocks(xb: torch.Tensor, mask: torch.Tensor, weights: Weights,
                     *, kernels: Sequence[int],
                     dilations: Sequence[Sequence[int]], block: int,
                     halo: int) -> torch.Tensor:
    """Fused MRF group: xb [Nb, block + 2*halo, C] haloed blocks, mask
    [Nb, block + 2*halo, 1] -> [Nb, block, C] (mean of the resblocks,
    halo-cropped).  CUDA tensor: the ``csrc/mrf.cu`` kernel, one launch per
    conv.  CPU tensor: the plain twin."""
    if xb.device.type == "cpu":
        return mrf_blocks_plain(xb, mask, weights, kernels=kernels,
                                dilations=dilations, block=block, halo=halo)
    if xb.device.type != "cuda":
        raise ValueError(f"fused_mrf_blocks: unsupported device {xb.device}")
    _check_args(xb, mask, weights, kernels, dilations, block, halo)
    lib = library()
    stream = torch.cuda.current_stream(xb.device).cuda_stream
    h = torch.empty_like(xb)      # output of the dilated conv
    xj = torch.empty_like(xb)     # running residual stream of a resblock
    acc = torch.empty_like(xb)    # running sum of resblock outputs
    out = torch.empty((xb.shape[0], block, xb.shape[2]), dtype=xb.dtype,
                      device=xb.device)
    n_blocks = len(kernels)
    for j, (rb, k, dils) in enumerate(zip(weights, kernels, dilations)):
        cur = xb
        for i, (((w1, b1), (w2, b2)), d) in enumerate(zip(rb, dils)):
            _conv(lib, stream, cur, mask, w1, b1, h, k=k, d=d)
            if i < len(dils) - 1:
                _conv(lib, stream, h, mask, w2, b2, xj, k=k, d=1, res=cur)
                cur = xj
            elif j == n_blocks - 1:
                _conv(lib, stream, h, mask, w2, b2, out, k=k, d=1, res=cur,
                      acc_in=acc if j > 0 else None, t_begin=halo,
                      t_len=block, out_off=halo, scale=1.0 / n_blocks)
            else:
                _conv(lib, stream, h, mask, w2, b2, acc, k=k, d=1, res=cur,
                      acc_in=acc if j > 0 else None)
    return out
