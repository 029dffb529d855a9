"""The NSF HiFi-GAN generator's work for a mel of T frames.

FLOP are 2 x the multiply-adds of its matrix products and convolutions
(what ``torch.utils.flop_counter`` counts), over the true rows of each
stage: no overlap-save halo and no padding.  Elementwise work (the
activations, the sine bank) is left out.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

PEAK_BF16_FLOPS = 989e12   # H100 SXM, dense bf16 on the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM, HBM3


def stages(cfg: Dict[str, Any], n_frames: int) -> List[Tuple[int, int]]:
    """(channels, samples) of each upsampling stage's output."""
    out = []
    for i in range(len(cfg["upsample_rates"])):
        c = cfg["upsample_initial_channel"] // 2 ** (i + 1)
        t = n_frames * int(np.prod(cfg["upsample_rates"][: i + 1]))
        out.append((c, t))
    return out


def mrf_taps(cfg: Dict[str, Any]) -> int:
    """Kernel taps of one MRF group per channel pair: two convs per
    dilation of each resblock (126 for kernels 3/7/11 x dilations 1/3/5)."""
    return sum(2 * k * len(d) for k, d in zip(cfg["resblock_kernel_sizes"],
                                             cfg["resblock_dilation_sizes"]))


def vocoder_flops(cfg: Dict[str, Any], n_frames: int) -> float:
    rates = cfg["upsample_rates"]
    ch0 = cfg["upsample_initial_channel"]
    m = cfg["audio_num_mel_bins"]
    flops = 2.0 * n_frames * m * ch0 * 7                       # conv_pre
    t_in, c_in = n_frames, ch0
    for i, ((c, t), k) in enumerate(zip(stages(cfg, n_frames),
                                        cfg["upsample_kernel_sizes"])):
        flops += 2.0 * t_in * c_in * c * k                     # up_i
        if cfg.get("use_nsf", True):
            s = int(np.prod(rates[i + 1:]))
            taps = 2 * s if i + 1 < len(rates) else 1
            flops += 2.0 * t * c * taps                        # noise_conv_i
        flops += 2.0 * t * c * c * mrf_taps(cfg)               # MRF group
        t_in, c_in = t, c
    flops += 2.0 * t_in * c_in * 7                             # conv_post
    if cfg.get("use_nsf", True):
        flops += 2.0 * t_in * (cfg.get("harmonic_num", 8) + 1)  # merge
    return flops


def mrf_work(cfg: Dict[str, Any], n_frames: int,
             takes: Any = None) -> Tuple[float, float]:
    """(FLOP, bytes) of the MRF groups that the kernel takes (``takes(c,
    t)`` -> bool; default: every stage), each input and output byte once
    at the compute dtype's width, the weights and biases once."""
    elem = 2 if cfg.get("vocoder_compute_dtype") == "bfloat16" else 4
    taps = mrf_taps(cfg)
    n_convs = sum(2 * len(d) for d in cfg["resblock_dilation_sizes"])
    flops = nbytes = 0.0
    for c, t in stages(cfg, n_frames):
        if takes is not None and not takes(c, t):
            continue
        flops += 2.0 * t * c * c * taps
        nbytes += elem * (2.0 * t * c + taps * c * c + n_convs * c)
    return flops, nbytes


def kernel_takes(cfg: Dict[str, Any]):
    """The MRF kernel's share of the stages, by the generator's routing
    rule: ``ResBlock1``, C <= 128, every reach (k - 1) * d <= 64, and a
    stage at least two ``mrf_block`` samples long."""
    reach_ok = all((k - 1) * d <= 64
                   for k, ds in zip(cfg["resblock_kernel_sizes"],
                                    cfg["resblock_dilation_sizes"])
                   for d in ds)
    block = int(cfg.get("mrf_block", 2048))

    def takes(c: int, t: int) -> bool:
        return (str(cfg.get("resblock", "1")) == "1" and reach_ok
                and c <= 128 and bool(block) and t >= 2 * block)
    return takes


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the bf16 peak's
    and the bandwidth's."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)
