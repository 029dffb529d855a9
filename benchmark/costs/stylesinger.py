"""StyleSinger's work for one request, from the configuration's widths and
the request's true lengths: ``n_txt`` phones, ``n_ref`` reference frames
and ``n_frames`` predicted frames (not the buckets or the ``max_frames``
that the program pads to: padding is waste).

FLOP are 2 x the multiply-adds of the matrix products and convolutions
(what ``torch.utils.flop_counter`` counts) of the acoustic model's
inference pass (every denoiser call of both F0 chains and of the mel
chain, the FFT stacks, the style adaptor with its RQ distances, the
aligner) and of the vocoder (``costs/hifigan_nsf.py``).  The reference
front-end (log-mel, the F0 tracker, the GE2E encoders) is left out: it is
FFTs and recurrences that the counter does not count, and under 2 % of
the work.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Any, Dict

_spec = importlib.util.spec_from_file_location(
    "bench_costs_hifigan_nsf", Path(__file__).with_name("hifigan_nsf.py"))
vocoder = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(vocoder)

DVEC_DIM = 256


def _fft_layer(n: int, h: int, k: int) -> float:
    """One pre-LN self-attention + conv-FFN layer over n positions."""
    attn = 2.0 * n * h * 3 * h + 2 * (2.0 * n * n * h) + 2.0 * n * h * h
    ffn = 2.0 * n * h * 4 * h * k + 2.0 * n * 4 * h * h
    return attn + ffn


def _denoiser(n: int, c: int, cond: int, layers: int, in_proj: float,
              out_dims: int) -> float:
    """One call of a DiffWave stack over n frames; the step MLP's work is
    per row, not per frame."""
    block = 2.0 * n * (c * 2 * c * 3 + cond * 2 * c + c * 2 * c)
    mlp = 2.0 * (c * 4 * c + 4 * c * c) + layers * 2.0 * c * c
    return in_proj + layers * block + mlp + 2.0 * n * c * c \
        + 2.0 * n * c * out_dims


def acoustic_flops(cfg: Dict[str, Any], n_txt: int, n_ref: int,
                   n_frames: int, training: bool = False) -> float:
    """The inference pass; with ``training``, the training pass (the
    reference is the item's own mel, ``n_ref`` = ``n_frames``): one call
    of each denoiser (the diffusion losses at a drawn step), UMLN's affine
    and the codebooks' EMA statistics."""
    h = cfg["hidden_size"]
    m = cfg["audio_num_mel_bins"]
    L, R, T = n_txt, n_ref, n_frames
    f = cfg["enc_layers"] * _fft_layer(L, h, cfg["enc_ffn_kernel_size"])
    f += 2.0 * L * h                                    # note durations
    f += 2 * 2.0 * DVEC_DIM * h                         # spk, emo
    ph = cfg["predictor_hidden"] if cfg["predictor_hidden"] > 0 else h
    k = cfg["dur_predictor_kernel"]
    f += 2.0 * L * h * ph * k + (cfg["dur_predictor_layers"] - 1) \
        * 2.0 * L * ph * ph * k + 2.0 * L * ph
    # style adaptor: WN (k 3) over the mel, conv blocks (k 5), RQ
    wn = cfg.get("style_wn_layers", 4)
    f += wn * 2.0 * R * m * 2 * m * 3 + (wn - 1) * 2.0 * R * m * 2 * m \
        + 2.0 * R * m * m
    blocks = len(cfg.get("style_conv_dilations", (1, 1, 1, 1, 1)))
    f += blocks * 2 * (2.0 * R * m * 2 * m * 5 + 2.0 * R * 2 * m * m)
    f += 2.0 * R * m * h * 3                            # post conv
    f += cfg["rq_depth"] * 2.0 * R * h * cfg["nRQ"] * (2 if training
                                                       else 1)
    if training and cfg["umln"]:
        f += 2.0 * h * 2 * h                            # UMLN affine
    f += 2.0 * R * 2 * h * h                            # l1
    a = cfg["aligner_ffn_dim"]
    f += cfg["aligner_layers"] * (
        2 * 2.0 * T * h * h + 2 * 2.0 * R * h * h + 2 * 2.0 * T * R * h
        + 2 * 2.0 * T * h * a)
    # two F0 chains of f0_timesteps calls each
    c0 = cfg["f0_residual_channels"]
    calls = 1 if training else len(range(cfg["f0_timesteps"] - 1, -1,
                                         -int(cfg.get("f0_speedup", 1))))
    f += 2 * calls * _denoiser(T, c0, h, cfg["f0_residual_layers"],
                               2.0 * T * (c0 // 2), 3)
    f += cfg["dec_layers"] * _fft_layer(T, h, cfg["dec_ffn_kernel_size"])
    f += 2.0 * T * h * m                                # mel_out
    n_cond = m + (h if cfg["use_txt_cond"] else 0) + h \
        + (h if cfg["emo"] else 0) + (h if cfg["style"] else 0)
    f += 2.0 * T * n_cond * h                           # ln_proj
    c1 = cfg["residual_channels"]
    f += (1 if training else cfg["K_step"]) * _denoiser(
        T, c1, h, cfg["residual_layers"], 2.0 * T * m * c1, m)
    return f


def batch_lengths(stacked) -> list:
    """(phones, frames) of every item of every batch of a device-resident
    epoch ([batches, rows, ...]; padding rows read (0, 0))."""
    txt = (stacked["txt_tokens"] > 0).sum(-1).tolist()
    mel = (stacked["mel2ph"] > 0).sum(-1).tolist()
    return [list(zip(t, f)) for t, f in zip(txt, mel)]


def train_step_flops(cfg: Dict[str, Any], lengths) -> float:
    """3 x the training pass's FLOP over the items' true lengths (the
    backward pass taken as twice the forward)."""
    return 3.0 * sum(acoustic_flops(cfg, n_txt, t, t, training=True)
                     for n_txt, t in lengths if t)


def ref_frames(cfg: Dict[str, Any], n_samples: int) -> int:
    """Log-mel frames of a recording of ``n_samples`` samples."""
    return 1 + n_samples // cfg["hop_size"]


def request_flops(cfg: Dict[str, Any], n_txt: int, n_ref: int,
                  n_frames: int) -> float:
    return acoustic_flops(cfg, n_txt, n_ref, n_frames) + (
        vocoder.vocoder_flops(cfg, n_frames) if n_frames else 0.0)


def mrf_bound_s(cfg: Dict[str, Any], n_frames: int) -> float:
    """The least time of the MRF groups the kernel takes in one vocoder
    call (``costs/hifigan_nsf.py``)."""
    if not n_frames:
        return 0.0
    return vocoder.bound_s(*vocoder.mrf_work(cfg, n_frames,
                                             vocoder.kernel_takes(cfg)))
