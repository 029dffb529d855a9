"""Losses of acoustic-model training (frozen from the port's ``training/losses.py``).

- mel: the weighted mix of ``"l1:0.5|ssim:0.5"``, each masked to frames
  whose target is nonzero; SSIM on +6-biased spectrograms with an 11-tap
  Gaussian window applied separably;
- duration: MSE of log(dur + 1) per phone, and the log-domain word and
  sentence sums;
- pitch (conv ``f0_gen`` only): uv BCE and voiced-masked f0 L1/MSE;
- :func:`compute_losses`: the loss dict of one step, gated by the
  curriculum flags;
- :func:`multi_resolution_stft_loss`: the PWG vocoder's auxiliary loss.

Every function maps (outputs, batch) to scalars; masks are explicit.  In
a data-parallel step (``parallel/mesh.py``) every denominator and batch mean
is global: each rank's loss is its share of the loss of the global batch.
The masks that denominators count are all the batch's own, so
:func:`batch_sums` sums them up front, and the step sums them over the
ranks in one collective.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import numpy as np
import torch

from .align import mel2ph_to_dur
from .mel import _hann_periodic
from .local import global_mean, global_sum


def _gaussian_1d(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur1d(x: torch.Tensor, g: np.ndarray, dim: int) -> torch.Tensor:
    """Zero-padded ("SAME") 1-D blur along ``dim`` as shifted adds."""
    half = len(g) // 2
    n = x.shape[dim]
    pad = [0, 0] * (x.ndim - dim - 1) + [half, half]
    xp = torch.nn.functional.pad(x, pad)
    out = None
    for i, w in enumerate(g):
        term = float(w) * xp.narrow(dim, i, n)
        out = term if out is None else out + term
    return out


def _filter2d(img: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Gaussian-window filter of [B, H, W] images, zero padded: the 11 x 11
    window is an outer product, applied as two 1-D passes."""
    g = _gaussian_1d(window_size)
    return _blur1d(_blur1d(img, g, 1), g, 2)


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """Per-pixel SSIM map of [B, T, M] images."""
    mu1 = _filter2d(img1, window_size)
    mu2 = _filter2d(img2, window_size)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _filter2d(img1 * img1, window_size) - mu1_sq
    sigma2_sq = _filter2d(img2 * img2, window_size) - mu2_sq
    sigma12 = _filter2d(img1 * img2, window_size) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return ((2 * mu12 + c1) * (2 * sigma12 + c2)) / \
        ((mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))


def parse_mel_loss(spec: str) -> Dict[str, float]:
    """``"l1:0.5|ssim:0.5"`` -> {'l1': 0.5, 'ssim': 0.5}."""
    out: Dict[str, float] = {}
    for part in spec.split("|"):
        if ":" in part:
            name, lbd = part.split(":")
            out[name] = float(lbd)
        else:
            out[part] = 1.0
    return out


def _nonzero_weights(target: torch.Tensor) -> torch.Tensor:
    """[B, T, M] mask of frames with a nonzero target, over the mel bins."""
    mask = (target.abs().sum(-1) > 0).to(target.dtype)
    return mask[..., None].expand_as(target)


def mel_losses(mel_out: torch.Tensor, target: torch.Tensor,
               loss_spec: str, postfix: str = "") -> Dict[str, torch.Tensor]:
    w = _nonzero_weights(target)
    denom = torch.clamp_min(global_sum(w.sum(), "mel_weights"), 1.0)
    out = {}
    for name, lbd in parse_mel_loss(loss_spec).items():
        if name == "l1":
            loss = ((mel_out - target).abs() * w).sum() / denom
        elif name == "mse":
            loss = (((mel_out - target) ** 2) * w).sum() / denom
        elif name == "ssim":
            s = ssim(mel_out + 6.0, target + 6.0)
            loss = ((1.0 - s) * w).sum() / denom
        else:
            raise ValueError(name)
        out[f"{name}{postfix}"] = loss * lbd
    return out


def _dur_gt(mel2ph: torch.Tensor, txt_tokens: torch.Tensor):
    """(phone nonpadding, ground-truth phone durations), [B, T_txt]."""
    nonpadding = (txt_tokens > 0).to(torch.float32)
    return nonpadding, mel2ph_to_dur(mel2ph, txt_tokens.shape[1]).to(
        torch.float32) * nonpadding


def _word_sum(v: torch.Tensor, is_sil: torch.Tensor) -> torch.Tensor:
    """Per-phone values [B, T_txt] summed per word (phones between
    silences), [B, T_txt]."""
    word_id = (torch.cumsum(is_sil, -1) * (1 - is_sil)).long()
    return torch.zeros((v.shape[0], v.shape[1] + 1), dtype=v.dtype,
                       device=v.device).scatter_add(1, word_id, v)[:, 1:]


def _word_durs(mel2ph, txt_tokens, is_sil) -> tuple:
    """(phone nonpadding, the ground-truth word durations)."""
    nonpadding, dur_gt = _dur_gt(mel2ph, txt_tokens)
    return nonpadding, _word_sum(dur_gt, is_sil)


def duration_losses(log_dur_pred: torch.Tensor, mel2ph: torch.Tensor,
                    txt_tokens: torch.Tensor, cfg: Any,
                    is_sil: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
    nonpadding, dur_gt = _dur_gt(mel2ph, txt_tokens)
    out = {}
    pdur = (log_dur_pred - torch.log(dur_gt + 1.0)) ** 2
    out["pdur"] = (pdur * nonpadding).sum() / torch.clamp_min(
        global_sum(nonpadding.sum(), "tokens"), 1.0) * cfg["lambda_ph_dur"]

    dur_pred = torch.clamp_min(torch.exp(log_dur_pred) - 1.0, 0.0)
    if cfg["lambda_word_dur"] > 0 and is_sil is not None:
        wp, wg = _word_sum(dur_pred, is_sil), _word_sum(dur_gt, is_sil)
        wmask = (wg > 0).to(torch.float32)
        wdur = (torch.log(wp + 1) - torch.log(wg + 1)) ** 2
        out["wdur"] = (wdur * wmask).sum() / torch.clamp_min(
            global_sum(wmask.sum(), "words"), 1.0) * cfg["lambda_word_dur"]
    if cfg["lambda_sent_dur"] > 0:
        sp, sg = dur_pred.sum(-1), dur_gt.sum(-1)
        out["sdur"] = global_mean(
            (torch.log(sp + 1) - torch.log(sg + 1)) ** 2) * \
            cfg["lambda_sent_dur"]
    return out


def f0_uv_losses(pitch_pred: torch.Tensor, f0: torch.Tensor,
                 uv: torch.Tensor, nonpadding: torch.Tensor, cfg: Any,
                 postfix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    if cfg["use_uv"] and cfg["pitch_type"] == "frame":
        logits = pitch_pred[:, :, 1]
        bce = torch.clamp_min(logits, 0) - logits * uv + \
            torch.log1p(torch.exp(-logits.abs()))
        out[f"uv{postfix}"] = (bce * nonpadding).sum() / torch.clamp_min(
            global_sum(nonpadding.sum(), "frames"), 1.0) * cfg["lambda_uv"]
        nonpadding = nonpadding * (uv == 0).to(nonpadding.dtype)
        key = "voiced"
    else:
        key = "frames"
    f0_pred = pitch_pred[:, :, 0]
    if cfg["pitch_loss"] in ("l1", "l2"):
        err = (f0_pred - f0).abs() if cfg["pitch_loss"] == "l1" else \
            (f0_pred - f0) ** 2
        out[f"f0{postfix}"] = (err * nonpadding).sum() / torch.clamp_min(
            global_sum(nonpadding.sum(), key), 1.0) * cfg["lambda_f0"]
    return out


def batch_sums(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The sums of the batch's masks that the training losses divide by,
    by the ``key`` each passes to :func:`global_sum`.  The masks are zero
    where a batch is padded.

    - ``mel_weights``: the mel loss's weights (frames with a nonzero target,
      over the mel bins);
    - ``tokens``: phones (``txt_tokens > 0``): the phone duration loss;
    - ``words``: words with a nonzero duration: the word duration loss;
    - ``frames``: frames (``mel2ph > 0``): uv, f0 without uv, and the mel
      diffusion's loss (over the mel bins);
    - ``voiced``: frames with ``uv == 0``: f0 with uv, the f0 diffusion's
      Gaussian loss;
    - ``ref_frames``: the style reference's frames (the item's own mel,
      ``|mel[:, :, 0]| > 1e-8``): the RQ commitment loss (over the
      channels);
    - ``aligned_pairs``: (frame, reference frame) pairs of each item: the
      aligner's guided-attention loss."""
    frames = (batch["mel2ph"] > 0).to(torch.float32)
    ref = (batch["mels"][:, :, 0].abs() > 1e-8).to(torch.float32)
    out = {
        "mel_weights": _nonzero_weights(batch["mels"]).sum(),
        "tokens": (batch["txt_tokens"] > 0).to(torch.float32).sum(),
        "frames": frames.sum(),
        "voiced": (frames * (batch["uv"] == 0).to(torch.float32)).sum(),
        "ref_frames": ref.sum(),
        "aligned_pairs": (frames.sum(-1) * ref.sum(-1)).sum(),
    }
    if batch.get("is_sil") is not None:
        _, wg = _word_durs(batch["mel2ph"], batch["txt_tokens"],
                           batch["is_sil"])
        out["words"] = (wg > 0).to(torch.float32).sum()
    return out


def compute_losses(ret: Dict, batch: Dict, cfg: Any, *, use_rq: bool,
                   forcing: bool, use_diff: bool) -> Dict[str, torch.Tensor]:
    """All losses of one StyleSinger step, in the JAX package's order."""
    losses: Dict[str, torch.Tensor] = {}
    if cfg["decoder"] == "diffsinger" and use_diff:
        losses["diff"] = ret["diff_loss"]
    if cfg["style"]:
        if not forcing:
            losses["gloss"] = ret["gloss"]
        if use_rq:
            losses["rq_loss"] = ret["rq_loss"]
    losses.update(mel_losses(ret["mel_out"], batch["mels"], cfg["mel_loss"]))
    losses.update(duration_losses(ret["dur"], batch["mel2ph"],
                                  batch["txt_tokens"], cfg,
                                  is_sil=batch.get("is_sil")))
    if cfg["f0_gen"] == "gmdiff":
        for k in ("gdiff1", "mdiff1", "gdiff2", "mdiff2"):
            losses[k] = ret[k]
    else:
        nonpadding = (batch["mel2ph"] > 0).to(torch.float32)
        losses.update(f0_uv_losses(ret["pitch_pred"], batch["f0"],
                                   batch["uv"], nonpadding, cfg))
    return losses


# ---------------------------------------------------------------------------
# Multi-resolution STFT loss (the PWG vocoder's auxiliary loss)
# ---------------------------------------------------------------------------

def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``jnp.pad(x, pad, mode="reflect")`` on the last axis, also where
    ``pad`` reaches the length T (numpy reflects again, so the index runs
    as a triangle wave of period 2 (T - 1); ``F.pad`` refuses it)."""
    t = x.shape[-1]
    i = torch.remainder(torch.arange(-pad, t + pad, device=x.device),
                        2 * (t - 1))
    return x[..., torch.where(i < t, i, 2 * (t - 1) - i)]


@functools.lru_cache(maxsize=16)
def _stft_window(fft_size: int, win_length: int,
                 device: torch.device) -> torch.Tensor:
    """A periodic Hann of ``win_length`` centred in ``fft_size``, made once
    per device (a CUDA graph of a step cannot copy it from the host)."""
    lpad = (fft_size - win_length) // 2
    return torch.nn.functional.pad(
        torch.as_tensor(_hann_periodic(win_length), device=device),
        (lpad, fft_size - win_length - lpad))


def _stft_mag_torchlike(x: torch.Tensor, fft_size: int, hop_size: int,
                        win_length: int) -> torch.Tensor:
    """|STFT| as ``torch.stft(center=True)`` frames it (reflect padding, a
    periodic Hann of ``win_length`` centred in the frame), clamped at
    1e-7 in power."""
    xp = reflect_pad(x, fft_size // 2)
    frames = xp.unfold(-1, fft_size, hop_size)
    window = _stft_window(fft_size, win_length, x.device)
    mag = torch.fft.rfft(frames * window, n=fft_size, dim=-1).abs()
    return torch.sqrt(torch.clamp_min(mag * mag, 1e-7))


def stft_loss(x: torch.Tensor, y: torch.Tensor, fft_size: int,
              hop_size: int, win_length: int):
    """(spectral convergence, log-magnitude L1) of predicted wavs ``x``
    against ground truth ``y``, both [B, T]."""
    x_mag = _stft_mag_torchlike(x, fft_size, hop_size, win_length)
    y_mag = _stft_mag_torchlike(y, fft_size, hop_size, win_length)
    sc = torch.linalg.norm(y_mag - x_mag) / torch.clamp_min(
        torch.linalg.norm(y_mag), 1e-12)
    mag = (torch.log(y_mag) - torch.log(x_mag)).abs().mean()
    return sc, mag


def multi_resolution_stft_loss(x: torch.Tensor, y: torch.Tensor,
                               fft_sizes=(1024, 2048, 512),
                               hop_sizes=(120, 240, 50),
                               win_lengths=(600, 1200, 240)):
    """Mean (spectral convergence, log-magnitude L1) over the three
    resolutions of the reference's ``MultiResolutionSTFTLoss``."""
    sc_sum, mag_sum = 0.0, 0.0
    for fs, hs, wl in zip(fft_sizes, hop_sizes, win_lengths):
        sc, mag = stft_loss(x, y, fs, hs, wl)
        sc_sum = sc_sum + sc
        mag_sum = mag_sum + mag
    n = float(len(fft_sizes))
    return sc_sum / n, mag_sum / n
