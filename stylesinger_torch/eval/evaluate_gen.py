"""Objective evaluation of a generation directory (port of
``stylesinger_tpu/eval/evaluate_gen.py``).

Given ``<gen_dir>/wavs`` with ``X.wav`` / ``X_gt.wav`` pairs (as
``training/test_runner.py::TestRunner`` writes them with ``save_gt``), it
computes per pair the MCD of the log-mels (``dsp/mel.py::wav2spec``: the
mel kernel on the card) and the FFE of the F0 tracks
(``dsp/pitch.py::extract_pitch``), with a speaker encoder also the
d-vector cosine, and writes ``<gen_dir>/metrics.json``.

CLI: ``python -m stylesinger_torch.eval.evaluate_gen <gen_dir> [--sr 48000]
[--spk_encoder global.pt] [--device cuda]``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from stylesinger_torch.convert import from_jax_params, load_ge2e_checkpoint
from stylesinger_torch.dsp.mel import load_wav, wav2spec
from stylesinger_torch.dsp.pitch import extract_pitch
from stylesinger_torch.eval.metrics import ffe, mcd, speaker_cosine
from stylesinger_torch.inference import resolve_device
from stylesinger_torch.models.encoders import UtteranceEncoder


def evaluate_pair(wav_fn: str, gt_fn: str, sr: int,
                  cfg: Optional[Any] = None,
                  device: Union[str, torch.device] = "cuda"
                  ) -> Dict[str, float]:
    """MCD and FFE of ``wav_fn`` against ``gt_fn``, both read at ``sr``;
    the mel's settings from ``cfg`` (``wav2spec``'s defaults without)."""
    device = resolve_device(device)
    kw = {}
    if cfg is not None:
        kw = dict(sample_rate=cfg["audio_sample_rate"],
                  n_fft=cfg["fft_size"], hop_size=cfg["hop_size"],
                  win_length=cfg["win_size"],
                  n_mels=cfg["audio_num_mel_bins"], fmin=cfg["fmin"],
                  fmax=cfg["fmax"])
    hop = kw.get("hop_size", 256)
    a = load_wav(wav_fn, sr)
    b = load_wav(gt_fn, sr)
    mel_a = wav2spec(a, device, **kw)["mel"].cpu().numpy()
    mel_b = wav2spec(b, device, **kw)["mel"].cpu().numpy()
    f0_a = extract_pitch(a, hop_size=hop, sample_rate=sr, device=device)
    f0_b = extract_pitch(b, hop_size=hop, sample_rate=sr, device=device)
    return {"mcd": mcd(mel_b, mel_a), "ffe": ffe(f0_b, f0_a)}


def evaluate_dir(gen_dir: str, sr: int = 48000, cfg: Optional[Any] = None,
                 spk_encoder_path: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda"
                 ) -> Dict[str, float]:
    """Per-pair MCD and FFE and their means; with ``spk_encoder_path`` (a
    GE2E / resemblyzer torch checkpoint) also the paper's Cosine, the
    d-vector similarity of each generated wav to its ground truth."""
    device = resolve_device(device)
    spk_enc = None
    if spk_encoder_path:
        spk_enc = UtteranceEncoder()
        spk_enc.load_state_dict(from_jax_params(
            load_ge2e_checkpoint(spk_encoder_path, map_location=device)))
        spk_enc.to(device).eval()
    wav_dir = os.path.join(gen_dir, "wavs")
    rows: List[Dict] = []
    for fn in sorted(os.listdir(wav_dir)):
        if fn.endswith("_gt.wav") or not fn.endswith(".wav"):
            continue
        gt = os.path.join(wav_dir, fn.replace(".wav", "_gt.wav"))
        if not os.path.exists(gt):
            continue
        m = evaluate_pair(os.path.join(wav_dir, fn), gt, sr, cfg, device)
        if spk_enc is not None:
            m["spk_cos"] = speaker_cosine(
                load_wav(os.path.join(wav_dir, fn), sr), load_wav(gt, sr),
                sr, spk_enc)
        m["item"] = fn
        rows.append(m)
    if not rows:
        return {"n": 0}
    out = {
        "n": len(rows),
        "mcd_mean": float(np.nanmean([r["mcd"] for r in rows])),
        "ffe_mean": float(np.nanmean([r["ffe"] for r in rows])),
    }
    if spk_enc is not None:
        out["spk_cos_mean"] = float(np.nanmean([r["spk_cos"] for r in rows]))
    with open(os.path.join(gen_dir, "metrics.json"), "w") as f:
        json.dump({"summary": out, "items": rows}, f, indent=2)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("stylesinger_torch.eval.evaluate_gen")
    ap.add_argument("gen_dir")
    ap.add_argument("--sr", type=int, default=48000)
    ap.add_argument("--spk_encoder", default=None,
                    help="GE2E / resemblyzer torch checkpoint; adds the "
                    "paper's objective Cosine (d-vector similarity)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises when absent) or cpu")
    a = ap.parse_args(argv)
    print(json.dumps(evaluate_dir(a.gen_dir, a.sr,
                                  spk_encoder_path=a.spk_encoder,
                                  device=a.device)))


if __name__ == "__main__":
    main()
