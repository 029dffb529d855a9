"""Objective evaluation metrics (port of ``stylesinger_tpu/eval/metrics.py``).

- ``compute_eer``: the equal error rate of speaker or emotion
  verification scores (the reference's ``test_emotion.py`` through
  sklearn's ROC; here a self-contained numpy ROC);
- ``ffe`` (F0 frame error) and ``mcd`` (mel-cepstral distortion), the
  paper's objective metrics;
- ``cosine`` and ``speaker_cosine``: the paper's timbre similarity, the
  cosine of two GE2E d-vectors.

Pure numpy but for ``speaker_cosine``, which runs the encoder where its
weights are.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from stylesinger_torch.models.encoders import UtteranceEncoder, preprocess_wav


def compute_eer(scores: np.ndarray, labels: np.ndarray
                ) -> Tuple[float, float]:
    """Equal error rate from similarity scores (label 1 = same class).
    Returns (eer, threshold)."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels).astype(bool)
    order = np.argsort(-scores)
    s = scores[order]
    lab = labels[order]
    tp = np.cumsum(lab)
    fp = np.cumsum(~lab)
    fn = lab.sum() - tp
    tn = (~lab).sum() - fp
    fpr = fp / np.maximum(fp + tn, 1)
    fnr = fn / np.maximum(fn + tp, 1)
    i = int(np.argmin(np.abs(fpr - fnr)))
    return float((fpr[i] + fnr[i]) / 2), float(s[i])


def ffe(f0_ref: np.ndarray, f0_pred: np.ndarray, tol: float = 0.2) -> float:
    """F0 frame error: the share of frames with a voicing error or a pitch
    more than ``tol`` off."""
    n = min(len(f0_ref), len(f0_pred))
    a, b = np.asarray(f0_ref[:n]), np.asarray(f0_pred[:n])
    va, vb = a > 0, b > 0
    voicing_err = va != vb
    both = va & vb
    pitch_err = np.zeros(n, bool)
    pitch_err[both] = np.abs(b[both] - a[both]) > tol * a[both]
    return float((voicing_err | pitch_err).mean()) if n else float("nan")


def cosine(a: np.ndarray, b: np.ndarray) -> float:
    """Cosine similarity of two embedding vectors."""
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    denom = max(float(np.linalg.norm(a) * np.linalg.norm(b)), 1e-12)
    return float(np.dot(a, b) / denom)


def speaker_cosine(wav_a: np.ndarray, wav_b: np.ndarray, sr: int,
                   encoder: UtteranceEncoder) -> float:
    """d-vector cosine of two waveforms: each resampled to the GE2E 16 kHz
    front-end and embedded by ``encoder`` (load pretrained weights with
    ``convert.py::load_ge2e_checkpoint``: random weights make the number
    meaningless)."""
    ea = encoder.embed_utterance(preprocess_wav(wav_a, sr))
    eb = encoder.embed_utterance(preprocess_wav(wav_b, sr))
    return cosine(ea, eb)


def mcd(mel_ref: np.ndarray, mel_pred: np.ndarray) -> float:
    """Mel-cepstral distortion (dB) over aligned log10-mel frames."""
    n = min(len(mel_ref), len(mel_pred))
    diff = np.asarray(mel_ref[:n]) - np.asarray(mel_pred[:n])
    k = 10.0 / np.log(10.0) * np.sqrt(2.0)  # log10 -> dB, MCD convention
    return float(k * np.sqrt((diff ** 2).sum(-1)).mean()) if n else \
        float("nan")
