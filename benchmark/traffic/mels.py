"""Mels and F0 contours for a vocoder, as a TTS or SVS pipeline hands them
over.

A pool of ``pool`` requests whose lengths are the same for every seed
(``lengths`` values evenly spaced over ``frames``, each as often), in an
order and with contents drawn from the seed:

- the log-mel lies in the configuration's feature range: each bin at
  ``spec_min + level * (spec_max - spec_min)``, with a spectral tilt and a
  level per note drawn from ``level`` and a frame-to-frame ``jitter``;
- the F0 is a run of notes of ``note_s`` seconds, each at a pitch drawn
  log-uniformly from ``f0_hz``, a share ``unvoiced_share`` of them
  unvoiced (0 Hz), as sung phrases have rests.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np


def lengths(mix: Dict[str, Any]) -> List[int]:
    lo, hi = mix["frames"]
    values = [int(round(x)) for x in np.linspace(lo, hi, mix["lengths"])]
    return sorted(values * (mix["pool"] // len(values)))


def notes(rng: np.random.Generator, n_frames: int, frame_s: float,
          mix: Dict[str, Any]) -> Tuple[np.ndarray, np.ndarray]:
    """Each frame's F0 (0 = unvoiced) and level (a share of the feature
    range), constant over a note."""
    lo, hi = mix["note_s"]
    f_lo, f_hi = np.log(mix["f0_hz"][0]), np.log(mix["f0_hz"][1])
    f0 = np.zeros(n_frames, np.float32)
    level = np.zeros(n_frames, np.float32)
    t = 0
    while t < n_frames:
        n = max(1, int(round(rng.uniform(lo, hi) / frame_s)))
        voiced = rng.uniform() >= mix["unvoiced_share"]
        f0[t:t + n] = np.exp(rng.uniform(f_lo, f_hi)) if voiced else 0.0
        level[t:t + n] = rng.uniform(*mix["level"]) if voiced \
            else mix["level"][0] * 0.5
        t += n
    return f0, level


def make(mix: Dict[str, Any], seed: int, cfg: Dict[str, Any]
         ) -> List[Dict[str, Any]]:
    """The pool: [{"mel": [T, M] f32, "f0": [T] f32}], in the seed's
    order."""
    rng = np.random.default_rng(seed)
    m = cfg["audio_num_mel_bins"]
    kb = cfg.get("keep_bins", m)
    lo = np.asarray(cfg["spec_min"], np.float32)[:kb]
    hi = np.asarray(cfg["spec_max"], np.float32)[:kb]
    frame_s = cfg["hop_size"] / cfg["audio_sample_rate"]
    pool = []
    for t in rng.permutation(lengths(mix)):
        f0, level = notes(rng, int(t), frame_s, mix)
        tilt = np.linspace(0.0, -rng.uniform(0.1, 0.3), m, dtype=np.float32)
        frac = np.clip(level[:, None] + tilt[None, :] + mix["jitter"]
                       * rng.standard_normal((int(t), m)).astype(np.float32),
                       0.0, 1.0)
        pool.append({"mel": (lo + frac * (hi - lo)).astype(np.float32),
                     "f0": f0})
    return pool
