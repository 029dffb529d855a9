"""Sung phrases with reference recordings, batched as a batch job sends
them.

A pool of ``batches`` batches of ``batch`` requests.  In every batch the
phone counts are the same evenly spaced values over ``phones`` and the
reference lengths the same evenly spaced values over ``ref_s``, paired
and ordered by the seed, so that every seed makes the same sizes (and the
same padded shapes) in another order.  Each request draws, from the seed:

- its phones from a set of ``phone_set`` names (``p00`` ..);
- per phone a MIDI note from ``note_midi`` and a note duration from
  ``note_s`` (seconds), of type ``note_type``;
- its reference clip: a harmonic voice at 48 kHz or the configuration's
  rate, 220 Hz x 2^(U(-3, 3) / 12) with a 5.5 Hz vibrato, eight harmonics
  of random level and phase, 0.1 s fades, peak 0.3.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np


def phone_names(mix: Dict[str, Any]) -> List[str]:
    return [f"p{i:02d}" for i in range(mix["phone_set"])]


def mean_note_frames(mix: Dict[str, Any], cfg: Dict[str, Any]) -> float:
    """Frames of the mean note: the duration head's set point."""
    return float(np.mean(mix["note_s"]) * cfg["audio_sample_rate"]
                 / cfg["hop_size"])


def reference_clip(rng: np.random.Generator, seconds: float,
                   sr: int) -> np.ndarray:
    t = np.arange(int(seconds * sr)) / sr
    f0 = 220.0 * 2 ** (rng.uniform(-3, 3) / 12)
    inst = f0 * (1 + 0.02 * np.sin(2 * np.pi * 5.5 * t))
    phase = 2 * np.pi * np.cumsum(inst) / sr
    amps = rng.uniform(0.2, 1.0, 8) / np.arange(1, 9)
    wav = sum(a * np.sin((h + 1) * phase + rng.uniform(0, 2 * np.pi))
              for h, a in enumerate(amps))
    env = np.minimum(1.0, np.minimum(t, seconds - t) / 0.1)
    wav = 0.3 * wav * env / np.abs(wav).max()
    return wav.astype(np.float32)


def make(mix: Dict[str, Any], seed: int, cfg: Dict[str, Any]
         ) -> List[List[Dict[str, Any]]]:
    """The pool: ``batches`` lists of ``batch`` requests, each the dict
    ``infer_batch`` takes (``ph``, ``notes``, ``notes_duration``,
    ``note_types``, ``ref_audio``)."""
    rng = np.random.default_rng(seed)
    names = phone_names(mix)
    n = mix["batch"]
    counts = np.round(np.linspace(*mix["phones"], n)).astype(int)
    ref_s = np.linspace(*mix["ref_s"], n)
    sr = cfg["audio_sample_rate"]
    pool = []
    for _ in range(mix["batches"]):
        batch = []
        for k, r in zip(rng.permutation(counts), rng.permutation(ref_s)):
            k = int(k)
            batch.append(dict(
                ph=" ".join(names[i] for i in rng.integers(0, len(names), k)),
                notes=[int(x) for x in rng.integers(
                    mix["note_midi"][0], mix["note_midi"][1] + 1, k)],
                notes_duration=[float(x) for x in rng.uniform(
                    *mix["note_s"], k)],
                note_types=[int(mix["note_type"])] * k,
                ref_audio=reference_clip(rng, float(r), sr)))
        pool.append(batch)
    return pool
