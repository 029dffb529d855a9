"""Training items, as the binarizer writes them for a sung corpus.

``items`` items whose frame counts are the same evenly spaced values over
``frames`` for every seed, and whose phone counts are the same evenly
spaced values over ``phones``, paired and ordered by the seed.  Each item
draws from the seed (the recipe of the port's chip checks):

- ``mel2ph``: every phone at least one frame, the rest of the frames
  spread over the phones at random, in order;
- the log-mel N(-3, 0.5) per bin, the F0 uniform over ``f0_hz``, phone
  ids below ``vocab`` (0 is padding), MIDI notes over ``note_midi``, note
  durations over ``note_s``;
- the speaker and emotion d-vectors N(0, 1).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np


def sizes(mix: Dict[str, Any]):
    n = mix["items"]
    frames = np.round(np.linspace(*mix["frames"], n)).astype(int)
    phones = np.round(np.linspace(*mix["phones"], n)).astype(int)
    return frames, phones


def make(mix: Dict[str, Any], seed: int, cfg: Dict[str, Any]
         ) -> List[Dict[str, Any]]:
    rng = np.random.default_rng(seed)
    frames, phones = sizes(mix)
    m = cfg["audio_num_mel_bins"]
    items = []
    for i, (t, tt) in enumerate(zip(rng.permutation(frames),
                                    rng.permutation(phones))):
        t, tt = int(t), int(tt)
        mel2ph = np.sort(rng.integers(1, tt + 1, t))
        mel2ph[:tt] = np.arange(1, tt + 1)
        items.append({
            "item_name": f"item_{i}",
            "mel": (rng.standard_normal((t, m)) * 0.5 - 3).astype(
                np.float32),
            "mel2ph": np.sort(mel2ph),
            "f0": rng.uniform(*mix["f0_hz"], t).astype(np.float32),
            "ph_token": rng.integers(1, mix["vocab"], tt),
            "ep_pitches": rng.integers(mix["note_midi"][0],
                                       mix["note_midi"][1] + 1, tt),
            "ep_notedurs": rng.uniform(*mix["note_s"], tt).astype(
                np.float32),
            "ep_types": np.ones(tt, np.int64),
            "spk_embed": rng.standard_normal(256).astype(np.float32),
            "emo_embed": rng.standard_normal(256).astype(np.float32),
        })
    return items
