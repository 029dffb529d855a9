"""StyleSinger training dataset over binarized shards (frozen from the port's ``data/dataset.py``).

Per item: the mel [T, M], phone tokens, ``mel2ph``, the normed and
interpolated f0 with its uv, the MIDI note streams, and the speaker and
emotion embeddings; sizes come from ``{prefix}_lengths.npy``.  Pure numpy:
``batching.py`` collates to static bucket shapes.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from .pitch import norm_interp_f0_np


class StyleSingerDataset:
    """Over items held in memory (the benchmark's); the shard reader of
    the port is not part of the reference."""

    def __init__(self, cfg: Any, prefix: str, items: List[Dict]):
        self.cfg = cfg
        self.prefix = prefix
        self._items = items
        self.sizes = [len(it["mel"]) for it in items]
        self.avail_idxs = list(range(len(items)))

    def _get_item(self, index: int) -> Dict:
        return self._items[self.avail_idxs[index]]

    def __len__(self) -> int:
        return len(self.avail_idxs)

    def num_frames(self, index: int) -> int:
        return self.sizes[index]

    def __getitem__(self, index: int) -> Dict:
        c = self.cfg
        item = self._get_item(index)
        mel = np.asarray(item["mel"], np.float32)[: c["max_frames"]]
        mel2ph = np.asarray(item["mel2ph"], np.int64)
        f0_raw = np.asarray(item["f0"], np.float32)
        t = int(min(len(mel), (mel2ph > 0).sum(), len(f0_raw)))
        mel, mel2ph = mel[:t], mel2ph[:t]
        f0, uv = norm_interp_f0_np(
            f0_raw[:t], pitch_norm=c["pitch_norm"], use_uv=c["use_uv"],
            f0_mean=c["f0_mean"], f0_std=c["f0_std"])
        mt = c["max_input_tokens"]
        sample = {
            "id": index,
            "item_name": item.get("item_name", str(index)),
            "txt_tokens": np.asarray(item["ph_token"], np.int64)[:mt],
            "mels": mel,
            "mel2ph": mel2ph,
            "f0": f0,
            "uv": uv,
            "notes": np.asarray(item["ep_pitches"], np.int64)[:mt],
            "note_durs": np.asarray(item["ep_notedurs"], np.float32)[:mt],
            "note_types": np.asarray(item["ep_types"], np.int64)[:mt],
        }
        sil_ids = c.get("sil_token_ids")
        if sil_ids:
            sample["is_sil"] = np.isin(
                sample["txt_tokens"], np.asarray(sil_ids)).astype(np.float32)
        if c["use_spk_embed"] and "spk_embed" in item:
            sample["spk_embed"] = np.asarray(item["spk_embed"], np.float32)
        if c["use_spk_id"] and "spk_id" in item:
            sample["spk_id"] = int(item["spk_id"])
        if c["emo"] and "emo_embed" in item:
            sample["emo_embed"] = np.asarray(item["emo_embed"], np.float32)
        return sample
