"""StyleSinger training dataset over binarized shards (port of
``stylesinger_tpu/data/dataset.py``).

Per item: the mel [T, M], phone tokens, ``mel2ph``, the normed and
interpolated f0 with its uv, the MIDI note streams, and the speaker and
emotion embeddings; sizes come from ``{prefix}_lengths.npy``.  Pure numpy:
:mod:`stylesinger_torch.data.batching` collates to static bucket shapes.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np

from stylesinger_torch.data.indexed_dataset import IndexedDataset
from stylesinger_torch.dsp.pitch import norm_interp_f0_np


class StyleSingerDataset:
    def __init__(self, cfg: Any, prefix: str,
                 data_dir: Optional[str] = None,
                 items: Optional[List[Dict]] = None):
        self.cfg = cfg
        self.prefix = prefix
        self.data_dir = data_dir or cfg["binary_data_dir"]
        self._ds: Optional[IndexedDataset] = None
        self._items = items
        if items is not None:
            self.sizes = [len(it["mel"]) for it in items]
            self.avail_idxs = list(range(len(items)))
        else:
            sizes = np.load(os.path.join(self.data_dir,
                                         f"{prefix}_lengths.npy"))
            self.avail_idxs = list(range(len(sizes)))
            if prefix == "test" and cfg.get("test_ids"):
                # the items of the test split to synthesize
                self.avail_idxs = list(cfg["test_ids"])
            if prefix == "train" and cfg["min_frames"] > 0:
                self.avail_idxs = [i for i in self.avail_idxs
                                   if sizes[i] >= cfg["min_frames"]]
            self.sizes = [int(min(sizes[i], cfg["max_frames"]))
                          for i in self.avail_idxs]

    def _get_item(self, index: int) -> Dict:
        index = self.avail_idxs[index]
        if self._items is not None:
            return self._items[index]
        if self._ds is None:
            self._ds = IndexedDataset(
                os.path.join(self.data_dir, self.prefix))
        return self._ds[index]

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
