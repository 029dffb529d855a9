"""TSD-backed dataset: batches assembled by the C++ reader and prefetched
on a background thread (port of ``stylesinger_tpu/data/tsd_dataset.py``).

The per-item transform of ``StyleSingerDataset`` (the normed, interpolated
F0 and its uv) is precomputed at binarize time into the TSD shard, so a
training batch is pure padded gathers run by the reader's threads
(``csrc/tsd_reader.cc``).  :class:`PrefetchBatcher` keeps batches ahead of
the consumer; given a CUDA ``device`` it puts each batch's arrays in
pinned host memory and copies them to the card with ``non_blocking=True``.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional, Union

import numpy as np
import torch

from stylesinger_torch.data.batching import (
    _next_bucket, _next_pow2, batch_by_size,
)
from stylesinger_torch.data.native_loader import TsdReader, TsdReaderPlain
from stylesinger_torch.dsp.pitch import norm_interp_f0_np


def precompute_item_fields(item: Dict, cfg: Any) -> Dict:
    """Binarize-time hook: the item plus its normed, interpolated F0
    (``f0_norm``) and ``uv``, so that the loader runs no transform."""
    f0, uv = norm_interp_f0_np(
        np.asarray(item["f0"], np.float32),
        pitch_norm=cfg["pitch_norm"], use_uv=cfg["use_uv"],
        f0_mean=cfg["f0_mean"], f0_std=cfg["f0_std"])
    out = dict(item)
    out["f0_norm"] = f0
    out["uv"] = uv
    return out


def to_device(batch: Dict[str, Any], device: Union[str, torch.device]
              ) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device``: on a CUDA device through
    pinned host memory, copied with ``non_blocking=True``."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out


class TsdStyleSingerDataset:
    """Batch-level access over a TSD shard pair (no per-item Python): the
    C++ reader, or the plain numpy reader with ``plain=True``."""

    def __init__(self, cfg: Any, path: str, n_threads: int = 4,
                 plain: bool = False):
        self.cfg = cfg
        reader_cls = TsdReaderPlain if plain else TsdReader
        self.reader = reader_cls(path, n_threads=n_threads)
        self.sizes = [int(self.reader.probe(i, "mel")[1][0])
                      for i in range(len(self.reader))]

    def __len__(self) -> int:
        return len(self.reader)

    def batch(self, idxs) -> Dict[str, np.ndarray]:
        """The padded numpy batch of items ``idxs``: frames to the next
        frame bucket, tokens to the next token bucket, rows to a power of
        two (the extra rows all zeros)."""
        c = self.cfg
        sizes = [self.sizes[i] for i in idxs]
        t_mel = _next_bucket(min(max(sizes), c["max_frames"]),
                             c["frame_buckets"])
        tt = [int(self.reader.probe(i, "ph_token")[1][0]) for i in idxs]
        t_txt = _next_bucket(min(max(tt), c["max_input_tokens"]),
                             c["token_buckets"])
        b = _next_pow2(len(idxs))
        pad = list(idxs) + [idxs[0]] * (b - len(idxs))  # rows zeroed below
        g = self.reader.gather_pad
        batch = {
            "txt_tokens": g(pad, "ph_token", t_txt).astype(np.int32),
            "mels": g(pad, "mel", t_mel).astype(np.float32),
            "mel2ph": g(pad, "mel2ph", t_mel).astype(np.int32),
            "f0": g(pad, "f0_norm", t_mel).astype(np.float32),
            "uv": g(pad, "uv", t_mel).astype(np.float32),
            "notes": g(pad, "ep_pitches", t_txt).astype(np.int32),
            "note_durs": g(pad, "ep_notedurs", t_txt).astype(np.float32),
            "note_types": g(pad, "ep_types", t_txt).astype(np.int32),
            "nsamples": np.asarray(len(idxs)),
        }
        for name in ("spk_embed", "emo_embed"):
            if self._has(name, idxs[0]):
                batch[name] = g(pad, name, 256).astype(np.float32)
        for k, v in batch.items():
            if k != "nsamples" and v.shape[0] == b:
                v[len(idxs):] = 0
        return batch

    def _has(self, name: str, idx: int) -> bool:
        try:
            self.reader.probe(idx, name)
            return True
        except KeyError:
            return False


class PrefetchBatcher:
    """Size-bucketed batches (the shuffle of ``BucketBatcher``, seeded from
    ``seed`` and the epoch), assembled by the reader on a background thread
    ``depth`` batches ahead, with ``madvise`` readahead of the next batch.
    With ``device`` given, each batch arrives as tensors on it
    (:func:`to_device`)."""

    def __init__(self, dataset: TsdStyleSingerDataset, cfg: Any,
                 shuffle: bool = True, seed: int = 1234, rank: int = 0,
                 world_size: int = 1, depth: int = 2,
                 device: Optional[Union[str, torch.device]] = None):
        self.ds = dataset
        self.cfg = cfg
        self.shuffle = shuffle
        self.seed = seed
        self.rank = rank
        self.world_size = world_size
        self.depth = depth
        self.device = device

    def _index_batches(self, epoch: int):
        sizes = np.asarray(self.ds.sizes)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch)
            order = rng.permutation(len(sizes))
            order = order[np.argsort(sizes[order], kind="mergesort")]
        else:
            order = np.arange(len(sizes))
        batches = batch_by_size(order.tolist(), self.ds.sizes,
                                self.cfg["max_tokens"],
                                self.cfg["max_sentences"])
        if self.shuffle:
            rng = np.random.default_rng(self.seed + 1000 + epoch)
            rng.shuffle(batches)
        return batches[self.rank:: self.world_size]

    def batches(self, epoch: int = 0) -> Iterator[Dict[str, Any]]:
        idx_batches = self._index_batches(epoch)
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = object()
        failed = []

        def producer():
            try:
                for i, idxs in enumerate(idx_batches):
                    if i + 1 < len(idx_batches):
                        self.ds.reader.prefetch(idx_batches[i + 1])
                    q.put(self.ds.batch(idxs))
            except BaseException as e:  # re-raised in the consumer
                failed.append(e)
            finally:
                q.put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item if self.device is None else to_device(item,
                                                             self.device)
        t.join()
        if failed:
            raise failed[0]
