"""Token-bucket batching with static-shape padding (frozen from the port's ``data/batching.py``).

The fairseq-style ``batch_by_size``: a size-sorted shuffled order, batches
capped by ``max_tokens`` (mel frames) and ``max_sentences``.  Every batch
is padded to a shape bucket (the next entry of ``frame_buckets`` and
``token_buckets``, and a power of two rows), so the train step sees a
handful of shapes.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np


def batch_by_size(indices: Sequence[int], sizes: Sequence[int],
                  max_tokens: int = 10000, max_sentences: int = 100000,
                  required_batch_size_multiple: int = 1) -> List[List[int]]:
    """Group indices into batches capped by token count / sentence count."""
    batches: List[List[int]] = []
    batch: List[int] = []
    sample_len = 0
    for idx in indices:
        sample_len = max(sample_len, sizes[idx])
        if batch and (
                sample_len * (len(batch) + 1) > max_tokens or
                len(batch) + 1 > max_sentences):
            mult = required_batch_size_multiple
            if len(batch) > mult:
                keep = (len(batch) // mult) * mult
            else:
                keep = len(batch)
            batches.append(batch[:keep])
            batch = batch[keep:]
            sample_len = max([sizes[i] for i in batch + [idx]])
        batch.append(idx)
    if batch:
        batches.append(batch)
    return batches


def _next_bucket(value: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if value <= b:
            return b
    return buckets[-1]


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def pad_to(arr: np.ndarray, length: int, axis: int = 0,
           value: float = 0) -> np.ndarray:
    pad = length - arr.shape[axis]
    if pad < 0:
        slicer = [slice(None)] * arr.ndim
        slicer[axis] = slice(0, length)
        return arr[tuple(slicer)]
    if pad == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths, constant_values=value)


def collate_batch(samples: List[Dict], frame_buckets: Sequence[int],
                  token_buckets: Sequence[int],
                  emo: bool = True) -> Dict[str, np.ndarray]:
    """Stack samples into one static-shape batch.

    Shapes: frames -> next frame bucket; tokens -> next token bucket;
    batch -> next power of two (extra rows are all-padding and masked out
    by ``txt_tokens == 0`` / ``mel2ph == 0`` downstream).
    """
    t_mel = _next_bucket(max(s["mels"].shape[0] for s in samples),
                         frame_buckets)
    t_txt = _next_bucket(max(len(s["txt_tokens"]) for s in samples),
                         token_buckets)
    b = _next_pow2(len(samples))

    def stack(key, length, axis=0, value=0, dtype=None):
        arrs = [pad_to(np.asarray(s[key]), length, axis, value)
                for s in samples]
        while len(arrs) < b:
            arrs.append(np.zeros_like(arrs[0]))
        out = np.stack(arrs)
        return out.astype(dtype) if dtype else out

    batch = {
        "txt_tokens": stack("txt_tokens", t_txt, dtype=np.int32),
        "mels": stack("mels", t_mel),
        "mel2ph": stack("mel2ph", t_mel, dtype=np.int32),
        "f0": stack("f0", t_mel),
        "uv": stack("uv", t_mel),
        "notes": stack("notes", t_txt, dtype=np.int32),
        "note_durs": stack("note_durs", t_txt),
        "note_types": stack("note_types", t_txt, dtype=np.int32),
        "nsamples": np.asarray(len(samples)),
    }
    if "is_sil" in samples[0]:
        batch["is_sil"] = stack("is_sil", t_txt)
    if "spk_embed" in samples[0]:
        batch["spk_embed"] = stack("spk_embed",
                                   samples[0]["spk_embed"].shape[0])
    if emo and "emo_embed" in samples[0]:
        batch["emo_embed"] = stack("emo_embed",
                                   samples[0]["emo_embed"].shape[0])
    if "spk_id" in samples[0]:
        # speaker ids (use_spk_id); a padding row takes id 0
        batch["spk_id"] = np.asarray(
            [s["spk_id"] for s in samples] + [0] * (b - len(samples)),
            np.int64)
    return batch


class BucketBatcher:
    """One epoch's batches: size-sorted shuffle (seeded from ``cfg["seed"]``
    and the epoch) -> batch_by_size -> static-shape collate.  With
    ``world_size`` > 1, rank ``rank`` takes every ``world_size``-th batch
    from its ``rank``-th on (the reference's per-replica round robin)."""

    def __init__(self, dataset, cfg: Any, shuffle: bool = True,
                 max_tokens: Optional[int] = None,
                 max_sentences: Optional[int] = None, rank: int = 0,
                 world_size: int = 1):
        self.ds = dataset
        self.cfg = cfg
        self.shuffle = shuffle
        self.seed = cfg["seed"]
        self.rank = rank
        self.world_size = world_size
        self.max_tokens = max_tokens or cfg["max_tokens"]
        self.max_sentences = max_sentences or cfg["max_sentences"]

    def _ordered_indices(self, epoch: int) -> np.ndarray:
        sizes = np.asarray(self.ds.sizes)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch)
            order = rng.permutation(len(sizes))
            if self.cfg.get("sort_by_len", True):
                order = order[np.argsort(sizes[order], kind="mergesort")]
            return order
        return np.arange(len(sizes))

    def batches(self, epoch: int = 0) -> Iterator[Dict]:
        order = self._ordered_indices(epoch)
        batches = batch_by_size(order.tolist(), self.ds.sizes,
                                self.max_tokens, self.max_sentences)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + 1000 + epoch)
            rng.shuffle(batches)
        for idxs in batches[self.rank::self.world_size]:
            samples = [self.ds[i] for i in idxs]
            yield collate_batch(samples, self.cfg["frame_buckets"],
                                self.cfg["token_buckets"],
                                emo=self.cfg["emo"])


class EpochBatches:
    """Finite, re-iterable epoch source for :meth:`Trainer.fit`: each
    ``__iter__`` yields exactly one epoch of batches and then advances the
    shuffle epoch, so the step loop, which re-iterates at the end of an
    epoch, sees a fresh permutation every pass."""

    def __init__(self, dataset, cfg, rank: int = 0, world_size: int = 1):
        self._batcher = BucketBatcher(dataset, cfg, rank=rank,
                                      world_size=world_size)
        self.epoch = 0

    def __iter__(self) -> Iterator[Dict]:
        yield from self._batcher.batches(self.epoch)
        self.epoch += 1
