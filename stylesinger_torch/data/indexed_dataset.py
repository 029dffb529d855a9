"""Pickle-per-item shard storage (port of
``stylesinger_tpu/data/indexed_dataset.py``), on disk the same as the
reference's and the JAX package's: ``<path>.data`` is a concatenation of
pickled items; ``<path>.idx`` is an ``np.save``d dict ``{'offsets': [0,
...]}`` of byte offsets.  Reads use ``pread`` on one descriptor (no seek
races) and a small cache.  Only shards this project wrote are to be read:
unpickling runs code."""

from __future__ import annotations

import os
import pickle
from typing import Any, Iterator, List

import numpy as np


class IndexedDataset:
    def __init__(self, path: str, num_cache: int = 8):
        self.path = path
        idx = np.load(f"{path}.idx", allow_pickle=True).item()
        self.offsets: List[int] = list(idx["offsets"])
        self._fd = os.open(f"{path}.data", os.O_RDONLY)
        self.num_cache = num_cache
        self._cache: dict = {}

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def __getitem__(self, i: int) -> Any:
        if i < 0 or i >= len(self):
            raise IndexError(i)
        if i in self._cache:
            return self._cache[i]
        start, end = self.offsets[i], self.offsets[i + 1]
        item = pickle.loads(os.pread(self._fd, end - start, start))
        if self.num_cache > 0:
            if len(self._cache) >= self.num_cache:
                self._cache.pop(next(iter(self._cache)))
            self._cache[i] = item
        return item

    def __iter__(self) -> Iterator[Any]:
        for i in range(len(self)):
            yield self[i]

    def close(self) -> None:
        if getattr(self, "_fd", None) is not None:
            os.close(self._fd)
            self._fd = None

    def __del__(self):
        self.close()


class IndexedDatasetBuilder:
    def __init__(self, path: str):
        self.path = path
        self._out = open(f"{path}.data", "wb")
        self.offsets: List[int] = [0]

    def add_item(self, item: Any) -> None:
        n = self._out.write(pickle.dumps(item))
        self.offsets.append(self.offsets[-1] + n)

    def finalize(self) -> None:
        self._out.close()
        with open(f"{self.path}.idx", "wb") as f:
            np.save(f, {"offsets": self.offsets})
