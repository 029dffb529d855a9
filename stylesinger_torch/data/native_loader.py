"""Tensor-shard (TSD) format: the writer, the C++ reader and its plain
numpy twin (port of ``stylesinger_tpu/data/native_loader.py``).

The pickled ``IndexedDataset`` keeps on-disk compatibility with the
reference; TSD is the fast path beside it: a flat tensor table served by
``csrc/tsd_reader.cc``, an mmap'd reader with multithreaded padded-batch
assembly.

Layout (little-endian int64):
  .tsidx: b"TSD1" | n_items | per item: n_fields | per field:
          name_len | name | dtype_code | ndim | shape[ndim] | offset | nbytes
  .tsdata: raw array bytes, 64-byte aligned.

The C++ reader is built at first use with the host C++ compiler (``g++``
or ``$CXX``, the flags of ``native/Makefile``), apart from the CUDA build,
into ``stylesinger_torch/_build/`` under a hash of the source, the flags
and the host CPU.  :class:`TsdReader` raises when it cannot be built or
loaded; there is no silent fallback.  :class:`TsdReaderPlain` is the
pure-numpy reader with the same interface, which a caller selects
explicitly and which the tests hold the C++ reader against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import struct
import subprocess
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

_DTYPE_CODES = {
    np.dtype("float32"): 0, np.dtype("float64"): 1, np.dtype("int32"): 2,
    np.dtype("int64"): 3, np.dtype("int16"): 4, np.dtype("uint8"): 5,
    np.dtype("bool"): 6,
}
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}
_ALIGN = 64

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "csrc" / "tsd_reader.cc"
BUILD_DIR = PACKAGE_DIR / "_build"
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
             "-shared", "-pthread"]


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

class TsdWriter:
    """Appends items (dicts of arrays) to ``<path>.tsdata`` and writes the
    index ``<path>.tsidx`` at :meth:`finalize`.  float16 is stored as
    float32, other non-tabled numeric dtypes as float32; strings are
    skipped (they live in the IndexedDataset)."""

    def __init__(self, path: str):
        self.path = path
        self._data = open(path + ".tsdata", "wb")
        self._items: List[List[tuple]] = []
        self._pos = 0

    def add_item(self, item: Dict[str, Any]) -> None:
        fields = []
        for name, value in item.items():
            arr = np.ascontiguousarray(value)
            if arr.dtype == np.float16:
                arr = arr.astype(np.float32)
            if arr.dtype not in _DTYPE_CODES:
                if arr.dtype.kind in ("U", "S", "O"):
                    continue
                arr = arr.astype(np.float32)
            pad = (-self._pos) % _ALIGN
            if pad:
                self._data.write(b"\0" * pad)
                self._pos += pad
            off = self._pos
            raw = arr.tobytes()
            self._data.write(raw)
            self._pos += len(raw)
            fields.append((name, _DTYPE_CODES[arr.dtype], arr.shape, off,
                           len(raw)))
        self._items.append(fields)

    def finalize(self) -> None:
        self._data.close()
        with open(self.path + ".tsidx", "wb") as f:
            f.write(b"TSD1")
            f.write(struct.pack("<q", len(self._items)))
            for fields in self._items:
                f.write(struct.pack("<q", len(fields)))
                for name, code, shape, off, nbytes in fields:
                    nb = name.encode()
                    f.write(struct.pack("<q", len(nb)))
                    f.write(nb)
                    f.write(struct.pack("<q", code))
                    f.write(struct.pack("<q", len(shape)))
                    for s in shape:
                        f.write(struct.pack("<q", s))
                    f.write(struct.pack("<q", off))
                    f.write(struct.pack("<q", nbytes))


# ---------------------------------------------------------------------------
# the C++ reader's build
# ---------------------------------------------------------------------------

class _Native:
    lib: Optional[ctypes.CDLL] = None
    build_seconds: Optional[float] = None  # None: loaded, not built


_NATIVE = _Native()
_BUILD_LOCK = threading.Lock()


def find_cxx() -> str:
    """``$CXX`` or ``g++`` on ``PATH``; raises if neither exists."""
    cxx = os.environ.get("CXX") or "g++"
    path = shutil.which(cxx)
    if path is None:
        raise RuntimeError(f"the host C++ compiler {cxx!r} was not found: "
                           "the TSD reader cannot be built")
    return path


def _host_tag() -> str:
    """The CPU the build targets (``-march=native``): the machine and the
    CPU flags of ``/proc/cpuinfo`` where it exists."""
    tag = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            tag += next((line for line in f if line.startswith("flags")), "")
    except OSError:
        pass
    return tag


def build_tsd_reader(source: Optional[Path] = None) -> Path:
    """Compile ``source`` (default: ``csrc/tsd_reader.cc``) if needed and
    return the shared library's path; raises ``RuntimeError`` with the
    compiler's output when the build fails."""
    source = SOURCE if source is None else source
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + _host_tag().encode())
    h.update(source.read_bytes())
    target = BUILD_DIR / f"libtsd_{h.hexdigest()[:16]}.so"
    if target.exists():
        return target
    cxx = find_cxx()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libtsd_{os.getpid()}_{time.monotonic_ns()}.so"
    t0 = time.perf_counter()
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the TSD reader failed:\n$ {cxx} "
                           f"{' '.join(CXX_FLAGS)} {source}\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, target)  # atomic: concurrent builds agree
    _NATIVE.build_seconds = time.perf_counter() - t0
    return target


def load_native() -> ctypes.CDLL:
    """The TSD reader's shared library, built at first use."""
    with _BUILD_LOCK:
        if _NATIVE.lib is None:
            lib = ctypes.CDLL(str(build_tsd_reader()))
            _declare(lib)
            _NATIVE.lib = lib
    return _NATIVE.lib


def build_seconds() -> Optional[float]:
    """Seconds the TSD reader's build took in this process (None: none
    ran)."""
    return _NATIVE.build_seconds


def _declare(lib: ctypes.CDLL) -> None:
    i64, p = ctypes.c_int64, ctypes.c_void_p
    pi64 = ctypes.POINTER(i64)
    lib.tsd_open.restype = p
    lib.tsd_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.tsd_close.argtypes = [p]
    lib.tsd_num_items.restype = i64
    lib.tsd_num_items.argtypes = [p]
    lib.tsd_field_info.restype = ctypes.c_int
    lib.tsd_field_info.argtypes = [p, i64, ctypes.c_char_p, pi64, pi64, pi64,
                                   pi64]
    lib.tsd_read_field.restype = ctypes.c_int
    lib.tsd_read_field.argtypes = [p, i64, ctypes.c_char_p, p]
    lib.tsd_gather_pad.restype = ctypes.c_int
    lib.tsd_gather_pad.argtypes = [p, pi64, i64, ctypes.c_char_p, p, i64,
                                   i64, ctypes.c_int]
    lib.tsd_prefetch.argtypes = [p, pi64, i64]


# ---------------------------------------------------------------------------
# readers
# ---------------------------------------------------------------------------

def _padded(items: np.ndarray, probe, name: str, max_rows: int):
    """(out zeros [n, max_rows, *trailing], row bytes) for a gather whose
    trailing shape and dtype are the first item's."""
    code, shape = probe(int(items[0]), name)[:2]
    trailing = tuple(shape[1:])
    dtype = _CODE_DTYPES[code]
    row_bytes = int(np.prod(trailing, dtype=np.int64)) * dtype.itemsize
    return np.zeros((len(items), max_rows) + trailing, dtype), row_bytes


class TsdReader:
    """Random access and padded batch gathers over a TSD shard pair,
    through the C++ reader (multithreaded ``gather_pad``, ``madvise``
    readahead in :meth:`prefetch`)."""

    def __init__(self, path: str, n_threads: int = 4):
        self.path = path
        self.n_threads = n_threads
        self._lib = load_native()
        self._h = self._lib.tsd_open((path + ".tsidx").encode(),
                                     (path + ".tsdata").encode())
        if not self._h:
            raise OSError(f"TSD reader: cannot open {path}.tsidx / "
                          f"{path}.tsdata")

    def __len__(self) -> int:
        return int(self._lib.tsd_num_items(self._h))

    def probe(self, item: int, name: str):
        """(dtype code, shape, 0, nbytes) of one field; KeyError if the
        item has no such field."""
        dtype, ndim, nbytes = (ctypes.c_int64() for _ in range(3))
        shape8 = (ctypes.c_int64 * 8)()
        rc = self._lib.tsd_field_info(
            self._h, item, name.encode(), ctypes.byref(dtype),
            ctypes.byref(ndim), shape8, ctypes.byref(nbytes))
        if rc != 0:
            raise KeyError((item, name))
        return (dtype.value, tuple(shape8[i] for i in range(ndim.value)), 0,
                nbytes.value)

    def field(self, item: int, name: str) -> np.ndarray:
        code, shape, _, _ = self.probe(item, name)
        out = np.empty(shape, dtype=_CODE_DTYPES[code])
        rc = self._lib.tsd_read_field(self._h, item, name.encode(),
                                      out.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise KeyError((item, name))
        return out

    def gather_pad(self, items: Sequence[int], name: str,
                   max_rows: int) -> np.ndarray:
        """[len(items), max_rows, *trailing] zero-padded batch of a field
        (the leading dim padded or truncated to ``max_rows``)."""
        items = np.ascontiguousarray(items, np.int64)
        out, row_bytes = _padded(items, self.probe, name, max_rows)
        rc = self._lib.tsd_gather_pad(
            self._h, items.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(items), name.encode(), out.ctypes.data_as(ctypes.c_void_p),
            max_rows, row_bytes, self.n_threads)
        if rc != 0:
            raise KeyError(f"gather_pad failed at position {-rc - 1}")
        return out

    def prefetch(self, items: Sequence[int]) -> None:
        items = np.ascontiguousarray(items, np.int64)
        self._lib.tsd_prefetch(
            self._h, items.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(items))

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.tsd_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


class TsdReaderPlain:
    """The plain twin of :class:`TsdReader`: the index parsed in Python,
    the data a numpy memmap, gathers one item at a time."""

    def __init__(self, path: str, n_threads: int = 4):
        self.path = path
        self._index = self._parse_index(path + ".tsidx")
        size = os.path.getsize(path + ".tsdata")
        self._data = (np.memmap(path + ".tsdata", dtype=np.uint8, mode="r")
                      if size else np.zeros(0, np.uint8))

    @staticmethod
    def _parse_index(idx_path: str) -> List[Dict[str, tuple]]:
        with open(idx_path, "rb") as f:
            buf = f.read()
        if buf[:4] != b"TSD1":
            raise ValueError(f"{idx_path} is not a TSD index")
        pos = 4

        def rd():
            nonlocal pos
            v = struct.unpack_from("<q", buf, pos)[0]
            pos += 8
            return v

        items = []
        for _ in range(rd()):
            fields = {}
            for _ in range(rd()):
                nl = rd()
                name = buf[pos: pos + nl].decode()
                pos += nl
                code = rd()
                shape = tuple(rd() for _ in range(rd()))
                off = rd()
                fields[name] = (code, shape, off, rd())
            items.append(fields)
        return items

    def __len__(self) -> int:
        return len(self._index)

    def probe(self, item: int, name: str):
        return self._index[item][name]

    def field(self, item: int, name: str) -> np.ndarray:
        code, shape, off, nbytes = self._index[item][name]
        arr = np.frombuffer(self._data[off: off + nbytes],
                            dtype=_CODE_DTYPES[code])
        return arr.reshape(shape).copy()

    def gather_pad(self, items: Sequence[int], name: str,
                   max_rows: int) -> np.ndarray:
        items = np.ascontiguousarray(items, np.int64)
        out, _ = _padded(items, self.probe, name, max_rows)
        for i, idx in enumerate(items):
            arr = self.field(int(idx), name)
            r = min(arr.shape[0] if arr.ndim else 1, max_rows)
            out[i, :r] = arr[:r] if arr.ndim else arr
        return out

    def prefetch(self, items: Sequence[int]) -> None:
        pass

    def close(self) -> None:
        pass


def convert_indexed_to_tsd(indexed_path: str, tsd_path: str) -> int:
    """One-shot migration: pickled IndexedDataset shards -> TSD; returns
    the number of items."""
    from stylesinger_torch.data.indexed_dataset import IndexedDataset

    ds = IndexedDataset(indexed_path, num_cache=0)
    w = TsdWriter(tsd_path)
    n = 0
    for item in ds:
        w.add_item({k: v for k, v in item.items()
                    if isinstance(v, (np.ndarray, int, float, list))})
        n += 1
    w.finalize()
    ds.close()
    return n
