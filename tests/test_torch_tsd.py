"""The TSD fast path: the port's writer, its C++ reader (built here with the
host compiler), its plain numpy reader, ``TsdStyleSingerDataset`` and
``PrefetchBatcher`` against the JAX package's, on the CPU.  Every array is
held exactly: the layer moves bytes."""

import shutil

import numpy as np
import pytest
import torch

from stylesinger_tpu.config import tiny_test_config as jax_tiny
from stylesinger_tpu.data import native_loader as jnl
from stylesinger_tpu.data import tsd_dataset as jtd
from stylesinger_tpu.data.indexed_dataset import (
    IndexedDatasetBuilder as JaxBuilder,
)

from stylesinger_torch.config import tiny_test_config as torch_tiny
from stylesinger_torch.data import native_loader as nl
from stylesinger_torch.data import tsd_dataset as td

DATA = dict(max_tokens=160, max_sentences=3, max_frames=64,
            frame_buckets=[32, 64], token_buckets=[8, 16])


def items(seed, n=10):
    """Seeded items with every tabled dtype, a float16 field, a scalar, a
    list and a string field (the writer skips strings)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = int(rng.integers(8, 70))
        tt = int(rng.integers(3, 14))
        f0 = (150 + 100 * rng.uniform(size=t)).astype(np.float32)
        f0[int(rng.integers(0, t)):][:5] = 0.0
        out.append({
            "item_name": f"item_{i}",
            "mel": rng.standard_normal((t, 16)).astype(np.float32),
            "mel2ph": np.sort(rng.integers(1, tt + 1, t)),
            "f0": f0,
            "ph_token": rng.integers(1, 20, tt).tolist(),
            "ep_pitches": rng.integers(0, 80, tt),
            "ep_notedurs": rng.uniform(0.1, 0.6, tt),
            "ep_types": rng.integers(1, 4, tt).astype(np.int32),
            "spk_embed": rng.standard_normal(256).astype(np.float32),
            "emo_embed": rng.standard_normal(256).astype(np.float16),
            "wav": rng.integers(-3000, 3000, t * 4).astype(np.int16),
            "is_sil": rng.uniform(size=tt) > 0.7,
            "len": t,
            "sec": t * 0.016,
            "weights": rng.uniform(size=3).astype(np.float64),
            "codes": rng.integers(0, 255, 5).astype(np.uint8),
        })
    return out


def fast(item, cfg, fields):
    out = fields(item, cfg)
    return {k: v for k, v in out.items()
            if isinstance(v, (np.ndarray, list, int, float))
            and not isinstance(v, bool)}


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """The same items through both writers, with the binarizer's
    precomputed fields."""
    root = tmp_path_factory.mktemp("tsd")
    cfg = torch_tiny(**DATA)
    data = items(0)
    for name, writer, fields in (("ours", nl.TsdWriter,
                                  td.precompute_item_fields),
                                 ("ref", jnl.TsdWriter,
                                  jtd.precompute_item_fields)):
        w = writer(str(root / name))
        for it in data:
            w.add_item(fast(it, cfg, fields))
        w.finalize()
    return dict(root=root, items=data, cfg=cfg)


def test_writer_bytes_equal_jax(shards):
    root = shards["root"]
    for ext in (".tsidx", ".tsdata"):
        assert (root / f"ours{ext}").read_bytes() == \
            (root / f"ref{ext}").read_bytes()


def test_cpp_reader_builds_with_the_host_compiler():
    path = nl.build_tsd_reader()
    assert path.parent == nl.BUILD_DIR and path.name.startswith("libtsd_")
    assert nl.load_native() is nl.load_native()


@pytest.mark.parametrize("field,rows", [("mel", 64), ("mel", 20),
                                        ("ph_token", 16), ("wav", 300),
                                        ("emo_embed", 256), ("is_sil", 8),
                                        ("len", 1), ("codes", 5),
                                        ("weights", 4)])
def test_gather_pad_cpp_plain_and_jax_agree(shards, field, rows):
    path = str(shards["root"] / "ours")
    idxs = [3, 0, 7, 7, 1, 9]
    readers = [nl.TsdReader(path, n_threads=4), nl.TsdReaderPlain(path),
               jnl.TsdReader(path)]
    got = [r.gather_pad(idxs, field, rows) for r in readers]
    for g in got[1:]:
        assert g.dtype == got[0].dtype and g.shape == got[0].shape
        np.testing.assert_array_equal(g, got[0])
    for b, i in enumerate(idxs):  # and the item's own values
        want = np.asarray(shards["items"][i][field])
        if want.dtype == np.float16:
            want = want.astype(np.float32)
        want = want.reshape(-1, *want.shape[1:]) if want.ndim else want[None]
        r = min(rows, len(want))
        np.testing.assert_array_equal(got[0][b, :r], want[:r])
        assert not got[0][b, r:].any()
    for r in readers:
        r.close()


def test_fields_probe_and_missing_keys(shards):
    path = str(shards["root"] / "ours")
    cpp, plain, ref = (nl.TsdReader(path), nl.TsdReaderPlain(path),
                       jnl.TsdReader(path))
    assert len(cpp) == len(plain) == len(ref) == len(shards["items"])
    for i in range(len(cpp)):
        for k in ("mel", "f0_norm", "uv", "ph_token", "len", "sec", "wav"):
            a, b, c = cpp.field(i, k), plain.field(i, k), ref.field(i, k)
            assert a.dtype == b.dtype == c.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        assert cpp.probe(i, "mel")[:2] == plain.probe(i, "mel")[:2] == \
            ref._probe(i, "mel")[:2]
    for r in (cpp, plain):
        with pytest.raises(KeyError):
            r.field(0, "item_name")  # strings are not tabled
        with pytest.raises(KeyError):
            r.gather_pad([0, 1], "nope", 4)
    with pytest.raises(KeyError):
        cpp.field(len(cpp), "mel")
    cpp.prefetch([0, 5, 99])  # madvise readahead; out of range is skipped
    cpp.close()


def test_empty_shard_opens(tmp_path):
    w = nl.TsdWriter(str(tmp_path / "empty"))
    w.finalize()
    assert len(nl.TsdReader(str(tmp_path / "empty"))) == 0
    assert len(nl.TsdReaderPlain(str(tmp_path / "empty"))) == 0


def test_missing_shard_raises(tmp_path):
    with pytest.raises(OSError, match="cannot open"):
        nl.TsdReader(str(tmp_path / "nothing"))


def test_broken_build_raises_and_does_not_fall_back(tmp_path, monkeypatch,
                                                    shards):
    broken = tmp_path / "tsd_reader.cc"
    broken.write_text(nl.SOURCE.read_text() + "\nthis is not C++;\n")
    with pytest.raises(RuntimeError, match="building the TSD reader failed"):
        nl.build_tsd_reader(broken)
    monkeypatch.setattr(nl, "SOURCE", broken)
    monkeypatch.setattr(nl, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(nl, "_NATIVE", nl._Native())
    with pytest.raises(RuntimeError, match="building the TSD reader failed"):
        nl.TsdReader(str(shards["root"] / "ours"))
    monkeypatch.setenv("CXX", "no-such-compiler-xyz")
    with pytest.raises(RuntimeError, match="not found"):
        nl.TsdReader(str(shards["root"] / "ours"))
    with pytest.raises(RuntimeError):
        td.TsdStyleSingerDataset(shards["cfg"], str(shards["root"] / "ours"))


def _equal_batches(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("plain", [False, True])
def test_dataset_batches_equal_jax(shards, plain):
    path = str(shards["root"] / "ours")
    cfg = shards["cfg"]
    ours = td.TsdStyleSingerDataset(cfg, path, plain=plain)
    ref = jtd.TsdStyleSingerDataset(jax_tiny(**DATA), path)
    assert ours.sizes == ref.sizes and len(ours) == len(ref)
    for idxs in ([0], [1, 2, 3], [4, 5, 6, 7, 8], [9, 9]):
        _equal_batches(ours.batch(idxs), ref.batch(idxs))


@pytest.mark.parametrize("shuffle", [True, False])
def test_prefetch_batcher_equals_jax_over_two_epochs(shards, shuffle):
    path = str(shards["root"] / "ours")
    ours = td.PrefetchBatcher(
        td.TsdStyleSingerDataset(shards["cfg"], path), shards["cfg"],
        shuffle=shuffle)
    ref = jtd.PrefetchBatcher(
        jtd.TsdStyleSingerDataset(jax_tiny(**DATA), path), jax_tiny(**DATA),
        shuffle=shuffle)
    for epoch in (0, 1):
        a, b = list(ours.batches(epoch)), list(ref.batches(epoch))
        assert len(a) == len(b) > 1
        for x, y in zip(a, b):
            _equal_batches(x, y)


def test_prefetch_batcher_to_device_and_errors(shards):
    path = str(shards["root"] / "ours")
    ds = td.TsdStyleSingerDataset(shards["cfg"], path)
    numpy_batches = list(td.PrefetchBatcher(ds, shards["cfg"]).batches(0))
    tensor_batches = list(td.PrefetchBatcher(ds, shards["cfg"],
                                             device="cpu").batches(0))
    for a, b in zip(numpy_batches, tensor_batches):
        assert all(isinstance(v, torch.Tensor) for v in b.values())
        _equal_batches(a, {k: v.numpy() for k, v in b.items()})

    class Broken(td.TsdStyleSingerDataset):
        def batch(self, idxs):
            raise ValueError("broken batch")

    broken = Broken(shards["cfg"], path)
    with pytest.raises(ValueError, match="broken batch"):
        list(td.PrefetchBatcher(broken, shards["cfg"]).batches(0))


def test_convert_indexed_to_tsd_equals_jax(tmp_path):
    data = items(1, n=4)
    builder = JaxBuilder(str(tmp_path / "train"))
    for it in data:
        builder.add_item(it)
    builder.finalize()
    assert nl.convert_indexed_to_tsd(str(tmp_path / "train"),
                                     str(tmp_path / "ours")) == 4
    assert jnl.convert_indexed_to_tsd(str(tmp_path / "train"),
                                      str(tmp_path / "ref")) == 4
    for ext in (".tsidx", ".tsdata"):
        assert (tmp_path / f"ours{ext}").read_bytes() == \
            (tmp_path / f"ref{ext}").read_bytes()
    r = nl.TsdReader(str(tmp_path / "ours"))
    np.testing.assert_array_equal(r.field(2, "mel"), data[2]["mel"])


def test_build_is_git_ignored_and_needs_no_nvcc():
    assert shutil.which("g++") or shutil.which("c++")
    from stylesinger_torch.kernels import _build

    assert nl.BUILD_DIR == _build.BUILD_DIR
    assert nl.SOURCE.suffix == ".cc" and nl.SOURCE not in _build.sources()


def test_large_gathers_run_threaded_and_equal_jax(tmp_path):
    """Fields of MBs per item take the reader's threaded copy (one thread
    per MB, at most ``n_threads``); the small ones copy on the calling
    thread.  Either way the batch is JAX's."""
    rng = np.random.default_rng(9)
    data = [{"big": rng.standard_normal((int(rng.integers(40000, 60000)),
                                         8)).astype(np.float32),
             "small": rng.integers(0, 9, 5)} for _ in range(6)]
    w = nl.TsdWriter(str(tmp_path / "big"))
    for it in data:
        w.add_item(it)
    w.finalize()
    path = str(tmp_path / "big")
    for field, rows in (("big", 60000), ("big", 45000), ("small", 5)):
        idxs = [5, 0, 3, 1, 4, 2, 2]
        ours = nl.TsdReader(path, n_threads=4).gather_pad(idxs, field, rows)
        np.testing.assert_array_equal(
            ours, nl.TsdReaderPlain(path).gather_pad(idxs, field, rows))
        np.testing.assert_array_equal(
            ours, jnl.TsdReader(path).gather_pad(idxs, field, rows))
