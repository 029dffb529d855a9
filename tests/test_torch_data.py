"""The port's data modules against the JAX package's, on the CPU.

The same seeded items go through both packages' shard reader and writer,
``StyleSingerDataset``, ``collate_batch``, ``batch_by_size``,
``BucketBatcher`` and ``EpochBatches``; every field must be equal, dtype
included (the data layer is numpy on both sides, so nothing is held to a
tolerance).  The items have unvoiced runs (the f0 interpolation and uv),
``mel2ph`` and f0 shorter than the mel (the frame cut), more frames than
``max_frames`` and fewer than ``min_frames``, and more phones than
``max_input_tokens``.
"""

import numpy as np
import pytest

from stylesinger_tpu import data as jdata
from stylesinger_tpu.config import tiny_test_config as jax_tiny

from stylesinger_torch.config import tiny_test_config as torch_tiny
from stylesinger_torch.data import batching, dataset, indexed_dataset

# token ids 1 and 2 are silences (the word-duration loss reads ``is_sil``)
DATA = dict(min_frames=20, max_input_tokens=12, sil_token_ids=[1, 2],
            max_tokens=160, max_sentences=3)
N_ITEMS = 12


def items(seed, n=N_ITEMS, mel_bins=16):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = int(rng.integers(10, 90))
        tt = int(rng.integers(3, 20))
        mel2ph = np.sort(rng.integers(1, tt + 1, t))
        # a trailing run of padding frames in some items
        mel2ph[t - int(rng.integers(0, 4)):] = 0
        f0 = (150 + 100 * rng.uniform(size=t)).astype(np.float32)
        for _ in range(int(rng.integers(0, 4))):  # unvoiced runs
            a = int(rng.integers(0, t))
            f0[a:a + int(rng.integers(1, 8))] = 0.0
        f0 = f0[: t - int(rng.integers(0, 3))]
        out.append({
            "item_name": f"item_{i}",
            "mel": rng.standard_normal((t, mel_bins)).astype(np.float32),
            "mel2ph": mel2ph,
            "f0": f0,
            "ph_token": rng.integers(1, 20, tt),
            "ep_pitches": rng.integers(0, 80, tt),
            "ep_notedurs": rng.uniform(0.1, 0.6, tt).astype(np.float32),
            "ep_types": rng.integers(1, 4, tt),
            "spk_embed": rng.standard_normal(256).astype(np.float32),
            "emo_embed": rng.standard_normal(256).astype(np.float32),
        })
    return out


def write_corpus(root, builder_cls):
    for prefix, seed in (("train", 0), ("valid", 1)):
        data = items(seed)
        builder = builder_cls(str(root / prefix))
        for it in data:
            builder.add_item(it)
        builder.finalize()
        np.save(root / f"{prefix}_lengths.npy",
                np.asarray([len(it["mel"]) for it in data]))


def assert_same(got, want, where=""):
    assert type(got) is type(want) or (
        isinstance(got, np.ndarray) and isinstance(want, np.ndarray)), where
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, f"{where}: {got.dtype} {want.dtype}"
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, where


def both_datasets(tmp_path, prefix, source):
    """(port, JAX) ``StyleSingerDataset``s over the same items."""
    cfgs = torch_tiny(**DATA), jax_tiny(**DATA)
    if source == "items":
        data = items(0 if prefix == "train" else 1)
        return tuple(mod.StyleSingerDataset(cfg, prefix, items=data)
                     for mod, cfg in zip((dataset, jdata), cfgs))
    write_corpus(tmp_path, indexed_dataset.IndexedDatasetBuilder)
    return tuple(mod.StyleSingerDataset(cfg, prefix, data_dir=str(tmp_path))
                 for mod, cfg in zip((dataset, jdata), cfgs))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_shards_read_the_same_in_both_packages(tmp_path, writer):
    builder = (indexed_dataset.IndexedDatasetBuilder if writer == "port"
               else jdata.IndexedDatasetBuilder)
    write_corpus(tmp_path, builder)
    ours = indexed_dataset.IndexedDataset(str(tmp_path / "train"))
    theirs = jdata.IndexedDataset(str(tmp_path / "train"))
    assert len(ours) == len(theirs) == N_ITEMS
    for i, want in enumerate(items(0)):
        assert_same(ours[i], want, f"port item {i}")
        assert_same(theirs[i], want, f"jax item {i}")
    ours.close()
    theirs.close()


@pytest.mark.parametrize("prefix,source", [
    ("train", "corpus"), ("valid", "corpus"), ("train", "items")])
def test_dataset_items_match_jax(tmp_path, prefix, source):
    ours, theirs = both_datasets(tmp_path, prefix, source)
    assert ours.sizes == theirs.sizes and ours.avail_idxs == theirs.avail_idxs
    if source == "corpus" and prefix == "train":
        assert len(ours) < N_ITEMS  # min_frames dropped some
    assert max(ours.sizes) == 64 or source == "items"  # max_frames cut
    uv_seen = False
    for i in range(len(ours)):
        got, want = ours[i], theirs[i]
        assert_same(got, want, f"{prefix} {i}")
        uv_seen |= bool(want["uv"].any())
    assert uv_seen


@pytest.mark.parametrize("n", [1, 3, 5])
def test_collate_matches_jax(tmp_path, n):
    ours, theirs = both_datasets(tmp_path, "train", "items")
    cfg = torch_tiny(**DATA)
    got = batching.collate_batch([ours[i] for i in range(n)],
                                 cfg["frame_buckets"], cfg["token_buckets"])
    want = jdata.collate_batch([theirs[i] for i in range(n)],
                               cfg["frame_buckets"], cfg["token_buckets"])
    assert_same(got, want, f"collate {n}")
    assert got["mels"].shape[0] == 1 << (n - 1).bit_length()
    assert "is_sil" in got and got["is_sil"].any()


def test_batch_by_size_matches_jax():
    rng = np.random.default_rng(3)
    sizes = rng.integers(5, 200, 60).tolist()
    order = rng.permutation(60).tolist()
    for max_tokens, max_sentences, mult in ((400, 100, 1), (1000, 6, 1),
                                            (600, 100, 2), (150, 3, 4)):
        assert batching.batch_by_size(order, sizes, max_tokens,
                                      max_sentences, mult) == \
            jdata.batch_by_size(order, sizes, max_tokens, max_sentences,
                                mult)


def test_bucket_batches_match_jax_over_two_epochs(tmp_path):
    ours, theirs = both_datasets(tmp_path, "train", "corpus")
    cfg, jcfg = torch_tiny(**DATA), jax_tiny(**DATA)
    ep_ours = batching.EpochBatches(ours, cfg)
    ep_theirs = jdata.EpochBatches(theirs, jcfg)
    epochs = []
    for epoch in range(2):
        got, want = list(ep_ours), list(ep_theirs)
        assert len(got) == len(want) > 1
        for j, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"epoch {epoch} batch {j}")
        epochs.append([b["txt_tokens"].tolist() for b in got])
    assert epochs[0] != epochs[1]  # reshuffled between epochs
    ours_v, theirs_v = both_datasets(tmp_path, "valid", "corpus")
    plain = dict(shuffle=False, max_tokens=cfg["max_valid_tokens"],
                 max_sentences=cfg["max_valid_sentences"])
    got = list(batching.BucketBatcher(ours_v, cfg, **plain).batches(0))
    want = list(jdata.BucketBatcher(theirs_v, jcfg, **plain).batches(0))
    assert len(got) == len(want) == N_ITEMS
    for j, (g, w) in enumerate(zip(got, want)):
        assert_same(g, w, f"valid batch {j}")
