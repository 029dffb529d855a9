"""The port's training loop on the CPU at ``tiny_test_config``: data,
checkpoints, ``Trainer`` and ``python -m stylesinger_torch.run train``.

No JAX comparison: these hold the loop's own contract (steps, metrics,
checkpoints, resume, pruning, the non-finite trap, warm start).
"""

import json
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from stylesinger_torch.config import (
    load_config, load_work_dir_config, tiny_test_config,
)
from stylesinger_torch.data.batching import (
    BucketBatcher, EpochBatches, batch_by_size, collate_batch,
)
from stylesinger_torch.data.dataset import StyleSingerDataset
from stylesinger_torch.data.indexed_dataset import (
    IndexedDataset, IndexedDatasetBuilder,
)
from stylesinger_torch.models.stylesinger import StyleSinger
from stylesinger_torch.training.checkpoint import CheckpointManager
from stylesinger_torch.training.step import init_state
from stylesinger_torch.training.trainer import Trainer, warm_start_params
from test_torch_train import VOCAB, synthetic_items
from torch_parity import one_torch_thread

# the fixture, imported above, runs this module on one torch thread
pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parent.parent
# a curriculum that a few steps cross: forcing for step 0, then RQ and the
# mel diffusion
CURRICULUM = dict(forcing=1, rq_start=0, diff_start=0, tb_log_interval=1,
                  val_check_interval=2)


def items(seed, n=4):
    return synthetic_items(tiny_test_config(), np.random.default_rng(seed), n)


def batch_of(cfg, seed):
    ds = StyleSingerDataset(cfg, "train", items=items(seed))
    return collate_batch([ds[i] for i in range(len(ds))],
                         cfg["frame_buckets"], cfg["token_buckets"])


def tiny(**kw):
    return tiny_test_config(**dict(CURRICULUM, **kw))


def trainer(cfg, work_dir):
    return Trainer(StyleSinger(cfg, VOCAB), cfg, str(work_dir), device="cpu")


# ------------------------------------------------------------------ data

def test_indexed_dataset_round_trip(tmp_path):
    path = str(tmp_path / "train")
    builder = IndexedDatasetBuilder(path)
    data = items(0, 3)
    for it in data:
        builder.add_item(it)
    builder.finalize()
    ds = IndexedDataset(path)
    assert len(ds) == 3
    for got, want in zip(ds, data):
        assert got["item_name"] == want["item_name"]
        np.testing.assert_array_equal(got["mel"], want["mel"])
    with pytest.raises(IndexError):
        ds[3]
    ds.close()


def test_collate_pads_to_the_buckets_and_a_power_of_two():
    cfg = tiny()
    ds = StyleSingerDataset(cfg, "train", items=items(1, 3))
    batch = collate_batch([ds[i] for i in range(3)], cfg["frame_buckets"],
                          cfg["token_buckets"])
    assert batch["mels"].shape == (4, 32, 16)
    assert batch["txt_tokens"].shape == (4, 8)
    assert batch["spk_embed"].shape == (4, 256)
    assert not batch["mel2ph"][3].any() and int(batch["nsamples"]) == 3
    assert batch_by_size([0, 1, 2, 3], [10, 10, 30, 30], max_tokens=60) == \
        [[0, 1], [2, 3]]


def test_epoch_batches_reshuffle_each_epoch():
    cfg = tiny(max_tokens=64)
    ds = StyleSingerDataset(cfg, "train", items=items(2, 8))
    epochs = EpochBatches(ds, cfg)
    first, second = list(epochs), list(epochs)
    for epoch in (first, second):
        assert len(epoch) > 1
        assert sum(int(b["nsamples"]) for b in epoch) == 8
    assert [b["txt_tokens"].tolist() for b in first] != \
        [b["txt_tokens"].tolist() for b in second]
    plain = list(BucketBatcher(ds, cfg, shuffle=False).batches(0))
    assert sum(int(b["nsamples"]) for b in plain) == 8


# --------------------------------------------------------------- trainer

def test_fit_takes_steps_writes_metrics_and_saves(tmp_path):
    cfg = tiny()
    batch = batch_of(cfg, 3)
    tr = trainer(cfg, tmp_path)
    state = tr.fit([batch, batch, batch], lambda: iter([batch]),
                   max_updates=2)
    assert state.step == 2 and tr.ckpt.latest_step() == 2
    rows = [json.loads(line) for line in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    train_rows = [r for r in rows if r["prefix"] == "train"]
    assert [r["step"] for r in train_rows] == [1, 2]
    assert "gloss" not in train_rows[0] and "rq_loss" in train_rows[1]
    assert "diff" in train_rows[1] and train_rows[1]["steps_per_sec"] > 0
    valid = [r for r in rows if r["prefix"] == "valid"]
    assert len(valid) == 1 and np.isfinite(valid[0]["total_loss"])
    assert tr.ckpt.best_step() == 2


def test_resume_matches_an_unbroken_run(tmp_path):
    cfg = tiny()
    batch = batch_of(cfg, 4)
    unbroken = trainer(cfg, tmp_path / "a")
    unbroken.fit([batch], max_updates=4)
    first = trainer(cfg, tmp_path / "b")
    first.fit([batch], max_updates=2)
    again = trainer(cfg, tmp_path / "b")
    state = again.fit([batch], max_updates=4)
    assert state.step == 4 and again.ckpt.latest_step() == 4
    ref = unbroken.model.state_dict()
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, ref[k]), k
    for a, b in zip(state.opt.mu, unbroken.state.opt.mu):
        assert torch.equal(a, b)


class _Interrupting:
    """Batches that send the process a SIGINT while the second step's batch
    is fetched."""

    def __init__(self, batch):
        self.batch = batch

    def __iter__(self):
        yield self.batch
        signal.raise_signal(signal.SIGINT)
        while True:
            yield self.batch


@pytest.mark.parametrize("prefetch", [0, 2])
def test_ctrl_c_saves_the_last_whole_step(tmp_path, prefetch):
    """The signal comes with the fetch of the second batch.  Without the
    prefetcher that is after step 1, so the run stops at step 2; at the
    default depth the prefetcher's thread fetches it while an earlier step
    runs (or before the first), so the run stops at whichever step was
    whole when the main thread saw the signal."""
    assert threading.current_thread() is threading.main_thread()
    cfg = tiny(prefetch_batches=prefetch)
    batch = batch_of(cfg, 4)
    unbroken = trainer(cfg, tmp_path / "a")
    unbroken.fit([batch], max_updates=4)
    cut = trainer(cfg, tmp_path / "b")
    handler = signal.getsignal(signal.SIGINT)
    with pytest.raises(KeyboardInterrupt):
        cut.fit(_Interrupting(batch), max_updates=4)
    stopped = cut.state.step
    assert stopped == 2 if prefetch == 0 else stopped < 4
    assert cut.ckpt.all_steps() == [stopped]
    assert signal.getsignal(signal.SIGINT) is handler
    state = trainer(cfg, tmp_path / "b").fit([batch], max_updates=4)
    ref = unbroken.model.state_dict()
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, ref[k]), k
    for a, b in zip(state.opt.nu, unbroken.state.opt.nu):
        assert torch.equal(a, b)


def test_checkpoints_keep_the_latest_k_and_the_best(tmp_path):
    cfg = tiny(milestone_interval=2)
    model = StyleSinger(cfg, VOCAB)
    state = init_state(model, cfg)
    mgr = CheckpointManager(str(tmp_path), keep=2, milestone_interval=2)
    for step, val in ((1, 5.0), (2, 3.0), (3, 4.0), (4, 6.0)):
        state.step = step
        mgr.save(step, state, val)
    assert mgr.all_steps() == [3, 4]
    assert mgr.best_step() == 2 and mgr.milestone_steps() == [2, 4]
    again = CheckpointManager(str(tmp_path), keep=2)
    again.save(5, state, 3.5)   # worse than the best copy's 3.0
    assert again.best_step() == 2
    restored = init_state(StyleSinger(cfg, VOCAB), cfg, seed=99)
    _, step = again.restore_best(restored)
    assert step == 2
    _, step = again.restore(restored)
    assert step == 5
    for k, v in restored.model.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k
    again.restore_milestone(restored, 4)
    assert restored.step == 4


def test_non_finite_loss_raises(tmp_path):
    cfg = tiny()
    batch = batch_of(cfg, 5)
    batch["mels"] = batch["mels"].copy()
    batch["mels"][0, 0, 0] = np.nan
    with pytest.raises(FloatingPointError, match="non-finite"):
        trainer(cfg, tmp_path).fit([batch], max_updates=2)


def test_warm_start_drops_mismatched_keys(tmp_path, capsys):
    cfg = tiny()
    src = trainer(cfg, tmp_path / "src")
    src.fit([batch_of(cfg, 6)], max_updates=2)
    wider = tiny(aligner_ffn_dim=48)
    model = StyleSinger(wider, VOCAB)
    init_state(model, wider, seed=7)
    dropped = warm_start_params(model, str(tmp_path / "src"))
    assert dropped and all("align.layer_0.linear" in d for d in dropped)
    loaded = src.state.model.state_dict()
    for k, v in model.state_dict().items():
        if "align.layer_0.linear" not in k:
            assert torch.equal(v, loaded[k]), k
    assert "tensors loaded" in capsys.readouterr().out


def test_trainer_on_cuda_raises_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tiny()
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(StyleSinger(cfg, VOCAB), cfg, str(tmp_path))


# ------------------------------------------------------------------- CLI

def _write_corpus(root: Path, cfg) -> list:
    phones = [f"p{i}" for i in range(VOCAB - 3)]
    root.mkdir(parents=True)
    (root / "phone_set.json").write_text(json.dumps(phones))
    for prefix, seed in (("train", 8), ("valid", 9)):
        builder = IndexedDatasetBuilder(str(root / prefix))
        data = items(seed)
        for it in data:
            builder.add_item(it)
        builder.finalize()
        np.save(root / f"{prefix}_lengths.npy",
                np.asarray([len(it["mel"]) for it in data]))
    return phones


def test_run_train_on_a_tiny_corpus_leaves_a_checkpoint(tmp_path):
    cfg = tiny(max_updates=2)
    _write_corpus(tmp_path / "binary", cfg)
    base = load_config()
    overrides = dict({k: v for k, v in cfg.items()
                      if json.dumps(v) != json.dumps(base[k])},
                     binary_data_dir=str(tmp_path / "binary"))
    hparams = ",".join(f"{k}={json.dumps(v) if isinstance(v, (list, tuple)) else v}"
                       for k, v in overrides.items())
    out = subprocess.run(
        [sys.executable, "-m", "stylesinger_torch.run", "train", "--device",
         "cpu", "--hparams", hparams, "--exp_name", "tiny",
         "--work_dir_root", str(tmp_path / "ckpts")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    work = tmp_path / "ckpts" / "tiny"
    assert (work / "ckpt" / "model_ckpt_steps_2.pt").exists()
    assert (work / "ckpt_best" / "best_val.json").exists()
    assert (work / "config.yaml").exists()
    assert load_work_dir_config(str(work))["max_updates"] == 2
    assert "trained to step 2" in out.stdout
