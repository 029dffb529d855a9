"""Each traffic generator against the ranges its mix states."""

import numpy as np
import pytest

from benchmark.harness.registry import Cell


@pytest.fixture(scope="module")
def synth():
    return Cell("stylesinger.synth_batch")


@pytest.fixture(scope="module")
def vocode():
    return Cell("hifigan_nsf.vocode")


@pytest.mark.parametrize("seed", [0, 2 ** 40 + 17])
def test_phrases_in_range(synth, seed):
    mix, cfg = synth.traffic, synth.cfg
    pool = synth.generator().make(mix, seed, cfg)
    assert len(pool) == mix["batches"]
    names = set(synth.generator().phone_names(mix))
    for batch in pool:
        assert len(batch) == mix["batch"]
        counts = sorted(len(r["ph"].split()) for r in batch)
        assert counts[0] == mix["phones"][0] and counts[-1] == mix["phones"][1]
        secs = sorted(len(r["ref_audio"]) / cfg["audio_sample_rate"]
                      for r in batch)
        assert secs[0] == pytest.approx(mix["ref_s"][0], abs=1e-3)
        assert secs[-1] == pytest.approx(mix["ref_s"][1], abs=1e-3)
        for r in batch:
            k = len(r["ph"].split())
            assert set(r["ph"].split()) <= names
            assert len(r["notes"]) == len(r["notes_duration"]) == k
            assert min(r["notes"]) >= mix["note_midi"][0]
            assert max(r["notes"]) <= mix["note_midi"][1]
            assert min(r["notes_duration"]) >= mix["note_s"][0]
            assert max(r["notes_duration"]) <= mix["note_s"][1]
            assert np.abs(r["ref_audio"]).max() <= 0.3 + 1e-6


def test_phrases_same_sizes_for_every_seed(synth):
    g = synth.generator()

    def sizes(seed):
        pool = g.make(synth.traffic, seed, synth.cfg)
        return (sorted(len(r["ph"].split()) for b in pool for r in b),
                sorted(len(r["ref_audio"]) for b in pool for r in b))
    a, b = sizes(1), sizes(2 ** 33 + 5)
    assert a == b
    pool1 = g.make(synth.traffic, 1, synth.cfg)
    pool2 = g.make(synth.traffic, 1, synth.cfg)
    assert pool1[0][0]["ph"] == pool2[0][0]["ph"]
    assert np.array_equal(pool1[0][0]["ref_audio"], pool2[0][0]["ref_audio"])


@pytest.mark.parametrize("seed", [3, 2 ** 41 + 1])
def test_mels_in_range(vocode, seed):
    mix, cfg = vocode.traffic, vocode.cfg
    pool = vocode.generator().make(mix, seed, cfg)
    lengths = sorted(r["mel"].shape[0] for r in pool)
    assert lengths == vocode.generator().lengths(mix)
    assert lengths[0] == mix["frames"][0] and lengths[-1] == mix["frames"][1]
    lo = np.asarray(cfg["spec_min"])[: cfg["audio_num_mel_bins"]]
    hi = np.asarray(cfg["spec_max"])[: cfg["audio_num_mel_bins"]]
    for r in pool:
        assert r["mel"].shape[1] == cfg["audio_num_mel_bins"]
        assert (r["mel"] >= lo - 1e-5).all() and (r["mel"] <= hi + 1e-5).all()
        voiced = r["f0"][r["f0"] > 0]
        assert voiced.min() >= mix["f0_hz"][0] - 1e-3
        assert voiced.max() <= mix["f0_hz"][1] + 1e-3
    unvoiced = np.mean(np.concatenate([r["f0"] for r in pool]) == 0)
    assert abs(unvoiced - mix["unvoiced_share"]) < 0.05
