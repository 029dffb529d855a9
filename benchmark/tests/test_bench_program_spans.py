"""The readers of the port's own spans (``source: program_span`` metrics
that read ``stylesinger_torch.utils.profiling.registry()``): each on a
hand-made registry, None where its spans are absent or the port has no
registry, and one traced run of the tiny ``vocode`` cell, whose profiled
slice records the spans of ``spec2wav``."""

import pytest

from benchmark.harness.registry import Cell
from stylesinger_torch.utils import profiling

READERS = ("f0_diffusion_ms_per_req", "mel_diffusion_ms_per_req",
           "backward_ms_per_step", "optimizer_ms_per_step")


def span(calls, n=0, host_s=0.0, device_s=None):
    return dict(calls=calls, n=n, host_s=host_s, device_s=device_s)


REGISTRY = dict(
    spans={"infer_batch": span(1, n=16, host_s=11.0, device_s=10.0),
           "frontend.pitch": span(16, host_s=0.8),
           "frontend.embed": span(16, host_s=0.32),
           "acoustic.f0_diffusion": span(1, host_s=3.0, device_s=3.2),
           "acoustic.mel_diffusion": span(1, host_s=2.0, device_s=1.6),
           "spec2wav": span(32, n=32, host_s=0.6),
           "vocoder.upload": span(32, host_s=0.064),
           "vocoder.download": span(32, host_s=0.096)},
    graphs={"(phase, 0)": dict(replays=3, spans={
                "train.forward": 0.2, "train.backward": 0.3,
                "train.optimizer": 0.02}),
            "(phase, 1)": dict(replays=1, spans={
                "train.forward": 0.1, "train.backward": 0.5,
                "train.optimizer": 0.06})},
    counters={"denoiser.f0": 200, "denoiser.mel": 100})

WANT = {"f0_diffusion_ms_per_req": 200.0, "mel_diffusion_ms_per_req": 100.0,
        "backward_ms_per_step": 1e3 * (3 * 0.3 + 0.5) / 4,
        "optimizer_ms_per_step": 1e3 * (3 * 0.02 + 0.06) / 4}


@pytest.fixture
def readers():
    cells = ("stylesinger.synth_batch", "hifigan_nsf.vocode",
             "stylesinger.train")
    found = {}
    for c in cells:
        cell = Cell(c)
        for m in cell.metrics(trace=True):
            if m["name"] in READERS:
                found[m["name"]] = cell.reader(m["name"])
    assert set(found) == set(READERS)
    return found


@pytest.mark.parametrize("name", READERS)
def test_each_reader_on_a_hand_made_registry(readers, monkeypatch, name):
    monkeypatch.setattr(profiling, "registry", lambda: REGISTRY)
    assert readers[name].read({}) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", READERS)
def test_each_reader_is_none_without_its_spans(readers, monkeypatch, name):
    monkeypatch.setattr(profiling, "registry",
                        lambda: dict(spans={}, graphs={}, counters={}))
    assert readers[name].read({}) is None
    monkeypatch.setattr(profiling, "registry", lambda: dict(
        spans={k: dict(s, device_s=None)
               for k, s in REGISTRY["spans"].items()},
        graphs={k: dict(g, spans={s: None for s in g["spans"]})
                for k, g in REGISTRY["graphs"].items()}, counters={}))
    assert readers[name].read({}) is None


@pytest.mark.parametrize("name", READERS)
def test_each_reader_is_none_on_a_port_without_a_registry(
        readers, monkeypatch, name):
    monkeypatch.delattr(profiling, "registry")
    assert readers[name].read({}) is None


def test_a_traced_vocode_run_records_the_spans_of_spec2wav():
    from benchmark.tests.test_bench_runs import run, vocode_cell

    cell = vocode_cell()
    profiling.reset()
    _, checks = run(cell, trace=True)
    assert checks.correct(), checks.lines()
    spans = profiling.registry()["spans"]
    for name in ("spec2wav", "vocoder.upload", "vocoder",
                 "vocoder.download"):
        assert spans[name]["calls"] == cell.spec["slice_requests"], name
        assert spans[name]["host_s"] > 0, name
