"""The port's spans and counters (``stylesinger_torch/utils/profiling.py``)
at the sites of the synthesis path and of a train step, on the CPU: what
they record, that they change no output, that they cost nothing while off,
their place in ``torch.profiler``'s Chrome trace, and ``idle_by_span``.
No JAX."""

import json

import numpy as np
import pytest
import torch

from stylesinger_torch.config import tiny_test_config
from stylesinger_torch.inference import StyleSingerInfer
from stylesinger_torch.models.diffusion import Noise
from stylesinger_torch.utils import profiling

TINY = dict(hop_size=64, mrf_block=64)   # tests/test_torch_load_params.py
PHONES = list("abcdefg")
SYNTH_SPANS = ("infer_batch", "frontend", "frontend.mel", "frontend.pitch",
               "frontend.embed", "acoustic", "acoustic.f0_diffusion",
               "acoustic.mel_diffusion", "vocoder", "download")


def _clip(seconds, sr=48000, f=220.0):
    t = np.arange(int(seconds * sr)) / sr
    return (0.3 * np.sin(2 * np.pi * f * t)).astype(np.float32)


def _requests():
    return [dict(ph="a b c d e", notes=[60, 62, 0, 64, 65],
                 notes_duration=[0.2, 0.3, 0.1, 0.2, 0.2],
                 note_types=[1, 1, 1, 2, 2], ref_audio=_clip(1.0)),
            dict(ph="c d", notes=[57, 59], notes_duration=[0.3, 0.2],
                 note_types=[1, 1], ref_audio=_clip(0.7, f=300.0))]


def _infer(**kw):
    """The tiny instance on the CPU, seeded, its duration head set so that
    every phone lasts 3 frames (random weights predict ~0)."""
    infer = StyleSingerInfer(tiny_test_config(**TINY, **kw),
                             phone_list=PHONES, device="cpu")
    infer.init_random(3)
    head = infer.model.dur_predictor.out
    with torch.no_grad():
        head.weight.zero_()
        head.bias.fill_(float(np.log1p(3.0)))
    return infer


@pytest.fixture(scope="module")
def infer():
    return _infer()


def _run(infer, seed=5):
    return infer.infer_batch(_requests(), noise=Noise(seed, "cpu"))


@pytest.fixture(autouse=True)
def fresh_registry():
    profiling.reset()
    yield
    profiling.reset()


def test_infer_batch_records_every_span_and_counter(infer):
    calls = {"f0": 0, "mel": 0}
    hooks = [m.register_forward_hook(
        lambda *_, k=k: calls.__setitem__(k, calls[k] + 1))
        for k, m in (("f0", infer.model.gm_diffnet),
                     ("f0", infer.model.gm_diffnet_inpainte),
                     ("mel", infer.model.postdiff))]
    try:
        with profiling.spans():
            outs = _run(infer)
    finally:
        for h in hooks:
            h.remove()
    reg = profiling.registry()
    spans, cfg = reg["spans"], infer.cfg
    assert set(spans) == set(SYNTH_SPANS)
    assert all(len(o["wav"]) > 0 for o in outs)
    want = {"infer_batch": (1, 2), "frontend": (2, 2),
            "frontend.mel": (2, 0), "frontend.pitch": (2, 0),
            "frontend.embed": (2, 0), "acoustic": (1, 2),
            "acoustic.f0_diffusion": (1, 0),
            "acoustic.mel_diffusion": (1, 0),
            "vocoder": (2, sum(len(o["wav"]) for o in outs)),
            "download": (2, 0)}
    for name, (n_calls, n) in want.items():
        s = spans[name]
        assert (s["calls"], s["n"]) == (n_calls, n), name
        assert s["host_s"] > 0 and s["device_s"] is None, name
    # children lie inside their parents on the host clock
    assert spans["frontend.pitch"]["host_s"] + spans["frontend.embed"][
        "host_s"] <= spans["frontend"]["host_s"]
    assert spans["frontend"]["host_s"] + spans["acoustic"]["host_s"] <= \
        spans["infer_batch"]["host_s"]
    c = reg["counters"]
    assert c["denoiser.f0"] == 2 * cfg["f0_timesteps"] == calls["f0"]
    assert c["denoiser.mel"] == cfg["K_step"] == calls["mel"]


@pytest.mark.parametrize("sampler", [dict(pndm_speedup=2),
                                     dict(dpm_steps=2, f0_speedup=2)])
def test_fast_samplers_count_their_denoiser_calls(sampler):
    infer = _infer(**sampler)
    calls = {"f0": 0, "mel": 0}
    for k, m in (("f0", infer.model.gm_diffnet),
                 ("f0", infer.model.gm_diffnet_inpainte),
                 ("mel", infer.model.postdiff)):
        m.register_forward_hook(
            lambda *_, k=k: calls.__setitem__(k, calls[k] + 1))
    with profiling.spans():
        _run(infer)
    reg = profiling.registry()
    assert reg["counters"]["denoiser.f0"] == calls["f0"] > 0
    assert reg["counters"]["denoiser.mel"] == calls["mel"] > 0
    assert calls["mel"] < 2 * infer.cfg["K_step"]
    assert reg["spans"]["acoustic.mel_diffusion"]["calls"] == 1


def test_outputs_with_spans_on_and_off_are_bit_identical(infer):
    off = _run(infer)
    with profiling.spans():
        on = _run(infer)
    for a, b in zip(off, on):
        for k in ("wav", "mel", "f0"):
            assert np.array_equal(a[k], b[k]), k


def test_spans_off_record_nothing_but_the_counters(infer):
    assert not profiling._REG.forced and \
        not torch._C._autograd._profiler_enabled()
    assert profiling.span("frontend") is profiling.span("vocoder", n=7)
    _run(infer)
    reg = profiling.registry()
    assert reg["spans"] == {} and reg["graphs"] == {}
    assert reg["counters"]["denoiser.f0"] == 2 * infer.cfg["f0_timesteps"]
    assert not profiling._REG.pending


def test_counters_and_launch_counters_share_the_registry():
    from stylesinger_torch.kernels import mel as melk
    from stylesinger_torch.kernels import mrf as mrfk

    before = mrfk.counter_bf16.count
    profiling.count("kernel.mrf_bf16", 3)
    assert mrfk.counter_bf16.count == before + 3
    mrfk.counter_bf16.add()
    assert profiling.registry()["counters"]["kernel.mrf_bf16"] == before + 4
    melk.counter.add()
    melk.counter.reset()
    assert melk.counter.count == 0 and mrfk.counter_bf16.count == before + 4
    profiling.reset()
    assert mrfk.counter.count == mrfk.counter_bf16.count == 0


def test_replays_report_the_counts_of_their_capture():
    """``GraphTiming`` as ``GraphedSteps`` uses it: the counts made inside
    ``capturing`` stay in the counters once; the registry's ``graphs``
    entry reports them, and them times the replays."""
    profiling.count("kernel.mrf", 2)
    with profiling.capturing(("phase", 0)) as timing:
        profiling.count("kernel.mrf", 27)
        profiling.count("denoiser.mel")
    assert timing.counts == {"kernel.mrf": 27, "denoiser.mel": 1}
    assert profiling.registry()["graphs"] == {}     # not replayed yet
    for _ in range(3):
        timing.replayed()
    reg = profiling.registry()
    c = reg["counters"]
    assert c["kernel.mrf"] == 2 + 27 and c["denoiser.mel"] == 1
    g = reg["graphs"]["('phase', 0)"]
    assert g["replays"] == 3 and g["spans"] == {}
    assert g["counts"] == {"kernel.mrf": 27, "denoiser.mel": 1}
    assert g["replayed"] == {"kernel.mrf": 81, "denoiser.mel": 3}
    assert profiling._REG.capture is None
    profiling.reset()
    assert profiling.registry()["graphs"] == {}


def test_spans_are_annotations_nested_in_infer_batch_in_the_trace(
        infer, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(infer)
    path = profiling.export_trace(prof, str(tmp_path))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    ann = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            ann.setdefault(e["name"], []).append((e["ts"],
                                                  e["ts"] + e["dur"]))
    assert set(SYNTH_SPANS) <= set(ann)
    (t0, t1), = ann["infer_batch"]
    for name in SYNTH_SPANS:
        assert all(t0 <= s <= e <= t1 for s, e in ann[name]), name
    assert len(ann["frontend"]) == len(ann["vocoder"]) == 2
    # the host operators share the annotations' clock: the convs of the
    # mel chain run inside the mel diffusion's span
    (m0, m1), = ann["acoustic.mel_diffusion"]
    convs = [e["ts"] for e in events if e.get("cat") == "cpu_op"
             and e["name"] == "aten::conv1d"]
    assert any(m0 <= ts <= m1 for ts in convs)
    # a profiler session turns the spans on, and its registry is the slice
    assert profiling.registry()["spans"]["infer_batch"]["calls"] == 1


def _trace(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        dict(ph="X", pid=0, tid=0, **e) for e in events]}))
    return str(path)


def test_idle_by_span_on_a_hand_made_trace(tmp_path):
    """Kernels (with a copy and a set) at 0-10, 20-30 (overlapping 25-40)
    and 50-60, 70-80 us; spans outer 0-100 with inner 15-45.  Gaps: 10-20
    (resumes at 20, inside inner), 40-50 (resumes at 50, outer only) and
    60-70 (resumes at 70, outer)."""
    ua = "user_annotation"
    path = _trace(tmp_path, [
        dict(cat="kernel", name="k", ts=0, dur=10),
        dict(cat="gpu_memcpy", name="c", ts=20, dur=10),
        dict(cat="kernel", name="k", ts=25, dur=15),
        dict(cat="gpu_memset", name="s", ts=50, dur=10),
        dict(cat="kernel", name="k", ts=70, dur=10),
        dict(cat="kernel", name="k", ts=200, dur=1),   # resumes at 200
        dict(cat=ua, name="outer", ts=0, dur=100),
        dict(cat=ua, name="inner", ts=15, dur=30),
        dict(cat="cpu_op", name="aten::add", ts=19, dur=1),
    ])
    idle = profiling.idle_by_span(path)
    assert idle == pytest.approx({"outer": 20e-6, "inner": 10e-6,
                                  profiling.OUTSIDE: 120e-6})
    assert "outer" in profiling.format_idle(idle)
    assert profiling.idle_by_span(_trace(tmp_path, [
        dict(cat=ua, name="outer", ts=0, dur=100)])) == {}


def test_spec2wav_records_upload_generator_and_download():
    from stylesinger_torch.models.hifigan import HifiGanGenerator
    from stylesinger_torch.vocoder_infer import HifiGAN_NSF

    cfg = tiny_test_config(**TINY)
    voc = HifiGAN_NSF(cfg, model=HifiGanGenerator(cfg), device="cpu")
    mel = np.random.default_rng(0).standard_normal(
        (20, cfg["audio_num_mel_bins"])).astype(np.float32)
    f0 = np.full(20, 200.0, np.float32)
    off = voc.spec2wav(mel, f0, noise=Noise(1, "cpu"))
    assert profiling.registry()["spans"] == {}
    with profiling.spans():
        for _ in range(2):
            on = voc.spec2wav(mel, f0, noise=Noise(1, "cpu"))
    assert np.array_equal(off, on)
    spans = profiling.registry()["spans"]
    assert set(spans) == {"spec2wav", "vocoder.upload", "vocoder",
                          "vocoder.download"}
    assert {k: s["calls"] for k, s in spans.items()} == dict.fromkeys(
        spans, 2)
    assert spans["spec2wav"]["n"] == 2 and \
        spans["vocoder"]["n"] == 2 * len(on) == 2 * 20 * cfg["hop_size"]
    assert spans["vocoder.upload"]["host_s"] + spans["vocoder"]["host_s"] \
        + spans["vocoder.download"]["host_s"] <= spans["spec2wav"]["host_s"]


def test_train_step_records_forward_backward_and_optimizer():
    """One eager ``train_step`` of the tiny model inside ``spans()``: the
    three spans, one call and one step each."""
    from stylesinger_torch.models.stylesinger import StyleSinger
    from stylesinger_torch.training import step as ts
    from test_torch_cuda import _tiny_train_batch

    cfg = tiny_test_config(rq_start=-1, diff_start=-1, forcing=0)
    torch.manual_seed(0)
    state = ts.init_state(StyleSinger(cfg, 20), cfg)
    batch = ts.batch_to_device(_tiny_train_batch(cfg), "cpu")
    with profiling.spans():
        ts.train_step(state, batch, ts.phase_for_step(0, cfg), cfg)
    spans = profiling.registry()["spans"]
    for name in ("train.forward", "train.backward", "train.optimizer"):
        assert (spans[name]["calls"], spans[name]["n"]) == (1, 1), name
        assert spans[name]["host_s"] > 0
    assert profiling.registry()["counters"]["denoiser.mel"] == 1
