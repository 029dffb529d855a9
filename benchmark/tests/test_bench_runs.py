"""Whole runs of each cell at a tiny size on the CPU (the harness's look
for a card skipped): the sound program agrees with the plain reference
(its CPU path takes the kernels' plain twins, so every number reads 0),
and each fault planted under the timed path, and the lower-precision
control where the CPU has it, turns ``correct`` false."""

import pytest
import torch

from benchmark.controls.faults import alter_output, frozen_state, half_batch
from benchmark.tests.tiny import tiny_args, tiny_cell, tiny_cfg

SYNTH = dict(traffic=dict(batch=3, batches=2, phones=[3, 6],
                          ref_s=[0.5, 1.0]),
             spec=dict(check_steps=1, slice_batches=1))
VOCODE = dict(traffic=dict(pool=4, lengths=2, frames=[140, 200]),
              spec=dict(check_requests=3, slice_requests=2))


def synth_cell():
    return tiny_cell("stylesinger.synth_batch",
                     cfg=tiny_cfg(vocoder_compute_dtype="bfloat16"), **SYNTH)


def vocode_cell():
    return tiny_cell("hifigan_nsf.vocode",
                     cfg=tiny_cfg(vocoder_compute_dtype="bfloat16"), **VOCODE)


def run(cell, **kw):
    out = cell.loop().run(tiny_args(cell, **kw))
    return out, out["checks"]


@pytest.mark.parametrize("trace", [False, True])
def test_synth_batch_agrees_with_the_reference(trace):
    cell = synth_cell()
    out, checks = run(cell, trace=trace)
    assert out["attempted"] > 0 and out["failed"] == 0
    assert checks.correct(), checks.lines()
    assert all(v == 0 for v in checks.values.values()), checks.lines()
    assert out["e2e"]["synth_audio_s_per_s"] > 0
    if trace:
        for m in cell.metrics(trace=True):
            v = cell.reader(m["name"]).read(out["ctx"])
            assert v is None or v >= 0


def test_vocode_agrees_with_the_reference():
    out, checks = run(vocode_cell(), trace=True)
    assert out["attempted"] > 0 and out["failed"] == 0
    assert checks.correct(), checks.lines()
    assert all(v == 0 for v in checks.values.values())
    assert out["e2e"]["request_p95_ms"] > 0


@pytest.mark.parametrize("where", ["mel_denoiser", "f0_denoiser", "wav",
                                   "frontend"])
def test_synth_batch_fault_is_caught(where):
    def fault(inst):
        if where == "mel_denoiser":
            alter_output(inst.model.postdiff)
        elif where == "f0_denoiser":
            alter_output(inst.model.gm_diffnet_inpainte)
        elif where == "wav":
            alter_output(inst.vocoder, 0.02)
        else:
            fn = inst.preprocess_input

            def pre(inp):
                out = fn(inp)
                out["ref_f0"] = out["ref_f0"] + 0.01
                return out
            inst.preprocess_input = pre
    _, checks = run(synth_cell(), fault=fault)
    assert not checks.correct(), checks.lines()


def test_vocode_fault_is_caught():
    _, checks = run(vocode_cell(),
                    fault=lambda voc: alter_output(voc.model, 0.02))
    assert not checks.correct(), checks.lines()


def test_vocode_float8_control_fails():
    _, checks = run(vocode_cell(), system="control")
    assert not checks.correct(), checks.lines()


@pytest.mark.cuda
def test_synth_batch_tf32_control_fails():
    """TF32 exists only on the card: the control at a tiny size there."""
    if not torch.cuda.is_available():
        pytest.skip("TF32 needs an NVIDIA GPU")
    cell = synth_cell()
    args = tiny_args(cell, system="control")
    args.device = torch.device("cuda")
    out = cell.loop().run(args)
    assert not out["checks"].correct(), out["checks"].lines()


TRAIN = dict(traffic=dict(items=12, frames=[30, 60], phones=[5, 12],
                          vocab=20),
             spec=dict(slice_windows=1))


def train_cell():
    import json

    from benchmark.harness.registry import BENCH_DIR

    spec = json.load(open(BENCH_DIR / "workloads" / "stylesinger.train.json"))
    over = dict(spec["overrides"], steps_per_dispatch=4, tb_log_interval=8)
    return tiny_cell("stylesinger.train", cfg=tiny_cfg(max_tokens=200),
                     traffic=TRAIN["traffic"],
                     spec=dict(TRAIN["spec"], overrides=over))


@pytest.mark.parametrize("trace", [False, True])
def test_train_agrees_with_the_reference(trace):
    cell = train_cell()
    out, checks = run(cell, trace=trace, seconds=2)
    assert out["attempted"] > 0 and out["failed"] == 0
    assert checks.correct(), checks.lines()
    assert out["e2e"]["train_frames_per_s"] > 0
    if trace:
        assert cell.reader("mfu.train").read(out["ctx"]) > 0


def test_train_state_left_unchanged_is_caught():
    _, checks = run(train_cell(), fault=frozen_state, seconds=2)
    assert not checks.correct(), checks.lines()
    assert checks.values["change3"] >= 0.99


def test_train_half_the_batch_is_caught(monkeypatch):
    from stylesinger_torch.training import step as step_mod

    monkeypatch.setattr(step_mod, "train_step", step_mod.train_step)
    _, checks = run(train_cell(), fault=half_batch, seconds=2)
    assert not checks.correct(), checks.lines()


@pytest.mark.cuda
def test_train_tf32_control_fails():
    if not torch.cuda.is_available():
        pytest.skip("TF32 needs an NVIDIA GPU")
    cell = train_cell()
    args = tiny_args(cell, system="control")
    args.device = torch.device("cuda")
    out = cell.loop().run(args)
    assert not out["checks"].correct(), out["checks"].lines()
