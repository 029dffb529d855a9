"""Each cost model against ``torch.utils.flop_counter.FlopCounterMode`` on
the frozen reference at a tiny size, with no padding: one request whose
predicted frames fill ``max_frames`` exactly, an unpadded reference and
phone sequence, and MRF stages shorter than two blocks (no halo)."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness.noise import DrawNoise
from benchmark.harness.registry import BENCH_DIR, load_module
from benchmark.harness.weights import seeded_state
from benchmark.reference.plain.hifigan import HifiGanGenerator
from benchmark.reference.plain.stylesinger import StyleSinger
from benchmark.tests.tiny import tiny_cfg

costs_voc = load_module(BENCH_DIR / "costs" / "hifigan_nsf.py",
                        "bench_costs_hifigan_nsf")
costs_ss = load_module(BENCH_DIR / "costs" / "stylesinger.py",
                       "bench_costs_stylesinger")


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("frames", [20, 37])
def test_vocoder_flops(frames):
    cfg = tiny_cfg(mrf_block=100000)          # every stage runs whole
    gen = HifiGanGenerator(cfg)
    gen.load_state_dict(seeded_state(gen, 1, torch.device("cpu"), 0.01))
    mel = torch.randn(1, frames, cfg["audio_num_mel_bins"])
    f0 = torch.full((1, frames), 220.0)
    with torch.no_grad():
        n = counted(lambda: gen(mel, f0, DrawNoise(0, "cpu")))
    assert costs_voc.vocoder_flops(cfg, frames) == n


@pytest.mark.parametrize("phones,per_phone,ref", [(5, 4, 23), (7, 3, 40)])
def test_acoustic_flops(phones, per_phone, ref):
    frames = phones * per_phone
    cfg = tiny_cfg(max_frames=frames)
    model = StyleSinger(cfg, 40).eval()
    sd = seeded_state(model, 2, torch.device("cpu"))
    sd["dur_predictor.out.weight"] = torch.zeros_like(
        sd["dur_predictor.out.weight"])
    sd["dur_predictor.out.bias"] = torch.full_like(
        sd["dur_predictor.out.bias"], float(np.log(1 + per_phone)))
    model.load_state_dict(sd)
    g = torch.Generator().manual_seed(3)
    batch = dict(
        txt_tokens=torch.randint(3, 40, (1, phones), generator=g),
        spk_embed=torch.randn(1, 256, generator=g),
        emo_embed=torch.randn(1, 256, generator=g),
        ref_mels=torch.rand(1, ref, cfg["audio_num_mel_bins"],
                            generator=g) - 3.0,
        ref_f0=torch.rand(1, ref, generator=g) + 7.0,
        note=torch.randint(40, 80, (1, phones), generator=g),
        note_dur=torch.rand(1, phones, generator=g),
        note_type=torch.full((1, phones), 2))
    out = {}
    with torch.no_grad():
        n = counted(lambda: out.update(model(**batch,
                                             noise=DrawNoise(0, "cpu"))))
    assert int((out["mel2ph"] > 0).sum()) == frames
    assert costs_ss.acoustic_flops(cfg, phones, ref, frames) == n


def test_request_adds_the_vocoder():
    cfg = tiny_cfg()
    a = costs_ss.acoustic_flops(cfg, 5, 20, 30)
    assert costs_ss.request_flops(cfg, 5, 20, 30) == \
        a + costs_voc.vocoder_flops(cfg, 30)
    assert costs_ss.request_flops(cfg, 5, 20, 0) == \
        costs_ss.acoustic_flops(cfg, 5, 20, 0)


def test_mrf_work_counts_the_true_rows():
    cfg = tiny_cfg(vocoder_compute_dtype="bfloat16", upsample_initial_channel=256)
    takes = costs_voc.kernel_takes(cfg)
    flops, nbytes = costs_voc.mrf_work(cfg, 100, takes)
    taps = costs_voc.mrf_taps(cfg)
    assert taps == 126
    want = sum(2.0 * t * c * c * taps
               for c, t in costs_voc.stages(cfg, 100) if takes(c, t))
    assert flops == want and nbytes > 0


@pytest.mark.parametrize("phones,frames", [(5, 24), (9, 40)])
def test_training_pass_flops(phones, frames):
    """The training pass and its losses on one unpadded item (its own mel
    as the reference): 3 x this is what ``train_step_flops`` counts."""
    from benchmark.reference.plain.losses import compute_losses
    from benchmark.reference.plain.train import model_inputs

    cfg = tiny_cfg(max_frames=frames)
    model = StyleSinger(cfg, 40)
    model.load_state_dict(seeded_state(model, 4, torch.device("cpu")))
    g = torch.Generator().manual_seed(5)
    mel2ph = torch.sort(torch.randint(1, phones + 1, (1, frames),
                                      generator=g)).values
    mel2ph[0, :phones] = torch.arange(1, phones + 1)
    mel2ph = torch.sort(mel2ph).values
    batch = dict(
        txt_tokens=torch.randint(3, 40, (1, phones), generator=g),
        mel2ph=mel2ph,
        spk_embed=torch.randn(1, 256, generator=g),
        emo_embed=torch.randn(1, 256, generator=g),
        mels=torch.randn(1, frames, cfg["audio_num_mel_bins"],
                         generator=g) - 3.0,
        f0=torch.rand(1, frames, generator=g) + 7.0,
        uv=(torch.rand(1, frames, generator=g) > 0.8).float(),
        notes=torch.randint(40, 80, (1, phones), generator=g),
        note_durs=torch.rand(1, phones, generator=g),
        note_types=torch.full((1, phones), 2))
    noise = {k: DrawNoise(i, "cpu") for i, k in
             enumerate(("dropout", "umln", "rq", "diffusion"))}

    def step():
        ret = model(**model_inputs(batch), noise=noise, infer=False,
                    use_rq=True, forcing=False, use_diff=True)
        compute_losses(ret, batch, cfg, use_rq=True, forcing=False,
                       use_diff=True)
    n = counted(step)
    assert costs_ss.acoustic_flops(cfg, phones, frames, frames,
                                   training=True) == n
    lengths = [(phones, frames), (0, 0)]
    assert costs_ss.train_step_flops(cfg, lengths) == 3 * n
