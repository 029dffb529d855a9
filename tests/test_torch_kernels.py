"""The port's two kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain twin, which is held against the
Pallas kernel (interpret mode) and its XLA twin with the tolerances of
``tests/test_ops.py``.  ``tests/test_torch_cuda.py`` holds each CUDA
kernel against its twin on the card.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from stylesinger_tpu.dsp.mel import wav2mel as jax_wav2mel
from stylesinger_tpu.models.hifigan import ResBlock1 as JaxResBlock1
from stylesinger_tpu.models.hifigan import _blockify as jax_blockify
from stylesinger_tpu.ops.mel_pallas import mel_spectrogram as pallas_mel
from stylesinger_tpu.ops.mrf_pallas import fused_mrf_blocks as pallas_mrf

from stylesinger_torch.config import load_config, tiny_test_config
from stylesinger_torch.kernels import mel as melk
from stylesinger_torch.kernels import mrf as mrfk
from stylesinger_torch.models.hifigan import (
    HifiGanGenerator, ResBlock1, _blockify, _unblockify,
)

MEL_CASES = {
    "48k": (48000, 0.3, dict()),
    "24k": (2048, 1.0, dict(sample_rate=24000, n_fft=512, hop_size=128,
                            win_length=512, n_mels=40, fmax=12000.0)),
    # n_fft outside the FFT's powers of two <= 1024 (the kernel's direct DFT
    # branch and its FFT in dynamic shared memory)
    "nfft1000": (24000, 0.3, dict(n_fft=1000, hop_size=250,
                                  win_length=1000)),
    "nfft2048": (24000, 0.3, dict(n_fft=2048, hop_size=512,
                                  win_length=2048)),
}
MRF_CASES = {
    "C16": (16, 64, 150, (3, 7, 11), ((1, 3, 5),) * 3),
    "C64": (64, 32, 70, (3, 5), ((1, 2), (1, 3))),
}


def _mel_input(case):
    n, scale, kw = MEL_CASES[case]
    wav = np.random.default_rng(11).standard_normal(n).astype(np.float32)
    return wav * scale, kw


@pytest.mark.parametrize("case", sorted(MEL_CASES))
def test_mel_twin_matches_jax_and_pallas(case):
    wav, kw = _mel_input(case)
    ours = melk.mel_spectrogram(torch.as_tensor(wav), **kw).numpy()
    ref = np.asarray(jax_wav2mel(jnp.asarray(wav), **kw))
    pallas = np.asarray(pallas_mel(jnp.asarray(wav), interpret=True, **kw))
    assert ours.shape == ref.shape == pallas.shape
    np.testing.assert_allclose(ours, ref, atol=3e-3, rtol=2e-3)
    np.testing.assert_allclose(ours, pallas, atol=3e-3, rtol=2e-3)


def _mrf_setup(case):
    c, block, t, rk, rd = MRF_CASES[case]
    halo = max(JaxResBlock1.halo(k, d) for k, d in zip(rk, rd))
    x = np.random.default_rng(c).standard_normal((1, t, c)).astype(np.float32)
    xb, mask, _ = jax_blockify(jnp.asarray(x), block, halo)
    blocks = [JaxResBlock1(c, k, d) for k, d in zip(rk, rd)]
    variables = [b.init(jax.random.PRNGKey(c), xb, mask) for b in blocks]
    weights = []
    for v, d in zip(variables, rd):
        p = v["params"]
        weights.append([((p[f"conv1_{i}"]["kernel"], p[f"conv1_{i}"]["bias"]),
                         (p[f"conv2_{i}"]["kernel"], p[f"conv2_{i}"]["bias"]))
                        for i in range(len(d))])
    return dict(c=c, block=block, halo=halo, rk=rk, rd=rd, x=x, xb=xb,
                mask=mask, blocks=blocks, variables=variables,
                weights=weights)


def _torch_weights(weights, device="cpu"):
    return [[tuple((torch.tensor(np.asarray(w), device=device),
                    torch.tensor(np.asarray(b), device=device))
                   for w, b in pair) for pair in rb] for rb in weights]


@pytest.mark.parametrize("case", sorted(MRF_CASES))
def test_mrf_twin_matches_pallas_and_blocked_resblocks(case):
    s = _mrf_setup(case)
    kw = dict(kernels=s["rk"], dilations=s["rd"], block=s["block"],
              halo=s["halo"])
    halo, block = s["halo"], s["block"]
    flax_ref = sum(np.asarray(b.apply(v, s["xb"], s["mask"]))
                   for b, v in zip(s["blocks"], s["variables"]))
    flax_ref = flax_ref[:, halo:halo + block] / len(s["blocks"])
    pallas = np.asarray(pallas_mrf(s["xb"], s["mask"], s["weights"],
                                   interpret=True, **kw))
    ours = mrfk.fused_mrf_blocks(
        torch.tensor(np.asarray(s["xb"])),
        torch.tensor(np.asarray(s["mask"])), _torch_weights(s["weights"]),
        **kw).numpy()
    assert ours.shape == flax_ref.shape == pallas.shape
    np.testing.assert_allclose(ours, flax_ref, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(ours, pallas, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("case", sorted(MRF_CASES))
def test_mrf_schedule_of_plain_steps_matches_twin_and_pallas(case):
    """The launch schedule of the CUDA path (which step reads which buffer,
    residual, block sum, crop, scale), driven with a plain step that
    computes what one launch computes."""
    s = _mrf_setup(case)
    kw = dict(kernels=s["rk"], dilations=s["rd"], block=s["block"],
              halo=s["halo"])
    xb = torch.tensor(np.asarray(s["xb"]))
    mask = torch.tensor(np.asarray(s["mask"]))
    weights = _torch_weights(s["weights"])
    steps = []

    def step(*args, **step_kw):
        steps.append(step_kw["k"])
        mrfk.mrf_step_plain(*args, **step_kw)

    ours = mrfk.mrf_schedule(xb, mask, weights, step=step, **kw).numpy()
    assert len(steps) == sum(len(d) for d in s["rd"])
    twin = mrfk.mrf_blocks_plain(xb, mask, weights, **kw).numpy()
    pallas = np.asarray(pallas_mrf(s["xb"], s["mask"], s["weights"],
                                   interpret=True, **kw))
    np.testing.assert_allclose(ours, twin, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(ours, pallas, atol=2e-5, rtol=1e-4)


def _tf32(a):
    """Round to TF32 by clearing the low 13 of f32's 23 mantissa bits."""
    return (a.contiguous().view(torch.int32) & -8192).view(torch.float32)


def _conv_tf32(a, w, **kw):
    return F.conv1d(_tf32(a), _tf32(w), **kw)


def _conv_3xtf32(a, w, **kw):
    a_hi, w_hi = _tf32(a), _tf32(w)
    a_lo, w_lo = _tf32(a - a_hi), _tf32(w - w_hi)
    return (F.conv1d(a_lo, w_hi, **kw) + F.conv1d(a_hi, w_lo, **kw)
            + F.conv1d(a_hi, w_hi, **kw))


def test_mrf_3xtf32_split_meets_the_tolerance_one_tf32_term_does_not(
        record_property):
    """Why the kernel splits each operand into two TF32 halves: with the
    products rounded as the tensor cores round them, three terms
    (lo*hi + hi*lo + hi*hi) reproduce the f32 twin within the card check's
    1e-4 * max|y|; one TF32 product does not.  At the card test's C128
    case (flagship group)."""
    c, block, t = 128, 256, 700
    rk, rd = (3, 7, 11), ((1, 3, 5),) * 3
    halo = max(ResBlock1.halo(k, d) for k, d in zip(rk, rd))
    rng = np.random.default_rng(c)
    xb, mask, _ = _blockify(torch.as_tensor(
        rng.standard_normal((1, t, c)).astype(np.float32)), block, halo)
    weights = [[tuple((torch.as_tensor(rng.standard_normal((k, c, c))
                                       .astype(np.float32) / math.sqrt(k * c)),
                       torch.as_tensor(0.1 * rng.standard_normal(c)
                                       .astype(np.float32)))
                      for _ in range(2)) for _ in ds]
               for k, ds in zip(rk, rd)]
    kw = dict(kernels=rk, dilations=rd, block=block, halo=halo)
    twin = mrfk.mrf_blocks_plain(xb, mask, weights, **kw)
    scale = float(twin.abs().max())
    errs = {}
    for name, conv in (("3xtf32", _conv_3xtf32), ("tf32", _conv_tf32)):
        def step(*args, _conv=conv, **step_kw):
            mrfk.mrf_step_plain(*args, conv=_conv, **step_kw)
        y = mrfk.mrf_schedule(xb, mask, weights, step=step, **kw)
        errs[name] = float((y - twin).abs().max()) / scale
        record_property(f"rel_err_{name}", errs[name])
    assert errs["3xtf32"] <= 1e-4, errs
    assert errs["tf32"] > 1e-4, errs


@pytest.mark.parametrize("c", [24, 128])
def test_mrf_kernel_layout_is_the_split_weight_in_core_matrix_order(c):
    """The image the CUDA kernel copies into shared memory: per tap and 32
    input channels, the TF32 halves of W, zero-padded to the tile, with
    (co, ci) at ((co // 8) * 8 + ci // 4) * 32 + (co % 8) * 4 + ci % 4."""
    k, bn, kpad = 3, mrfk.tile_n(c), -(-c // 32) * 32
    rng = np.random.default_rng(c)
    w = torch.as_tensor(rng.standard_normal((k, c, c)).astype(np.float32))
    b = torch.zeros(c)
    [[((laid, _), _)]] = mrfk._kernel_layout([[((w, b), (w, b))]], c)
    assert laid.shape == (k, kpad // 32, 2, 32 * bn) and laid.is_contiguous()
    bits = laid.view(torch.int32) & 0x1FFF
    assert int(bits.abs().max()) == 0  # both halves are TF32 values
    tap, ci, co = np.meshgrid(np.arange(k), np.arange(kpad), np.arange(bn),
                              indexing="ij")
    cc = ci % 32
    pos = ((co // 8) * 8 + cc // 4) * 32 + (co % 8) * 4 + cc % 4
    image = (laid[:, :, 0] + laid[:, :, 1]).numpy()[tap, ci // 32, pos]
    ref = np.zeros((k, kpad, bn), np.float32)
    ref[:, :c, :c] = w.numpy()
    np.testing.assert_allclose(image, ref, rtol=2 ** -20, atol=0)


@pytest.mark.parametrize("case", sorted(MRF_CASES))
def test_blockify_matches_jax(case):
    s = _mrf_setup(case)
    xb, mask, t = _blockify(torch.as_tensor(s["x"]), s["block"], s["halo"])
    np.testing.assert_array_equal(xb.numpy(), np.asarray(s["xb"]))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(s["mask"]))
    back = _unblockify(xb, 1, s["block"], s["halo"], t)
    np.testing.assert_array_equal(back.numpy(), s["x"])


def test_wrappers_take_the_twin_on_cpu_and_refuse_other_devices():
    wav = torch.zeros(4096)
    before = (melk.counter.count, mrfk.counter.count)
    melk.mel_spectrogram(wav)
    s = _mrf_setup("C64")
    kw = dict(kernels=s["rk"], dilations=s["rd"], block=s["block"],
              halo=s["halo"])
    mrfk.fused_mrf_blocks(torch.tensor(np.asarray(s["xb"])),
                          torch.tensor(np.asarray(s["mask"])),
                          _torch_weights(s["weights"]), **kw)
    assert (melk.counter.count, mrfk.counter.count) == before
    with pytest.raises(ValueError, match="device"):
        melk.mel_spectrogram(torch.zeros(4096, device="meta"))
    with pytest.raises(ValueError, match="device"):
        mrfk.fused_mrf_blocks(torch.zeros((1, 184, 16), device="meta"),
                              torch.zeros((1, 184, 1), device="meta"),
                              [], kernels=(), dilations=(), block=64,
                              halo=60)


def _ulp_bf16(v: float) -> float:
    """The spacing of bf16 values at v (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(v)) - 7)


@pytest.mark.parametrize("case", sorted(MRF_CASES))
def test_mrf_bf16_twin_matches_pallas_bf16(case, record_property):
    """The bf16 mode's twin against the Pallas kernel at
    compute_dtype=bfloat16 (interpret mode): within 2 bf16 ulps of max|y|.
    They differ at one point only: the kernel text rounds each resblock's
    last residual to bf16 before the f32 block sum, and the twin does, but
    XLA's CPU interpret path leaves that value unrounded.  Beside it, the
    band of tests/test_ops.py::test_mrf_pallas_bf16_precision: against the
    f32 twin, no more than 4x the flax bf16 resblocks' own error (or
    0.05)."""
    s = _mrf_setup(case)
    kw = dict(kernels=s["rk"], dilations=s["rd"], block=s["block"],
              halo=s["halo"])
    halo, block = s["halo"], s["block"]
    pallas = np.asarray(pallas_mrf(
        s["xb"], s["mask"], s["weights"], interpret=True,
        compute_dtype=jnp.bfloat16, **kw).astype(jnp.float32))
    xb = torch.tensor(np.asarray(s["xb"])).to(torch.bfloat16)
    mask = torch.tensor(np.asarray(s["mask"])).to(torch.bfloat16)
    ours = mrfk.fused_mrf_blocks(xb, mask, _torch_weights(s["weights"]),
                                 compute_dtype=torch.bfloat16, **kw)
    assert ours.dtype == torch.bfloat16
    ours = ours.float().numpy()
    scale = float(np.abs(pallas).max())
    err = float(np.abs(ours - pallas).max())
    record_property("ulps_of_max", err / _ulp_bf16(scale))
    assert ours.shape == pallas.shape
    assert err <= 2 * _ulp_bf16(scale), (err, scale)

    blocks16 = [JaxResBlock1(s["c"], k, d, dtype=jnp.bfloat16)
                for k, d in zip(s["rk"], s["rd"])]
    flax16 = sum(np.asarray(b.apply(v, s["xb"].astype(jnp.bfloat16),
                                    s["mask"].astype(jnp.bfloat16))
                            .astype(jnp.float32))
                 for b, v in zip(blocks16, s["variables"]))
    flax16 = flax16[:, halo:halo + block] / len(blocks16)
    ref32 = mrfk.mrf_blocks_plain(
        torch.tensor(np.asarray(s["xb"])),
        torch.tensor(np.asarray(s["mask"])), _torch_weights(s["weights"]),
        **kw).numpy()
    d_ours = np.abs(ours - ref32).max()
    d_flax = np.abs(flax16 - ref32).max()
    assert d_ours < max(4 * d_flax, 0.05), (d_ours, d_flax)


@pytest.mark.parametrize("case", sorted(MRF_CASES))
def test_mrf_bf16_schedule_of_plain_steps_matches_twin(case):
    """The launch schedule in the bf16 mode: bf16 residual buffers, the f32
    block sum, the bf16 output, each step rounding where the kernel does,
    gives the twin bit for bit."""
    s = _mrf_setup(case)
    kw = dict(kernels=s["rk"], dilations=s["rd"], block=s["block"],
              halo=s["halo"])
    xb = torch.tensor(np.asarray(s["xb"])).to(torch.bfloat16)
    mask = torch.tensor(np.asarray(s["mask"])).to(torch.bfloat16)
    weights = _torch_weights(s["weights"])
    outs = []

    def step(*args, **step_kw):
        outs.append(args[6].dtype)
        mrfk.mrf_step_plain(*args, **step_kw)

    ours = mrfk.mrf_schedule(xb, mask, weights, step=step, **kw)
    twin = mrfk.mrf_blocks_plain_bf16(xb, mask, weights, **kw)
    assert ours.dtype == twin.dtype == torch.bfloat16
    # each resblock's last step writes the f32 block sum, but the group's
    # last, which writes the bf16 output
    n = [len(d) for d in s["rd"]]
    ends = {sum(n[:j + 1]) - 1 for j in range(len(n) - 1)}
    assert outs == [torch.float32 if i in ends else torch.bfloat16
                    for i in range(sum(n))]
    assert torch.equal(ours, twin)


@pytest.mark.parametrize("c", [10, 128])
def test_mrf_bf16_layout_is_the_weight_in_core_matrix_order(c):
    """The bf16 image: per tap and 32 input channels, W as bf16, zero-padded
    to the tile, (co, ci) at ((co // 8) * 4 + ci // 8) * 64 + (co % 8) * 8 +
    ci % 8."""
    k, bn, kpad = 3, mrfk.tile_n(c), -(-c // 32) * 32
    rng = np.random.default_rng(c)
    w = torch.as_tensor(rng.standard_normal((k, c, c)).astype(np.float32))
    b = torch.zeros(c)
    [[((laid, bias), _)]] = mrfk._kernel_layout_bf16([[((w, b), (w, b))]], c)
    assert laid.shape == (k, kpad // 32, 32 * bn) and laid.is_contiguous()
    assert laid.dtype == torch.bfloat16 and bias.dtype == torch.float32
    tap, ci, co = np.meshgrid(np.arange(k), np.arange(kpad), np.arange(bn),
                              indexing="ij")
    cc = ci % 32
    pos = ((co // 8) * 4 + cc // 8) * 64 + (co % 8) * 8 + cc % 8
    image = laid.float().numpy()[tap, ci // 32, pos]
    ref = np.zeros((k, kpad, bn), np.float32)
    ref[:, :c, :c] = w.to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(image, ref)


def test_mrf_stage_routing_rule():
    """A blocked stage goes to the kernel when it is ResBlock1, C <= 128 and
    every (k - 1) * d <= 64; other blocked stages run the resblock modules,
    and a stage shorter than two blocks runs them unblocked."""
    assert mrfk.takes_stage(128, (3, 7, 11), ((1, 3, 5),) * 3)
    assert not mrfk.takes_stage(256, (3, 7, 11), ((1, 3, 5),) * 3)
    assert mrfk.takes_stage(64, (3, 11), ((1,), (1, 3, 6)))   # reach 60
    assert not mrfk.takes_stage(64, (3, 11), ((1,), (1, 7)))  # reach 70
    for cfg, frames, routes in (
            # 512 -> 256, 128, 64, 32 channels; 3000 frames x 8, 64, 128, 256
            (load_config(), 3000, ["blocks", "kernel", "kernel", "kernel"]),
            (load_config(recipe="stylesinger"), 3000,
             ["blocks", "kernel", "kernel", "kernel"]),
            # 16 frames: stages of 128 to 4096 samples, two blocks at 4096
            (load_config(), 16, ["modules", "modules", "modules", "kernel"]),
            (load_config(resblock_dilation_sizes=((1, 3, 5), (1, 3, 5),
                                                  (1, 3, 7))), 3000,
             ["blocks"] * 4),
            (tiny_test_config(mrf_block=64, resblock="2"), 40,
             ["blocks"] * 4)):
        gen = HifiGanGenerator(cfg)
        assert gen.mrf_routes(frames) == routes


def test_mrf_wrapper_refuses_a_type_other_than_compute_dtype():
    s = _mrf_setup("C64")
    kw = dict(kernels=s["rk"], dilations=s["rd"], block=s["block"],
              halo=s["halo"])
    xb = torch.tensor(np.asarray(s["xb"]))
    mask = torch.tensor(np.asarray(s["mask"]))
    with pytest.raises(ValueError, match="bfloat16"):
        mrfk.fused_mrf_blocks(xb, mask, _torch_weights(s["weights"]),
                              compute_dtype=torch.bfloat16, **kw)
    with pytest.raises(ValueError, match="neither"):
        mrfk.fused_mrf_blocks(xb, mask, _torch_weights(s["weights"]),
                              compute_dtype=torch.float16, **kw)
