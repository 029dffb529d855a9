"""The CUDA kernels against their plain twins, on the card.

Marked ``cuda``: they skip where there is no GPU.  This file imports no JAX,
so it also runs on a GPU machine without JAX, bypassing the JAX-importing
``conftest.py``:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from stylesinger_torch.config import tiny_test_config
from stylesinger_torch.inference import init_random_
from stylesinger_torch.kernels import diffnet as dk
from stylesinger_torch.kernels import mel as melk
from stylesinger_torch.kernels import mrf as mrfk
from stylesinger_torch.models.diffusion import Noise
from stylesinger_torch.models.hifigan import (
    HifiGanGenerator, ResBlock1, _blockify,
)

MEL_CASES = {
    "48k": (48000, dict()),
    # 189 frames: not a multiple of the kernel's 4 frames per block, and
    # the last FFT carries one real frame and an empty partner
    "48k_ragged": (48256, dict()),
    "24k": (2048, dict(sample_rate=24000, n_fft=512, hop_size=128,
                       win_length=512, n_mels=40, fmax=12000.0)),
    # not a power of two: the direct DFT branch, one pass of bins
    "nfft1000": (48000, dict(n_fft=1000, win_length=1000, hop_size=250)),
    # ... and three passes of bins (1501 > 2 x 256 per pass)
    "nfft3000": (24000, dict(n_fft=3000, win_length=2400, hop_size=300)),
    # FFTs past the static 48 KB of shared memory, up to the 4096 limit
    "nfft2048": (48000, dict(n_fft=2048, win_length=2048, hop_size=512)),
    "nfft4096": (48000, dict(n_fft=4096, win_length=4096, hop_size=1024)),
}
MRF_CASES = {  # C, block, T, kernels, dilations
    "C16": (16, 64, 150, (3, 7, 11), ((1, 3, 5),) * 3),
    "C24": (24, 64, 300, (3, 7, 11), ((1, 3, 5),) * 3),
    "C64": (64, 32, 70, (3, 5), ((1, 2), (1, 3))),
    # C not a multiple of 4: the kernel's 4-byte copies of the input rows
    "C10": (10, 64, 150, (3, 5), ((1, 2), (1, 3))),
    "C128": (128, 256, 700, (3, 7, 11), ((1, 3, 5),) * 3),
    # the flagship block 2048 / halo 60, whose k = 11, d = 5 step has the
    # widest reach; batch 2 x 1 block: nb = 2
    "flagship": (128, 2048, 2048, (3, 7, 11), ((1, 3, 5),) * 3),
}


@pytest.fixture
def cuda():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(MEL_CASES))
def test_mel_kernel_matches_twin(cuda, case):
    n, kw = MEL_CASES[case]
    x = torch.as_tensor(np.random.default_rng(11).standard_normal(n)
                        .astype(np.float32) * 0.3, device=cuda)
    consts = melk._constants(kw.get("sample_rate", 48000),
                             kw.get("n_fft", 1024),
                             kw.get("win_length", 1024),
                             kw.get("n_mels", 80), 20.0,
                             float(kw.get("fmax", 24000.0)), cuda)
    before = melk.counter.count
    out = melk.mel_spectrogram(x, **kw)
    ref = melk.mel_spectrogram_plain(x, *consts, kw.get("hop_size", 256),
                                     1e-6)
    torch.cuda.synchronize()
    assert melk.counter.count == before + 1
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               atol=3e-3, rtol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(MRF_CASES))
def test_mrf_kernel_matches_twin(cuda, case):
    c, block, t, rk, rd = MRF_CASES[case]
    halo = max(ResBlock1.halo(k, d) for k, d in zip(rk, rd))
    gen = torch.Generator(device=cuda).manual_seed(c)
    xb, mask, _ = _blockify(torch.randn((2, t, c), generator=gen,
                                        device=cuda), block, halo)
    weights = [[tuple((torch.randn((k, c, c), generator=gen, device=cuda)
                       / math.sqrt(k * c),
                       0.1 * torch.randn((c,), generator=gen, device=cuda))
                      for _ in range(2)) for _ in ds]
               for k, ds in zip(rk, rd)]
    kw = dict(kernels=rk, dilations=rd, block=block, halo=halo)
    before = mrfk.counter.count
    out = mrfk.fused_mrf_blocks(xb, mask, weights, **kw)
    ref = mrfk.mrf_blocks_plain(xb, mask, weights, **kw)
    torch.cuda.synchronize()
    # one launch per dilation step
    assert mrfk.counter.count == before + sum(len(d) for d in rd)
    # the kernel sums in another order than cuDNN: 1e-4 of max|y|
    err = (out - ref).abs().max().item() / ref.abs().max().item()
    assert out.shape == ref.shape and err <= 1e-4, err


def _ulp_bf16(v: float) -> float:
    """The spacing of bf16 values at v (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(v)) - 7)


BF16_CASES = ("C10", "C64", "C128", "flagship")


@pytest.mark.cuda
@pytest.mark.parametrize("case", BF16_CASES)
def test_mrf_bf16_kernel_matches_bf16_twin(cuda, case):
    """The bf16 mode against its twin, both rounding to bf16 at the same
    points: they differ only where an f32 sum in another order lands on
    the other side of a bf16 rounding, within 2 bf16 ulps of max|y|."""
    c, block, t, rk, rd = MRF_CASES[case]
    halo = max(ResBlock1.halo(k, d) for k, d in zip(rk, rd))
    gen = torch.Generator(device=cuda).manual_seed(c)
    x = torch.randn((2, t, c), generator=gen, device=cuda)
    xb, mask, _ = _blockify(x.to(torch.bfloat16), block, halo)
    weights = [[tuple((torch.randn((k, c, c), generator=gen, device=cuda)
                       / math.sqrt(k * c),
                       0.1 * torch.randn((c,), generator=gen, device=cuda))
                      for _ in range(2)) for _ in ds]
               for k, ds in zip(rk, rd)]
    kw = dict(kernels=rk, dilations=rd, block=block, halo=halo)
    before = mrfk.counter_bf16.count
    out = mrfk.fused_mrf_blocks(xb, mask, weights,
                                compute_dtype=torch.bfloat16, **kw)
    ref = mrfk.mrf_blocks_plain_bf16(xb, mask, weights, **kw)
    torch.cuda.synchronize()
    assert mrfk.counter_bf16.count == before + sum(len(d) for d in rd)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2 * _ulp_bf16(ref.float().abs().max().item()), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generator_past_the_kernels_reach_matches_cpu(cuda, dtype):
    """A resblock with k = 11, d = 7 (reach 70 > 64) routes its stages to
    the resblock modules; the card's wav matches the CPU's."""
    cfg = tiny_test_config(mrf_block=64, resblock_kernel_sizes=(3, 11),
                           resblock_dilation_sizes=((1, 3), (1, 7)),
                           vocoder_compute_dtype=dtype)
    cpu = HifiGanGenerator(cfg)
    init_random_(cpu, torch.Generator().manual_seed(0), conv_std=0.05)
    gpu = HifiGanGenerator(cfg)
    gpu.load_state_dict(cpu.state_dict())
    gpu.to(cuda)
    assert set(cpu.mrf_routes(40)) == {"blocks"}
    mel = torch.randn((1, 40, cfg["audio_num_mel_bins"]),
                      generator=torch.Generator().manual_seed(1))
    f0 = torch.full((1, 40), 220.0)
    before = (mrfk.counter.count, mrfk.counter_bf16.count)
    with torch.no_grad():
        ref = cpu(mel, f0, Noise(2, "cpu"))
        out = gpu(mel.to(cuda), f0.to(cuda),
                  _CpuDraws(Noise(2, "cpu"), cuda))
    assert (mrfk.counter.count, mrfk.counter_bf16.count) == before
    tol = 1e-5 if dtype == "float32" else 2e-2 * ref.abs().max().item()
    assert (out.cpu() - ref).abs().max().item() <= tol


class _CpuDraws:
    """Draws from a CPU noise source, handed over on the card."""

    def __init__(self, noise, device):
        self.noise, self.device = noise, device

    def normal(self, shape):
        return self.noise.normal(shape).to(self.device)

    def uniform(self, shape):
        return self.noise.uniform(shape).to(self.device)

    def randint(self, shape, low, high):
        return self.noise.randint(shape, low, high).to(self.device)

    def bernoulli(self, p, shape=()):
        return self.noise.bernoulli(p, shape).to(self.device)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("c", [192, 256])
def test_diffnet_layer_kernel_matches_twin(cuda, c, d):
    """The recipe's 16 x 3000 rows at the F0 (192) and mel (256) widths,
    each dilation of the cycle: the kernel through the operator against
    the plain twin (cuDNN f32, TF32 off), the layer's output and the skip
    sum (the first layer's write and a later layer's add) within 1e-5 of
    their max, one counted launch a call."""
    g = torch.Generator(device=cuda).manual_seed(c + d)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=cuda) * scale

    w_dil, w_out = r(2 * c, c, 3, scale=(3 * c) ** -0.5), \
        r(2 * c, c, 1, scale=c ** -0.5)
    b_out, x, pstep = r(2 * c, scale=0.1), r(16, 3000, c), r(16, c)
    cp, skips = r(16, 3000, 2 * c), r(16, 3000, c)
    dk.counter.reset()
    for first in (True, False):
        want_s, got_s = skips.clone(), skips.clone()
        want = dk.layer_plain(x, pstep, cp, w_dil, w_out, b_out, want_s,
                              dilation=d, first=first)
        got = dk.diffnet_layer(x, pstep, cp, w_dil, w_out, b_out, got_s,
                               dilation=d, first=first)
        torch.cuda.synchronize()
        assert _rel(got, want) <= 1e-5, (first, _rel(got, want))
        assert _rel(got_s, want_s) <= 1e-5, (first, _rel(got_s, want_s))
    assert dk.counter.count == 2


@pytest.mark.cuda
def test_diffnet_layer_refuses_autograd(cuda):
    """The layer kernel has no backward: on CUDA tensors the wrapper raises
    while autograd records a weight or an input that requires grad, and
    runs under no_grad."""
    c, t = 64, 40
    args = [torch.randn(2, t, c, device=cuda), torch.randn(2, c, device=cuda),
            torch.randn(2, t, 2 * c, device=cuda),
            torch.randn(2 * c, c, 3, device=cuda) / 14,
            torch.randn(2 * c, c, 1, device=cuda) / 8,
            torch.zeros(2 * c, device=cuda)]
    skips = torch.zeros(2, t, c, device=cuda)
    for i in (0, 3):
        grad_args = list(args)
        grad_args[i] = args[i].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            dk.diffnet_layer(*grad_args, skips, dilation=2, first=True)
        with torch.no_grad():
            dk.diffnet_layer(*grad_args, skips, dilation=2, first=True)


class _Given:
    """Hands out one given draw."""

    def __init__(self, z):
        self.z = z

    def normal(self, shape):
        assert tuple(shape) == tuple(self.z.shape)
        return self.z


@pytest.mark.cuda
def test_recipe_request_on_the_kernel_matches_the_module_path(cuda):
    """One request at the recipe's widths (seeded random weights, seeded
    draws) runs every residual layer on the kernel: 2 x 100 x 10 F0 and
    100 x 20 mel launches.  At the first, a middle and the last call of
    each denoiser, the call again on the module path: the output within
    the benchmark's ``f0_net`` / ``mel_net`` limits (2.5e-4 / 2e-4 of its
    max) and the Gaussian step taken from each within ``f0_step`` /
    ``mel_step``'s 3e-6."""
    from stylesinger_torch.config import load_config
    from stylesinger_torch.inference import StyleSingerInfer
    from stylesinger_torch.models import diffusion as diff

    cfg = load_config(recipe="stylesinger")
    req = dict(ph="a b c d e f", notes=[60, 62, 0, 64, 65, 67],
               notes_duration=[0.4, 0.3, 0.2, 0.5, 0.3, 0.6],
               note_types=[1] * 6)
    infer = StyleSingerInfer(cfg, phone_list=sorted(req["ph"].split()),
                             device=cuda)
    infer.init_random(3)
    with torch.no_grad():
        infer.model.dur_predictor.out.bias.fill_(math.log1p(60.0))
    model = infer.model
    calls = {"f0": [], "mel": []}

    def keep(kind):
        def hook(module, args, out):
            calls[kind].append((tuple(a.clone() for a in args), out.clone()))
        return hook

    hooks = [model.gm_diffnet.register_forward_hook(keep("f0")),
             model.postdiff.register_forward_hook(keep("mel"))]
    t = np.arange(48000 * 3) / 48000
    wav = (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    dk.counter.reset()
    try:
        infer.forward_model(infer.preprocess_input(dict(req, ref_audio=wav)),
                            noise=Noise(5, cuda))
    finally:
        for h in hooks:
            h.remove()
    assert dk.counter.count == 2 * 100 * 10 + 100 * 20
    assert len(calls["f0"]) == len(calls["mel"]) == 100
    limits = {"f0": (model.gm_diffnet, model.f0_sched, 2.5e-4),
              "mel": (model.postdiff, model.mel_sched, 2e-4)}
    for kind, (net, sched, net_limit) in limits.items():
        for i in (0, 50, 99):
            args, out = calls[kind][i]
            before = dk.counter.count
            with torch.enable_grad():  # the module path: autograd records
                want = net(*args).detach()
            assert dk.counter.count == before
            assert _rel(out, want) <= net_limit, (kind, i, _rel(out, want))
            x, step = args[0], args[2 if kind == "f0" else 1]
            z = torch.randn(x.shape, generator=torch.Generator(
                device=cuda).manual_seed(i), device=cuda)
            nxt = [diff.gaussian_p_sample(sched, x, step,
                                          o[..., :x.shape[-1]], _Given(z))
                   for o in (out, want)]
            assert _rel(*nxt) <= 3e-6, (kind, i, _rel(*nxt))


@pytest.mark.cuda
def test_graphed_train_steps_launch_no_diffnet_kernel(cuda, tmp_path):
    """At widths the kernel takes (64 channels), a graphed train step's
    capture and an eager step run every residual layer on the module
    path: autograd records the weights."""
    from stylesinger_torch.models.stylesinger import StyleSinger
    from stylesinger_torch.training import step as ts
    from stylesinger_torch.training.trainer import Trainer

    cfg = tiny_test_config(forcing=2, rq_start=-1, diff_start=-1,
                           steps_per_dispatch=2, residual_channels=64,
                           f0_residual_channels=64, f0_residual_layers=2,
                           residual_layers=2)
    trainer = Trainer(StyleSinger(cfg, 20), cfg, str(tmp_path), device=cuda)
    stacked, _ = trainer._stack_batches([_tiny_train_batch(cfg)])
    state = ts.init_state(StyleSinger(cfg, 20).to(cuda), cfg)
    dk.counter.reset()
    scan = ts.make_train_scan(cfg)
    m = scan(state, stacked, [0, 0], ts.phase_for_step(0, cfg))
    ts.train_step(state, {k: v[0] for k, v in stacked.items()},
                  ts.phase_for_step(2, cfg), cfg)
    torch.cuda.synchronize()
    assert len(scan.graphs.capture_seconds) == 1
    assert all(torch.isfinite(v).all() for v in m.values())
    assert dk.counter.count == 0


def _tiny_train_batch(cfg, seed=0, n=4):
    """The tiny model's ``n``-item batch (seeded) of the card-against-CPU
    train step tests."""
    from stylesinger_torch.data.batching import collate_batch
    from stylesinger_torch.data.dataset import StyleSingerDataset

    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        t = int(rng.integers(16, 30))
        tt = max(2, t // 4)
        items.append({
            "mel": rng.standard_normal((t, 16)).astype(np.float32) - 2,
            "mel2ph": np.repeat(np.arange(1, tt + 1), 4)[:t],
            "f0": rng.uniform(150, 250, t).astype(np.float32),
            "ph_token": rng.integers(1, 20, tt),
            "ep_pitches": rng.integers(40, 80, tt),
            "ep_notedurs": rng.uniform(0.1, 0.6, tt).astype(np.float32),
            "ep_types": np.ones(tt, np.int64),
            "spk_embed": rng.standard_normal(256).astype(np.float32),
            "emo_embed": rng.standard_normal(256).astype(np.float32)})
    ds = StyleSingerDataset(cfg, "train", items=items)
    return collate_batch([ds[i] for i in range(n)], cfg["frame_buckets"],
                         cfg["token_buckets"])


@pytest.mark.cuda
def test_tiny_train_step_on_the_card_matches_cpu(cuda):
    """One train step of the tiny model (RQ, forcing off, mel diffusion):
    the same weights and batch, the same draws (CPU generators, handed over
    on the card), TF32 off.  Every loss and the grad norm within 1e-3
    (relative, atol 1e-3); each gradient leaf within 1e-3 * max|g_leaf| +
    1e-6 * max|g| (the second term: leaves that are zero in exact
    arithmetic carry f32 rounding); the RQ buffers within 1e-5."""
    from stylesinger_torch.models.stylesinger import StyleSinger
    from stylesinger_torch.training import step as ts

    cfg = tiny_test_config()
    batch = _tiny_train_batch(cfg)
    phase = ts.Phase(use_rq=True, forcing=False, use_diff=True)
    cpu = ts.init_state(StyleSinger(cfg, 20), cfg)
    model = StyleSinger(cfg, 20)
    model.load_state_dict(cpu.model.state_dict())
    gpu = ts.TrainState(model.to(cuda), ts.Optimizer(
        dict(model.named_parameters()), cfg))
    m_cpu = ts.train_step(cpu, ts.batch_to_device(batch, "cpu"), phase, cfg,
                          noise={s: Noise(i, "cpu")
                                 for i, s in enumerate(ts.STREAMS)})
    m_gpu = ts.train_step(gpu, ts.batch_to_device(batch, cuda), phase, cfg,
                          noise={s: _CpuDraws(Noise(i, "cpu"), cuda)
                                 for i, s in enumerate(ts.STREAMS)})
    assert set(m_gpu) == set(m_cpu)
    for k, v in m_cpu.items():
        assert abs(m_gpu[k].item() - v.item()) <= 1e-3 * max(1.0,
                                                              abs(v.item()))
    grads = {k: p.grad for k, p in cpu.model.named_parameters()}
    g_max = max(g.abs().max().item() for g in grads.values()
                if g is not None)
    for k, p in gpu.model.named_parameters():
        if grads[k] is None:
            assert p.grad is None or not p.grad.any(), k
            continue
        tol = 1e-3 * grads[k].abs().max().item() + 1e-6 * g_max
        assert (p.grad.cpu() - grads[k]).abs().max().item() <= tol, k
    ref = cpu.model.state_dict()
    for k, v in gpu.model.state_dict().items():
        if ".codebook_" in k:
            assert (v.cpu() - ref[k]).abs().max().item() <= 1e-5, k


def _cpu_step(cfg):
    """One train step of the tiny model on the CPU (seeded weights, batch
    and draws).  Returns the state, the metrics, the batch and the
    phase."""
    from stylesinger_torch.models.stylesinger import StyleSinger
    from stylesinger_torch.training import step as ts

    batch = _tiny_train_batch(cfg)
    phase = ts.Phase(use_rq=True, forcing=False, use_diff=True)
    cpu = ts.init_state(StyleSinger(cfg, 20), cfg)
    first = {k: v.clone() for k, v in cpu.model.state_dict().items()}
    m_cpu = ts.train_step(cpu, ts.batch_to_device(batch, "cpu"), phase, cfg,
                          noise={s: Noise(i, "cpu")
                                 for i, s in enumerate(ts.STREAMS)})
    return cpu, m_cpu, batch, phase, first


def _card_and_cpu_steps(cuda, cfg, setup=None, card_dtypes=None):
    """One train step of the tiny model on the CPU and on the card from the
    same weights, batch and draws (CPU generators); ``setup()`` runs before
    the card's step; ``card_dtypes`` (a dict) receives the output dtypes of
    the card model's compute layers (``precision.compute_layer_dtypes``).
    Returns both states and metrics."""
    import contextlib

    from stylesinger_torch.models import precision
    from stylesinger_torch.models.stylesinger import StyleSinger
    from stylesinger_torch.training import step as ts

    cpu, m_cpu, batch, phase, first = _cpu_step(cfg)
    model = StyleSinger(cfg, 20)
    model.load_state_dict(first)
    gpu = ts.TrainState(model.to(cuda), ts.Optimizer(
        dict(model.named_parameters()), cfg))
    if setup is not None:
        setup()
    record = contextlib.nullcontext({}) if card_dtypes is None else \
        precision.compute_layer_dtypes(gpu.model)
    with record as seen:
        m_gpu = ts.train_step(gpu, ts.batch_to_device(batch, cuda), phase,
                              cfg, noise={s: _CpuDraws(Noise(i, "cpu"), cuda)
                                          for i, s in enumerate(ts.STREAMS)})
    if card_dtypes is not None:
        card_dtypes.update(seen)
    return cpu, gpu, m_cpu, m_gpu


@pytest.mark.cuda
def test_tiny_bf16_train_step_on_the_card_matches_cpu(cuda):
    """``compute_dtype: bfloat16``: the card's step (cuBLAS / cuDNN bf16,
    f32 accumulation) against the CPU's bf16 step.  Both round each op to
    bf16 at the same sites and accumulate in different orders (measured on
    an H100: losses 1.2e-6 apart, gradients 3.1e-4 in relative L2): every
    loss and the grad norm finite and within 1e-4 (relative, atol 1e-4);
    all gradients within 1e-2 in relative L2 and at cosine similarity above
    0.9999.  The card ran in bf16: every compute layer that ran returned
    bf16 (the attention's ``qkv``, the FFN's ``Conv_0``, WaveNet's ``in_0``
    and the style encoder's ``res_0.ln_0`` among them), and its gradient is more than 0.4 % (relative L2)
    from the CPU's f32 step's (1.2 % measured on the CPU); the parameters
    stay f32."""
    cfg = tiny_test_config(compute_dtype="bfloat16")
    seen = {}
    cpu, gpu, m_cpu, m_gpu = _card_and_cpu_steps(cuda, cfg,
                                                 card_dtypes=seen)
    assert set(m_gpu) == set(m_cpu)
    for k, v in m_cpu.items():
        assert math.isfinite(m_gpu[k].item()), k
        assert abs(m_gpu[k].item() - v.item()) <= 1e-4 * max(
            1.0, abs(v.item())), k
    for site in (".qkv", ".Conv_0", ".in_0", ".res_0.ln_0"):
        assert any(name.endswith(site) for name in seen), site
    assert all(d == {torch.bfloat16} for d in seen.values()), seen
    cpu32 = _cpu_step(tiny_test_config(compute_dtype="float32"))[0]
    names = [k for k, p in cpu.model.named_parameters()
             if p.grad is not None]

    def flat(state):
        params = dict(state.model.named_parameters())
        return torch.cat([params[k].grad.reshape(-1).cpu() for k in names])

    gc, gg, g32 = flat(cpu), flat(gpu), flat(cpu32)
    assert torch.nn.functional.cosine_similarity(gc, gg, dim=0) > 0.9999
    assert (gc - gg).norm() <= 1e-2 * gc.norm()
    assert (gg - g32).norm() > 4e-3 * g32.norm()
    assert all(p.dtype == torch.float32 for p in gpu.model.parameters())


@pytest.mark.cuda
def test_world_size_one_nccl_step_equals_the_plain_step(cuda):
    """``init_distributed`` at world size 1 on NCCL: the step takes the
    data-parallel path (padding, the global draws, denominators, RQ gather,
    the gradient all-reduce) and equals the plain step on the CPU as the
    card's plain step does (``test_tiny_train_step_on_the_card_matches_cpu``
    's tolerances)."""
    import os
    import socket

    import torch.distributed as dist

    from stylesinger_torch.parallel import mesh

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="localhost", MASTER_PORT=str(port))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        cfg = tiny_test_config()
        cpu, gpu, m_cpu, m_gpu = _card_and_cpu_steps(
            cuda, cfg, setup=lambda: mesh.init_distributed("cuda"))
        assert dist.is_initialized() and dist.get_backend() == "nccl"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    for k, v in m_cpu.items():
        assert abs(m_gpu[k].item() - v.item()) <= 1e-3 * max(1.0,
                                                              abs(v.item()))
    grads = {k: p.grad for k, p in cpu.model.named_parameters()}
    g_max = max(g.abs().max().item() for g in grads.values()
                if g is not None)
    for k, p in gpu.model.named_parameters():
        ref = torch.zeros_like(p.grad.cpu()) if grads[k] is None \
            else grads[k]
        tol = 1e-3 * ref.abs().max().item() + 1e-6 * g_max
        assert (p.grad.cpu() - ref).abs().max().item() <= tol, k


@pytest.mark.cuda
def test_kernels_refuse_autograd(cuda):
    """Neither kernel has a backward: on a CUDA tensor each wrapper raises
    while autograd records an input or weight that requires grad, and runs
    under no_grad or on tensors that do not."""
    wav = torch.randn(4096, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        melk.mel_spectrogram(wav.clone().requires_grad_(True))
    with torch.no_grad():
        melk.mel_spectrogram(wav.clone().requires_grad_(True))
    melk.mel_spectrogram(wav)
    c, block, t, rk, rd = MRF_CASES["C64"]
    halo = max(ResBlock1.halo(k, d) for k, d in zip(rk, rd))
    xb, mask, _ = _blockify(torch.randn((1, t, c), device=cuda), block, halo)
    weights = [[tuple((torch.randn((k, c, c), device=cuda) / math.sqrt(k * c),
                       torch.zeros((c,), device=cuda)) for _ in range(2))
                for _ in ds] for k, ds in zip(rk, rd)]
    kw = dict(kernels=rk, dilations=rd, block=block, halo=halo)
    with pytest.raises(RuntimeError, match="no backward"):
        mrfk.fused_mrf_blocks(xb.clone().requires_grad_(True), mask, weights,
                              **kw)
    weights[0][0][0][0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        mrfk.fused_mrf_blocks(xb, mask, weights, **kw)
    with torch.no_grad():
        mrfk.fused_mrf_blocks(xb, mask, weights, **kw)


def _gan_config():
    # the vocoder tests' audio; mrf_block 64 blocks the last three stages
    return tiny_test_config(hop_size=64, fft_size=256, win_size=256,
                            fmax=8000, audio_sample_rate=16000, mrf_block=64)


def _gan_batch(device):
    rng = np.random.default_rng(3)
    f0 = rng.uniform(150, 250, (2, 16)).astype(np.float32)
    f0[:, -3:] = 0.0
    return {k: torch.as_tensor(v, device=device) for k, v in {
        "mels": rng.standard_normal((2, 16, 16)).astype(np.float32),
        "f0": f0,
        "wav": 0.3 * rng.standard_normal((2, 1024)).astype(np.float32)}.items()}


@pytest.mark.cuda
def test_disc_step_generator_pass_on_the_kernel_matches_blocks(cuda):
    """The discriminator step's generator pass (no gradient) launches the
    MRF kernel on the three blocked stages; with a gradient recorded the
    same stages run the resblock modules: the same wav within the kernel's
    1e-4 of max|y|."""
    from stylesinger_torch.training import vocoder_task as vt

    state = vt.init_vocoder_state(_gan_config(), device=cuda)
    b = _gan_batch(cuda)
    before = mrfk.counter.count
    with torch.no_grad():
        kernel = state.gen(b["mels"], b["f0"],
                           _CpuDraws(Noise(0, "cpu"), cuda))
    assert mrfk.counter.count == before + 3 * 9
    blocks = state.gen(b["mels"], b["f0"], _CpuDraws(Noise(0, "cpu"), cuda))
    assert mrfk.counter.count == before + 3 * 9 and blocks.requires_grad
    err = (kernel - blocks.detach()).abs().max().item()
    assert err <= 1e-4 * blocks.abs().max().item(), err


@pytest.mark.cuda
def test_tiny_gan_iteration_on_the_card_matches_cpu(cuda):
    """One discriminator + generator iteration on the card against the CPU:
    the same weights, batch and draws (CPU generators, handed over on the
    card), TF32 off.  Every loss within 1e-5 (relative, atol 1e-5); each
    gradient leaf within 2e-3 relative + 2e-4 x max|g_leaf| + 1e-7 x
    max|g|; each parameter within 0.05 x lr where its CPU gradient is
    >= 1e-6 (Adam's first step moves it by about lr)."""
    from stylesinger_torch.training import vocoder_task as vt

    cfg = _gan_config()
    cpu = vt.init_vocoder_state(cfg, device="cpu")
    gpu = vt.init_vocoder_state(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    grads = {}
    for name, st in (("cpu", cpu), ("gpu", gpu)):
        seen = grads[name] = []
        for opt in (st.disc_opt, st.gen_opt):
            def rec(params, g, *rest, _step=opt.step, _seen=seen):
                _seen.append([x.detach().cpu().clone() for x in g])
                _step(params, g, *rest)
            opt.step = rec
    disc_step, gen_step = vt.make_vocoder_bodies(cfg)
    metrics = {}
    for name, st, dev in (("cpu", cpu, "cpu"), ("gpu", gpu, cuda)):
        b = _gan_batch(dev)
        m = disc_step(st, b, _CpuDraws(Noise(5, "cpu"), dev))
        m.update(gen_step(st, b, _CpuDraws(Noise(5, "cpu"), dev)))
        metrics[name] = {k: v.item() for k, v in m.items()}
    for k, v in metrics["cpu"].items():
        assert abs(metrics["gpu"][k] - v) <= 1e-5 * max(1.0, abs(v)), k
    lr = cfg["vocoder_lr"]
    for side, named in ((0, list(cpu.named_disc_params())),
                        (1, [n for n, _ in cpu.gen.named_parameters()])):
        g_cpu, g_gpu = grads["cpu"][side], grads["gpu"][side]
        g_max = max(g.abs().max().item() for g in g_cpu)
        for n, a, b in zip(named, g_cpu, g_gpu):
            tol = 2e-3 * a.abs() + 2e-4 * a.abs().max() + 1e-7 * g_max
            assert ((b - a).abs() <= tol).all(), n
    p_cpu = {**dict(cpu.gen.named_parameters()),
             **cpu.named_disc_params()}
    p_gpu = {**dict(gpu.gen.named_parameters()),
             **gpu.named_disc_params()}
    g_all = dict(zip(list(cpu.named_disc_params()) +
                     [n for n, _ in cpu.gen.named_parameters()],
                     grads["cpu"][0] + grads["cpu"][1]))
    for n, p in p_cpu.items():
        steady = g_all[n].abs() >= 1e-6
        diff = (p_gpu[n].detach().cpu() - p.detach()).abs()
        assert (diff[steady] <= 0.05 * lr).all(), n


def _tiny_serving_files(root):
    """A work dir checkpoint, a ``generator.pt`` and a GE2E file of seeded
    weights at ``tiny_test_config``, and the config naming them."""
    from stylesinger_torch.models.encoders import UtteranceEncoder
    from stylesinger_torch.models.stylesinger import StyleSinger

    cfg = tiny_test_config(hop_size=64, mrf_block=64)
    model = StyleSinger(cfg, 10)
    init_random_(model, torch.Generator().manual_seed(1))
    (root / "ckpt").mkdir()
    torch.save({"model": model.state_dict(), "step": 3},
               root / "ckpt" / "model_ckpt_steps_3.pt")
    gen = HifiGanGenerator(cfg)
    init_random_(gen, torch.Generator().manual_seed(2), conv_std=0.05)
    torch.save(gen.state_dict(), root / "generator.pt")
    enc = UtteranceEncoder()
    init_random_(enc, torch.Generator().manual_seed(3))
    torch.save({"model_state": {k.replace("proj.", "linear."): v
                                for k, v in enc.state_dict().items()}},
               root / "ge2e.pt")
    return cfg.replace(vocoder_ckpt=str(root / "generator.pt"),
                       speaker_encoder_path=str(root / "ge2e.pt"),
                       emotion_encoder_path=str(root / "ge2e.pt"))


@pytest.mark.cuda
def test_load_params_on_the_card_equals_the_cpu_load(cuda, tmp_path):
    """The work dir's checkpoint, the vocoder and the GE2E encoders,
    loaded straight onto the card, are the CPU load bit for bit."""
    from stylesinger_torch.inference import StyleSingerInfer

    cfg = _tiny_serving_files(tmp_path)
    loaded = []
    for device in ("cpu", cuda):
        infer = StyleSingerInfer(cfg, phone_list=list("abcdefg"),
                                 device=device)
        infer.load_params(str(tmp_path))
        loaded.append(infer)
    for a, b in zip(*(m.modules() for m in loaded)):
        sb = b.state_dict()
        assert a.state_dict().keys() == sb.keys()
        for k, v in a.state_dict().items():
            assert sb[k].is_cuda and torch.equal(sb[k].cpu(), v), k


@pytest.mark.cuda
def test_evaluate_pair_on_the_card_matches_cpu(cuda, tmp_path):
    """The card's ``evaluate_pair`` (two mel-kernel launches) against the
    CPU's (the plain twin): the log-mels within the mel tolerance, the MCD
    within what that tolerance allows it, the FFE within one frame."""
    from stylesinger_torch.dsp.mel import load_wav, save_wav, wav2spec
    from stylesinger_torch.eval.evaluate_gen import evaluate_pair

    sr = 48000
    t = np.arange(sr) / sr
    gt = 0.3 * np.sin(2 * np.pi * 220 * t + 2 * np.sin(2 * np.pi * 5 * t))
    pred = 0.3 * np.sin(2 * np.pi * 240 * t) * (t < 0.7)
    save_wav(gt, str(tmp_path / "gt.wav"), sr)
    save_wav(pred, str(tmp_path / "pred.wav"), sr)
    args = (str(tmp_path / "pred.wav"), str(tmp_path / "gt.wav"), sr)
    melk.counter.reset()
    card = evaluate_pair(*args, device=cuda)
    assert melk.counter.count == 2
    cpu = evaluate_pair(*args, device="cpu")
    tol = dict(atol=3e-3, rtol=2e-3)
    worst = 0.0
    for fn in args[:2]:
        wav = load_wav(fn, sr)
        mel_card = wav2spec(wav, cuda)["mel"].cpu()
        mel_cpu = wav2spec(wav, torch.device("cpu"))["mel"]
        assert torch.allclose(mel_card, mel_cpu, **tol)
        worst = max(worst, float(mel_cpu.abs().max()))
    k = 10.0 / math.log(10.0) * math.sqrt(2.0)
    mcd_bound = 2 * k * math.sqrt(80) * (tol["atol"] + tol["rtol"] * worst)
    assert abs(card["mcd"] - cpu["mcd"]) <= mcd_bound
    assert abs(card["ffe"] - cpu["ffe"]) <= 1.0 / (sr // 256)


def _one_item_corpus(root, sr=48000, seconds=2.0):
    """A processed corpus of one harmonic item on four notes, at the
    recipe's audio settings."""
    import json

    from stylesinger_torch.config import load_config
    from stylesinger_torch.dsp.mel import save_wav

    rng = np.random.default_rng(5)
    t = np.arange(int(seconds * sr)) / sr
    notes = np.array([60, 64, 67, 62])
    f0 = 440.0 * 2 ** ((notes[np.minimum((t / seconds * 4).astype(int), 3)]
                        - 69) / 12)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    wav = sum(rng.uniform(0.2, 1) / h * np.sin(h * phase) for h in range(1, 7))
    wav = 0.3 * wav / np.abs(wav).max() + 0.003 * rng.standard_normal(len(t))
    processed = root / "processed"
    processed.mkdir(parents=True)
    save_wav(wav, str(processed / "a.wav"), sr)
    ph = ["n", "i3", "h", "ao3"]
    with open(processed / "metadata.json", "w") as f:
        json.dump([dict(item_name="a", ph=ph, ph_durs=[seconds / 4] * 4,
                        wav_fn=str(processed / "a.wav"), singer="s",
                        ep_pitches=notes.tolist(),
                        ep_notedurs=[seconds / 4] * 4, ep_types=[2] * 4)], f)
    with open(processed / "phone_set.json", "w") as f:
        json.dump(sorted(ph), f)
    return load_config(recipe="stylesinger", processed_data_dir=str(processed))


@pytest.mark.cuda
def test_binarized_item_on_the_card_matches_cpu(cuda, tmp_path):
    """One 2 s item through ``StyleSingingBinarizer`` on the card (one mel
    launch) and on the CPU (the plain twins), with the same seeded GE2E
    weights: tokens, ``mel2ph`` and lengths exactly, the mel within the
    mel tolerance, the F0's voicing on >= 99.5 % of frames and the voiced
    F0 within 1e-3 relative, the d-vectors within 1e-5 although cuDNN's
    TF32 is on (the binarizer runs its LSTMs in f32; with TF32 they move
    by about 1e-4); every field numpy."""
    from stylesinger_torch.data.binarize import StyleSingingBinarizer
    from stylesinger_torch.data.indexed_dataset import IndexedDataset

    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    cfg = _one_item_corpus(tmp_path)
    out = {}
    for name, device in (("cuda", cuda), ("cpu", "cpu")):
        c = dict(cfg, binary_data_dir=str(tmp_path / name))
        melk.counter.reset()
        StyleSingingBinarizer(c, device=device).process()
        assert melk.counter.count == (1 if name == "cuda" else 0)
        out[name] = IndexedDataset(str(tmp_path / name / "train"))[0]
    a, b = out["cuda"], out["cpu"]
    assert sorted(a) == sorted(b)
    for k in a:
        assert not isinstance(a[k], torch.Tensor), k
    for k in ("ph_token", "mel2ph", "len", "wav", "sec"):
        np.testing.assert_array_equal(a[k], b[k])
    assert torch.allclose(torch.as_tensor(a["mel"]), torch.as_tensor(b["mel"]),
                          atol=3e-3, rtol=2e-3)
    assert ((a["f0"] > 0) == (b["f0"] > 0)).mean() >= 0.995
    both = (a["f0"] > 0) & (b["f0"] > 0)
    assert both.mean() > 0.5
    np.testing.assert_allclose(a["f0"][both], b["f0"][both], rtol=1e-3)
    for k in ("spk_embed", "emo_embed"):
        np.testing.assert_allclose(a[k], b[k], atol=1e-5, rtol=0)
    assert torch.backends.cudnn.allow_tf32  # the switch is restored


@pytest.mark.cuda
def test_tsd_batch_reaches_the_card_through_pinned_memory(cuda, tmp_path):
    """``PrefetchBatcher(device=cuda)``: every batch's tensors on the card,
    equal to the numpy batch the C++ reader assembled."""
    from stylesinger_torch.data.native_loader import TsdWriter
    from stylesinger_torch.data.tsd_dataset import (
        PrefetchBatcher, TsdStyleSingerDataset, precompute_item_fields,
        to_device,
    )

    cfg = tiny_test_config(max_tokens=200, max_sentences=4)
    rng = np.random.default_rng(3)
    w = TsdWriter(str(tmp_path / "train"))
    for _ in range(9):
        t, tt = int(rng.integers(10, 60)), int(rng.integers(3, 12))
        w.add_item(precompute_item_fields(dict(
            mel=rng.standard_normal((t, 16)).astype(np.float32),
            mel2ph=np.sort(rng.integers(1, tt + 1, t)),
            f0=(150 + 50 * rng.uniform(size=t)).astype(np.float32),
            ph_token=rng.integers(1, 20, tt), ep_pitches=rng.integers(
                40, 80, tt), ep_notedurs=rng.uniform(0.1, 0.5, tt),
            ep_types=rng.integers(1, 4, tt),
            spk_embed=rng.standard_normal(256).astype(np.float32)), cfg))
    w.finalize()
    ds = TsdStyleSingerDataset(cfg, str(tmp_path / "train"))
    host = list(PrefetchBatcher(ds, cfg, shuffle=False).batches(0))
    card = list(PrefetchBatcher(ds, cfg, shuffle=False,
                                device=cuda).batches(0))
    assert len(host) == len(card) > 1
    for h, c in zip(host, card):
        assert sorted(h) == sorted(c)
        for k, v in c.items():
            assert v.is_cuda, k
            np.testing.assert_array_equal(v.cpu().numpy(), h[k])
    pinned = to_device({"x": np.ones(3, np.float32)}, "cpu")["x"]
    assert not pinned.is_cuda


class _Draws:
    """Dropout drawn on a CPU generator, recorded; replayed on the card."""

    def __init__(self, seed=0, draws=None, device="cpu"):
        self.g = torch.Generator().manual_seed(seed)
        self.draws = [] if draws is None else list(draws)
        self.replay = draws is not None
        self.device = device

    def bernoulli(self, p, shape=()):
        if self.replay:
            return self.draws.pop(0).to(self.device)
        a = torch.rand(tuple(shape), generator=self.g) < p
        self.draws.append(a)
        return a.clone()


def _family_batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    m = cfg["audio_num_mel_bins"]
    mel2ph = np.repeat(np.arange(1, 9), 4)[None].repeat(2, 0)
    mel2ph[1, -4:] = 0
    txt = rng.integers(1, 20, (2, 8))
    txt[1, -1] = 0
    frame = (mel2ph > 0).astype(np.float32)
    b = dict(txt_tokens=txt, mel2ph=mel2ph,
             spk_embed=rng.standard_normal((2, 256)).astype(np.float32),
             f0=rng.uniform(7, 8.5, (2, 32)).astype(np.float32),
             uv=(rng.uniform(size=(2, 32)) < 0.3) * frame,
             energy=rng.uniform(0, 3.99, (2, 32)).astype(np.float32),
             mels=(rng.standard_normal((2, 32, m)) * frame[..., None]))
    return {k: torch.as_tensor(v).float() if np.asarray(v).dtype.kind == "f"
            else torch.as_tensor(v) for k, v in b.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["fs2_frame_energy", "fs2_cwt", "pe"])
def test_fs2_and_pe_train_steps_on_the_card_match_cpu(cuda, family):
    """One step of FastSpeech2 / the PitchExtractor from the same weights,
    batch and dropout: every loss within 1e-4 (relative, atol 1e-4), each
    gradient leaf within 1e-3 * max|g_leaf| + 1e-6 * max|g|; no kernel."""
    from stylesinger_torch.models.fs2 import FastSpeech2
    from stylesinger_torch.models.pe import PitchExtractor
    from stylesinger_torch.training import fs2_task
    from stylesinger_torch.training.step import Optimizer, TrainState

    if family == "pe":
        cfg = tiny_test_config()
        build, make = (lambda: PitchExtractor(cfg)), \
            fs2_task.make_pe_train_step
    else:
        cfg = tiny_test_config(
            pitch_type=family.split("_")[1],
            use_energy_embed=family.endswith("energy"))
        build, make = (lambda: FastSpeech2(cfg, 20, out_dims=16)), \
            fs2_task.make_fs2_train_step
    batch = _family_batch(cfg)
    cpu = fs2_task.init_fs2_state(build(), cfg, seed=1)
    first = {k: v.clone() for k, v in cpu.model.state_dict().items()}
    rec = _Draws(2)
    m_cpu = make(cfg)(cpu, batch, drop=rec)
    model = build()
    model.load_state_dict(first)
    gpu = TrainState(model.to(cuda), Optimizer(
        dict(model.named_parameters()), cfg))
    melk.counter.reset()
    mrfk.counter.reset()
    m_gpu = make(cfg)(gpu, {k: v.to(cuda) for k, v in batch.items()},
                      drop=_Draws(draws=rec.draws, device=cuda))
    assert melk.counter.count == mrfk.counter.count == 0
    for k, v in m_cpu.items():
        assert abs(m_gpu[k].item() - v.item()) <= 1e-4 * max(
            1.0, abs(v.item())), k
    grads = {k: p.grad for k, p in cpu.model.named_parameters()}
    g_max = max(float(g.abs().max()) for g in grads.values()
                if g is not None)
    for name, p in gpu.model.named_parameters():
        ref = grads[name]
        if ref is None:
            assert p.grad is None or not p.grad.any(), name
            continue
        err = float((p.grad.cpu() - ref).abs().max())
        assert err <= 1e-3 * float(ref.abs().max()) + 1e-6 * g_max, name


@pytest.mark.cuda
def test_legacy_vocoders_and_denoisers_on_the_card_match_cpu(cuda):
    """PWG (with and without its pitch embedding), MelGAN, PQMF analysis
    and synthesis, F0DiffNet and MDiffNet: the same weights, inputs and
    noise on the card and the CPU, within 1e-4 of max(1, max|y|)."""
    from stylesinger_torch.models import legacy_vocoders as lv
    from stylesinger_torch.models.diffnet import F0DiffNet, MDiffNet

    cfg = tiny_test_config(pwg_upsample_scales=[4, 4],
                           melgan_upsample_scales=[4, 2])
    g = torch.Generator().manual_seed(3)
    mel = torch.randn((2, 12, 16), generator=g)
    noise = torch.randn((2, 192, 1), generator=g)
    pitch = torch.randint(1, 256, (2, 12), generator=g)
    t = 24
    cond = torch.randn((2, t, 12), generator=g)
    mask = torch.ones((2, t))
    mask[1, -6:] = 0
    steps = torch.tensor([3, 71])
    pwg_kw = dict(layers=6, stacks=3, residual_channels=8, gate_channels=16,
                  skip_channels=8)
    cases = [
        (lambda: lv.ParallelWaveGANGenerator(cfg, **pwg_kw), (mel, noise)),
        (lambda: lv.ParallelWaveGANGenerator(cfg, use_pitch_embed=True,
                                             **pwg_kw), (mel, noise, pitch)),
        (lambda: lv.MelGANGenerator(cfg, base_channels=32), (mel,)),
        (lambda: F0DiffNet(cond_dim=12, residual_layers=3,
                           residual_channels=8),
         (torch.randn((2, t, 1), generator=g), steps, cond, mask)),
        (lambda: MDiffNet(cond_dim=12, residual_layers=3,
                          residual_channels=8),
         (torch.randint(0, 2, (2, t), generator=g), steps, cond, mask))]
    for build, args in cases:
        cpu = build()
        init_random_(cpu, torch.Generator().manual_seed(4), conv_std=0.1)
        card = build()
        card.load_state_dict(cpu.state_dict())
        with torch.no_grad():
            ref = cpu(*args)
            out = card.to(cuda)(*(a.to(cuda) for a in args)).cpu()
        assert (out - ref).abs().max() <= 1e-4 * max(1.0, ref.abs().max())
    wav = torch.randn((2, 4000), generator=g)
    pq, pq_card = lv.PQMF(), lv.PQMF().to(cuda)
    for ref, out in ((pq.analysis(wav), pq_card.analysis(wav.to(cuda))),
                     (pq.synthesis(pq.analysis(wav)),
                      pq_card.synthesis(pq_card.analysis(wav.to(cuda))))):
        assert (out.cpu() - ref).abs().max() <= 1e-4 * max(
            1.0, ref.abs().max())


@pytest.fixture
def deterministic():
    """PyTorch's deterministic algorithms for one test (warnings only where
    an op has none), then the mode as it was."""
    import warnings

    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield
    torch.use_deterministic_algorithms(before[0], warn_only=before[1])


def _unequal(got: dict, want: dict) -> list:
    return [k for k, v in want.items() if not torch.equal(got[k], v)]


@pytest.mark.cuda
def test_graphed_train_steps_equal_eager_steps(cuda, deterministic, tmp_path):
    """``make_train_scan`` on the card (a CUDA graph per curriculum phase,
    the first step of each eager, the next a replay) against eager
    ``train_step`` calls: the same seeded weights, padded epoch of two
    batches of different shapes, order and draws, TF32 off, 4 steps across
    the forcing boundary.  Every loss, the grad norm, each parameter and
    each RQ buffer equal bit for bit, with PyTorch's deterministic
    algorithms (without them the atomic adds of the gathers' backward
    leave, in two eager runs alike, differences Adam lifts to a share of
    lr where a gradient is 0 in exact arithmetic)."""
    from stylesinger_torch.models.stylesinger import StyleSinger
    from stylesinger_torch.training import step as ts
    from stylesinger_torch.training.trainer import Trainer

    # RQ and the mel diffusion from step 0, forcing off from step 2
    cfg = tiny_test_config(forcing=2, rq_start=-1, diff_start=-1,
                           steps_per_dispatch=2)
    one, two = _tiny_train_batch(cfg), _tiny_train_batch(cfg, seed=1, n=2)
    trainer = Trainer(StyleSinger(cfg, 20), cfg, str(tmp_path), device=cuda)
    stacked, n_b = trainer._stack_batches([one, two])
    graphed = ts.init_state(StyleSinger(cfg, 20).to(cuda), cfg)
    model = StyleSinger(cfg, 20).to(cuda)
    model.load_state_dict(graphed.model.state_dict())
    eager = ts.TrainState(model, ts.Optimizer(dict(model.named_parameters()),
                                              cfg))
    order = [1, 0, 0, 1]
    scan = ts.make_train_scan(cfg)
    got = []
    for lo in (0, 2):
        m = scan(graphed, stacked, order[lo:lo + 2],
                 ts.phase_for_step(lo, cfg))
        got += [{k: v[j] for k, v in m.items()} for j in range(2)]
    assert len(scan.graphs.capture_seconds) == 2
    for t, j in enumerate(order):
        m = ts.train_step(eager, {k: v[j] for k, v in stacked.items()},
                          ts.phase_for_step(t, cfg), cfg)
        assert set(m) == set(got[t]), t
        assert not _unequal(got[t], m), (t, _unequal(got[t], m))
    assert graphed.step == eager.step == 4
    assert graphed.opt.count == eager.opt.count == 4
    bad = _unequal(graphed.model.state_dict(), eager.model.state_dict())
    assert not bad, bad


@pytest.mark.cuda
def test_graphed_gan_iterations_equal_eager_ones(cuda, deterministic):
    """``make_vocoder_scan`` on the card (one CUDA graph: the crops, the
    discriminator step, whose generator pass launches the MRF kernel
    inside the graph, and the generator step; the first iteration eager)
    against the same 3 iterations run eagerly: the same seeded state,
    corpus and draws, TF32 off, PyTorch's deterministic algorithms; every
    loss and each parameter equal bit for bit.  The wrapper counts 27
    launches in the eager iteration and 27 in the capture, which records
    them into the graph; a replay runs them without the wrapper, and
    torch.profiler sees 27 MRF kernels in each of 2 more replays."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stylesinger_torch.training import vocoder_task as vt

    cfg = _gan_config()
    rng = np.random.default_rng(4)
    items = [{"mel": rng.standard_normal((t, 16)).astype(np.float32),
              "f0": rng.uniform(150, 250, t).astype(np.float32),
              "wav": 0.3 * rng.standard_normal(t * 64).astype(np.float32)}
             for t in (20, 28)]
    data = vt.corpus_to_device(vt.stack_corpus(items, cfg, 28), cuda)
    graphed = vt.init_vocoder_state(cfg, device=cuda)
    eager = vt.init_vocoder_state(cfg, device=cuda)
    scan = vt.make_vocoder_scan(cfg)
    before = mrfk.counter.count
    m = scan(graphed, data, 7, 3, 16, 2)
    assert mrfk.counter.count == before + 2 * 27
    assert len(scan.graphs.capture_seconds) == 1
    disc_body, gen_body = vt.make_vocoder_bodies(cfg)
    for n in range(3):
        b = vt.device_crops(data, vt.vocoder_noise(7, n, cuda, "crop"), 16,
                            2, cfg["hop_size"])
        want = disc_body(eager, b, vt.vocoder_noise(7, n, cuda, "noise"))
        want.update(gen_body(eager, b, vt.vocoder_noise(7, n, cuda,
                                                        "noise")))
        assert set(want) == set(m)
        got = {k: v[n] for k, v in m.items()}
        assert not _unequal(got, want), (n, _unequal(got, want))
    assert graphed.step == eager.step == 3
    assert mrfk.counter.count == before + 5 * 27
    named = lambda st: {**dict(st.gen.named_parameters()),  # noqa: E731
                        **st.named_disc_params()}
    bad = _unequal(named(graphed), named(eager))
    assert not bad, bad
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        scan(graphed, data, 7, 2, 16, 2)
        torch.cuda.synchronize()
    assert mrfk.counter.count == before + 5 * 27
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    assert sum("mrf_step_kernel" in k for k in kernels) == 2 * 27


@pytest.mark.cuda
def test_graph_captures_share_one_stream(cuda):
    """Four ``GraphedSteps``, each bound to a state of its own, capture a
    matmul step and replay it; the memory allocated after the last three
    equals that after the first.  Every capture on a device runs on one
    side stream: PyTorch keeps the cuBLAS workspaces of each stream that
    ran a matmul for the life of the process, so a stream per capture
    would leave them allocated after each fit."""
    import gc
    import types

    from stylesinger_torch.training.graphs import GraphedSteps

    def bound_run():
        state = types.SimpleNamespace(device=cuda, step=0)
        w = torch.randn(256, 256, device=cuda, requires_grad=True)
        x = torch.randn(8, 256, device=cuda)
        graphs = GraphedSteps(lambda st: ((st, "step"),))
        graphs.bind(state, x)

        def fn(noise):
            loss = (x @ w).square().mean()
            loss.backward()
            state.step += 1
            return loss.detach()

        for _ in range(3):
            graphs.run("step", fn, {})
        torch.cuda.synchronize()
        assert state.step == 3 and list(graphs.capture_seconds) == ["step"]

    bound_run()
    gc.collect()
    before = torch.cuda.memory_allocated()
    for _ in range(3):
        bound_run()
    gc.collect()
    assert torch.cuda.memory_allocated() == before


def _tiny_synth(device, seed=0, **overrides):
    """A tiny bf16-vocoder synthesizer exported on ``device`` (mrf_block 64:
    its stages of 128 samples and more take the MRF operator), with its
    weights, batch and seeded draws."""
    from stylesinger_torch.serving.export import (
        _init_variables, export_synthesizer, noise_from_seed,
    )

    cfg = tiny_test_config(hop_size=64, mrf_block=64, max_frames=32,
                           f0_speedup=2, dpm_steps=2,
                           vocoder_compute_dtype="bfloat16", **overrides)
    params, voc, batch = _init_variables(cfg, 12, 1, 6, 24, device, seed)
    ep = export_synthesizer(cfg, 12, batch=1, t_txt=6, t_ref=24,
                            max_frames=32, device=device, variables=params,
                            voc_variables=voc)
    return cfg, ep, params, voc, batch, noise_from_seed(ep, 7)


@pytest.mark.cuda
def test_exported_synthesizer_on_the_card_launches_the_kernel(cuda,
                                                               tmp_path):
    """Export on cuda, save, load, call: equal to the live function on the
    same draws (TF32 off), the MRF operator in the graph, and 9 bf16
    launches per kernel stage, counted by the operator's CUDA
    implementation."""
    from stylesinger_torch.serving import (
        load_synthesizer, make_synthesize_fn, save_synthesizer, synthesize,
    )

    cfg, ep, params, voc, batch, noise = _tiny_synth(cuda)
    ops = [n for n in ep.graph.nodes if n.op == "call_function" and
           n.target == torch.ops.stylesinger.fused_mrf_blocks.default]
    assert len(ops) == 4
    loaded = load_synthesizer(save_synthesizer(ep, str(tmp_path / "s.pt2")))
    mrfk.counter_bf16.reset()
    out = synthesize(loaded, params, voc, batch, noise)
    torch.cuda.synchronize()
    assert mrfk.counter_bf16.count == 9 * len(ops)
    with torch.no_grad():
        live = make_synthesize_fn(cfg, 12, 32)(params, voc, batch, noise)
    for a, b in zip(out[:3], live[:3]):
        assert a.device.type == "cuda"
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)
    assert torch.equal(out[3], live[3])


@pytest.mark.cuda
def test_exported_synthesizer_launches_the_diffnet_operator(cuda):
    """At 64 residual channels (widths the kernel takes) the artifact
    exported on cuda holds one ``stylesinger::diffnet_layer`` node per
    residual layer call, and a call launches each once; it equals the live
    function, which runs the same kernel."""
    from stylesinger_torch.serving import make_synthesize_fn, synthesize

    wide = dict(residual_channels=64, f0_residual_channels=64)
    cfg, ep, params, voc, batch, noise = _tiny_synth(cuda, **wide)
    ops = [n for n in ep.graph.nodes if n.op == "call_function" and
           n.target == torch.ops.stylesinger.diffnet_layer.default]
    assert len(ops) > 0
    dk.counter.reset()
    out = synthesize(ep, params, voc, batch, noise)
    torch.cuda.synchronize()
    assert dk.counter.count == len(ops)
    with torch.no_grad():
        live = make_synthesize_fn(cfg, 12, 32)(params, voc, batch, noise)
    for a, b in zip(out[:3], live[:3]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_exported_synthesizer_on_the_card_matches_the_cpu_artifact(cuda):
    """The same weights, batch and draws through a cuda and a cpu artifact:
    the card's kernel against the CPU's plain twin (bf16: 1e-2 on the
    wav, whose convs round to bf16 in another order), mel2ph equal."""
    from stylesinger_torch.serving import synthesize

    _, ep_gpu, params, voc, batch, noise = _tiny_synth(cuda)
    _, ep_cpu, *_ = _tiny_synth("cpu")

    def cpu(tree):
        return {k: v.cpu() for k, v in tree.items()}

    g = synthesize(ep_gpu, params, voc, batch, noise)
    c = synthesize(ep_cpu, cpu(params), cpu(voc), cpu(batch),
                   tuple(t.cpu() for t in noise))
    torch.testing.assert_close(g[1].cpu(), c[1], atol=1e-3, rtol=0)
    torch.testing.assert_close(g[2].cpu(), c[2], atol=1e-3, rtol=0)
    torch.testing.assert_close(g[0].cpu(), c[0], atol=1e-2, rtol=0)
    assert torch.equal(g[3].cpu(), c[3])


# ------------------------------------------------ spans and counters

@pytest.fixture
def fresh_registry():
    from stylesinger_torch.utils import profiling

    profiling.reset()
    yield profiling
    profiling.reset()


def _bf16_mrf_step(cuda, c=64, t=300, seed=0):
    """A step function that launches the bf16 MRF kernel: (fn, launches
    per call)."""
    rk, rd = (3, 5), ((1, 2), (1, 3))
    halo = max(ResBlock1.halo(k, d) for k, d in zip(rk, rd))
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((2, t, c), generator=gen, device=cuda)
    xb, mask, _ = _blockify(x.to(torch.bfloat16), 64, halo)
    weights = [[tuple((torch.randn((k, c, c), generator=gen, device=cuda)
                       / math.sqrt(k * c),
                       0.1 * torch.randn((c,), generator=gen, device=cuda))
                      for _ in range(2)) for _ in ds]
               for k, ds in zip(rk, rd)]

    @torch.no_grad()
    def fn(noise):
        return mrfk.fused_mrf_blocks(xb, mask, weights, kernels=rk,
                                     dilations=rd, block=64, halo=halo,
                                     compute_dtype=torch.bfloat16)
    return fn, sum(len(d) for d in rd)


@pytest.mark.cuda
def test_graph_replays_report_the_launches_their_capture_recorded(
        cuda, fresh_registry):
    """``GraphedSteps``: the eager first run and the capture each count
    the step's launches, and W replays move the wrapper's counter no
    further; the registry's ``graphs`` entry reports the capture's
    launches and W x them as the replays'."""
    import types

    from stylesinger_torch.training.graphs import GraphedSteps

    fn, per_call = _bf16_mrf_step(cuda)
    state = types.SimpleNamespace(device=cuda)
    graphs = GraphedSteps(lambda st: ())
    graphs.bind(state, fn)
    before = mrfk.counter_bf16.count
    graphs.run("step", fn, {})
    assert list(graphs.capture_seconds) == ["step"]
    assert mrfk.counter_bf16.count == before + 2 * per_call
    w = 4
    for _ in range(w):
        graphs.run("step", fn, {})
    torch.cuda.synchronize()
    assert mrfk.counter_bf16.count == before + 2 * per_call
    reg = fresh_registry.registry()
    step = reg["graphs"]["step"]
    assert step["replays"] == w
    assert step["counts"] == {"kernel.mrf_bf16": per_call}
    assert step["replayed"] == {"kernel.mrf_bf16": w * per_call}
    assert reg["counters"]["kernel.mrf_bf16"] == mrfk.counter_bf16.count


@pytest.mark.cuda
def test_spans_on_the_card_carry_device_seconds(cuda, fresh_registry):
    """Spans on CUDA record a pair of timing events: device seconds
    resolve when the registry is read, and a span whose work the host
    waits for has host seconds at least its device seconds."""
    profiling = fresh_registry
    a = torch.randn(2048, 2048, device=cuda)
    torch.cuda.synchronize()
    with profiling.spans():
        with profiling.span("matmuls", n=8):
            for _ in range(8):
                a = (a @ a).clamp_(-1, 1)
        torch.cuda.synchronize()
        with profiling.span("copy"):
            a.cpu()
    s = profiling.registry()["spans"]
    assert s["matmuls"]["calls"] == 1 and s["matmuls"]["n"] == 8
    assert s["matmuls"]["device_s"] > 0 and s["copy"]["device_s"] > 0
    assert s["copy"]["host_s"] >= s["copy"]["device_s"] * 0.5


@pytest.mark.cuda
def test_captured_train_step_spans_resolve_after_a_replay(cuda, tmp_path,
                                                          fresh_registry):
    """``make_train_scan`` on the tiny model: the capture records
    ``train.forward`` / ``backward`` / ``optimizer`` as external events in
    the graph; after a replay each reads > 0 device seconds, and their sum
    is below the replay's wall time."""
    import time

    from stylesinger_torch.models.stylesinger import StyleSinger
    from stylesinger_torch.training import step as ts
    from stylesinger_torch.training.trainer import Trainer

    profiling = fresh_registry
    cfg = tiny_test_config(forcing=0, rq_start=-1, diff_start=-1,
                           steps_per_dispatch=2)
    trainer = Trainer(StyleSinger(cfg, 20), cfg, str(tmp_path), device=cuda)
    stacked, _ = trainer._stack_batches([_tiny_train_batch(cfg)])
    state = ts.init_state(StyleSinger(cfg, 20).to(cuda), cfg)
    scan = ts.make_train_scan(cfg)
    phase = ts.phase_for_step(0, cfg)
    scan(state, stacked, [0], phase)           # eager, then the capture
    profiling.reset()
    torch.cuda.synchronize()
    t = time.perf_counter()
    scan(state, stacked, [0], phase)           # one replay
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    graphs = profiling.registry()["graphs"]
    assert len(graphs) == 1
    (g,) = graphs.values()
    assert g["replays"] == 1
    split = [g["spans"][k] for k in ("train.forward", "train.backward",
                                      "train.optimizer")]
    assert all(v is not None and v > 0 for v in split), split
    assert sum(split) < wall
