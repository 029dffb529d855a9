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

from stylesinger_torch.kernels import mel as melk
from stylesinger_torch.kernels import mrf as mrfk
from stylesinger_torch.models.hifigan import ResBlock1, _blockify

MEL_CASES = {
    "48k": (48000, dict()),
    # 189 frames: not a multiple of the kernel's 4 frames per block, and
    # the last FFT carries one real frame and an empty partner
    "48k_ragged": (48256, dict()),
    "24k": (2048, dict(sample_rate=24000, n_fft=512, hop_size=128,
                       win_length=512, n_mels=40, fmax=12000.0)),
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
                             kw.get("n_fft", 1024), kw.get("win_length", 1024),
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
