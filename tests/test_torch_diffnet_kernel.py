"""The denoisers' residual-layer kernel (``kernels/diffnet.py``) on the CPU:
its plain twin against the module path, the 3xTF32 split it computes in,
the weight image it reads, and the rule by which ``_Stack.run`` routes a
layer to it.  ``tests/test_torch_cuda.py`` holds the kernel against the
twin on the card.  Small shapes: every case takes milliseconds."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from stylesinger_torch.inference import init_random_
from stylesinger_torch.kernels import diffnet as layerk
from stylesinger_torch.models import precision
from stylesinger_torch.models.diffnet import (
    DiffNet, ResidualBlock, cond_cache,
)

COND = 32


def _block(c, d, seed):
    blk = ResidualBlock(c, COND, d)
    init_random_(blk, torch.Generator().manual_seed(seed))
    with torch.no_grad():  # biases too: the kernel folds and adds them
        for name, p in blk.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=torch.Generator()
                                          .manual_seed(seed + len(name))))
    return blk


def _inputs(c, t, seed, b=2):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, t, c, generator=g),
            torch.randn(b, t, COND, generator=g),
            torch.randn(b, c, generator=g))


def _twin_layer(blk, x, cond, emb, skips, first, conv=F.conv1d):
    cp = layerk.cond_projection(cond, blk.conditioner_projection.weight,
                                blk.conditioner_projection.bias,
                                blk.dilated_conv.bias)
    return layerk.layer_plain(
        x, blk.diffusion_projection(emb), cp, blk.dilated_conv.weight,
        blk.output_projection.weight, blk.output_projection.bias, skips,
        dilation=blk.dilated_conv.dilation, first=first, conv=conv)


@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("c", [64, 192, 256])
def test_twin_equals_the_module_layer_and_skip_sum(c, d):
    """Two layers through the registered operator (CPU: the twin; the
    first writes the skip sum, the second adds to it) against
    ``ResidualBlock.forward`` and ``_Stack.run``'s sum, at two lengths
    whose item ends fall inside a 128-row tile."""
    blocks = [_block(c, d, 10 * c + d), _block(c, 2 if d == 1 else 1, c)]
    for t in (150, 77):
        x0, cond, emb = _inputs(c, t, c + d + t)
        with torch.no_grad():
            x, skips = x0, 0.0
            for blk in blocks:
                x, skip = blk(x, cond, emb)
                skips = skips + skip
            y, acc = x0, torch.empty_like(x0)
            for i, blk in enumerate(blocks):
                cp = layerk.cond_projection(
                    cond, blk.conditioner_projection.weight,
                    blk.conditioner_projection.bias, blk.dilated_conv.bias)
                y = layerk.diffnet_layer(
                    y, blk.diffusion_projection(emb), cp,
                    blk.dilated_conv.weight, blk.output_projection.weight,
                    blk.output_projection.bias, acc,
                    dilation=blk.dilated_conv.dilation, first=i == 0)
        torch.testing.assert_close(y, x, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(acc, skips, rtol=1e-5, atol=1e-5)


def _tf32(a):
    """Truncate to TF32: clear the low 13 of f32's 23 mantissa bits."""
    return (a.contiguous().view(torch.int32) & -8192).view(torch.float32)


def _conv_3xtf32(a, w, **kw):
    a_hi, w_hi = _tf32(a), _tf32(w)
    a_lo, w_lo = _tf32(a - a_hi), _tf32(w - w_hi)
    return (F.conv1d(a_lo, w_hi, **kw) + F.conv1d(a_hi, w_lo, **kw)
            + F.conv1d(a_hi, w_hi, **kw))


def _conv_tf32(a, w, **kw):
    return F.conv1d(_tf32(a), _tf32(w), **kw)


def test_3xtf32_split_meets_1e5_where_one_tf32_term_does_not(
        record_property):
    """Why the kernel splits each operand into two TF32 halves: with both
    products rounded as the tensor cores round them, three terms (lo*hi +
    hi*lo + hi*hi) give the layer's output and skip within 1e-5 of the f32
    twin's scale; one TF32 product does not.  The mel layer's width."""
    c, d, t = 256, 4, 200
    blk = _block(c, d, 7)
    x, cond, emb = _inputs(c, t, 8)
    with torch.no_grad():
        want_s = torch.empty_like(x)
        want = _twin_layer(blk, x, cond, emb, want_s, True)
        errs = {}
        for name, conv in (("3xtf32", _conv_3xtf32), ("tf32", _conv_tf32)):
            s = torch.empty_like(x)
            y = _twin_layer(blk, x, cond, emb, s, True, conv=conv)
            errs[name] = max(float((y - want).abs().max() /
                                   want.abs().max()),
                             float((s - want_s).abs().max() /
                                   want_s.abs().max()))
            record_property(f"rel_err_{name}", errs[name])
    assert errs["3xtf32"] <= 1e-5, errs
    assert errs["tf32"] > 1e-5, errs


@pytest.mark.parametrize("c", [64, 192])
def test_layout_is_the_split_weight_in_core_matrix_order(c):
    """The stream the kernel copies into shared memory, 16 KB a chunk: per
    conv pass j the gate columns [64 j, 64 j + 64) and the filter columns
    C above them over K = (tap, input channel), then per output pass the
    residual and skip columns over K = C; per 16 rows of K the TF32 halves,
    (row k, column n) at ((n // 8) * 4 + k // 4) * 32 + (n % 8) * 4 +
    k % 4."""
    g = torch.Generator().manual_seed(c)
    w_dil = torch.randn(2 * c, c, 3, generator=g)
    w_out = torch.randn(2 * c, c, 1, generator=g)
    laid = layerk.layout(w_dil, w_out)
    nc = c // 64
    assert laid.shape == (nc * (3 * c + c) * 128 * 2,)
    assert int((laid.view(torch.int32) & 0x1FFF).abs().max()) == 0
    chunks = laid.view(-1, 2, 16 * 128)
    image = (chunks[:, 0] + chunks[:, 1]).numpy()
    k, n = np.meshgrid(np.arange(16), np.arange(128), indexing="ij")
    pos = ((n // 8) * 4 + k // 4) * 32 + (n % 8) * 4 + k % 4
    col = np.where(n < 64, n, c + n - 64)
    dil = w_dil.permute(2, 1, 0).reshape(3 * c, 2 * c).numpy()
    out = w_out[:, :, 0].t().numpy()
    q = 0
    for rows in (dil, out):
        for j in range(nc):
            for k0 in range(0, rows.shape[0], 16):
                want = rows[k0 + k, 64 * j + col]
                np.testing.assert_allclose(image[q][pos], want,
                                           rtol=2 ** -20, atol=0)
                q += 1
    assert q == len(chunks)


@pytest.mark.parametrize("shape,takes", [
    ((256, 3, 8), True), ((192, 3, 1), True), ((64, 3, 4), True),
    ((128, 3, 2), True), ((16, 3, 1), False), ((96, 3, 1), False),
    ((320, 3, 1), False), ((256, 3, 16), False), ((256, 5, 1), False)])
def test_takes_layer_is_the_kernels_shapes(shape, takes):
    assert layerk.takes_layer(*shape) is takes


def test_cpu_tensors_do_not_engage_the_kernel():
    """On the CPU the routing rule keeps the module path, whatever the
    rest of the call allows: the kernel runs on CUDA tensors only."""
    x = torch.zeros(2, 8, 64)
    with torch.no_grad():
        assert layerk.inference_f32([x])
        assert not layerk.engages([x])


@pytest.fixture
def routed(monkeypatch):
    """The kernel's route taken on the CPU too (the routing rule without
    its CUDA test, so the operator runs the plain twin), with a count of
    the layers and the conditioner projections that took it."""
    calls = {"layer": 0, "cp": 0}
    layer, proj = layerk.diffnet_layer, layerk.cond_projection

    def count_layer(*a, **k):
        calls["layer"] += 1
        return layer(*a, **k)

    def count_proj(*a, **k):
        calls["cp"] += 1
        return proj(*a, **k)

    monkeypatch.setattr(layerk, "engages", layerk.inference_f32)
    monkeypatch.setattr(layerk, "diffnet_layer", count_layer)
    monkeypatch.setattr(layerk, "cond_projection", count_proj)
    return calls


def _net(c=64, layers=4):
    net = DiffNet(in_dims=8, cond_dim=COND, residual_layers=layers,
                  residual_channels=c, dilation_cycle_length=4)
    init_random_(net, torch.Generator().manual_seed(3))
    return net


def _net_inputs(t=90):
    g = torch.Generator().manual_seed(4)
    return (torch.randn(2, t, 8, generator=g), torch.tensor([3.0, 40.0]),
            torch.randn(2, t, COND, generator=g))


def test_routed_stack_equals_the_module_stack(routed):
    """Under no_grad every layer of a 64-channel stack takes the route and
    the stack's output equals the module path's; inside ``cond_cache`` two
    calls on one ``cond`` project it once per layer."""
    net, (spec, t, cond) = _net(), _net_inputs()
    with torch.no_grad():
        with torch.enable_grad():  # the module path: autograd records
            want = net(spec, t, cond)
        assert routed["layer"] == 0
        got = net(spec, t, cond)
        assert routed == {"layer": 4, "cp": 4}
        with cond_cache():
            net(spec, t, cond)
            again = net(spec, t, cond)
        assert routed == {"layer": 12, "cp": 8}
    torch.testing.assert_close(got, want.detach(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(again, got, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["grad", "input_requires_grad", "bf16",
                                  "narrow"])
def test_module_path_where_the_kernel_does_not_engage(routed, case):
    """Autograd recording the weights (training), an input that requires
    grad under autograd, a ``bfloat16`` activation context, or a width the
    kernel does not take: every layer runs the module code."""
    net, (spec, t, cond) = _net(16 if case == "narrow" else 64), _net_inputs()
    if case == "grad":
        net(spec, t, cond)
    elif case == "input_requires_grad":
        for p in net.parameters():
            p.requires_grad_(False)
        net(spec, t, cond.requires_grad_())
    elif case == "bf16":
        with torch.no_grad(), precision.activation_dtype("bfloat16"):
            net(spec, t, cond)
    else:
        with torch.no_grad():
            net(spec, t, cond)
    assert routed == {"layer": 0, "cp": 0}
    assert layerk.counter.count == 0
