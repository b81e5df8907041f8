"""The port's CUDA kernels (forward and backward) against their plain torch
versions, on the card.

These need an NVIDIA GPU and nvcc (marker ``gpu``); without a card each test
skips. They import torch and the port only, so they also run on a machine
without JAX: ``python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py``.
Shapes are small and odd on purpose (ragged blocks, non-cubic kernels,
unaligned planes); ``chip_smoke.py`` checks the predict path's own shapes.

Tolerances, relative to the plain output's max |y|: float32 (TF32 off in the
plain conv) 1e-4 — f32 sums in another order; bfloat16 2e-2 — the two sides
round the f32 result to bf16 at different points (about 2^-8 relative). The
bfloat16 convs run on the tensor-core route (``conv_plan``), float32 on the
CUDA-core one; ``BF16_ROUTE_CASES`` hit each route and ragged edge. The
skeleton kernel is bit-exact: min and max are exact and every other op is
rounded once on both sides.
"""

import numpy as np
import pytest
import torch

from vangan_torch.ops import conv3d as conv_ops
from vangan_torch.ops import instnorm as in_ops
from vangan_torch.ops import morphology
from vangan_torch.ops import skeleton as skel_ops
from vangan_torch.ops.conv3d import conv3d, conv3d_plain, norm_padding, norm_stride

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,stride,padding,pad_mode,ci,co,bias,dims", [
    ((3, 3, 3), 1, ((1, 1),) * 3, "reflect", 5, 7, True, (9, 10, 11)),
    ((3, 3, 3), 2, ((1, 1),) * 3, "reflect", 16, 32, False, (12, 9, 13)),
    ((4, 4, 4), 2, ((1, 1),) * 3, "zeros", 1, 20, False, (10, 12, 9)),
    ((1, 1, 1), 1, "same", "zeros", 48, 16, False, (8, 8, 8)),
    ((1, 1, 1), 2, "same", "zeros", 16, 32, False, (9, 8, 7)),
    ((1, 1, 1), 1, "same", "zeros", 16, 1, True, (6, 7, 8)),
    ((3, 3, 3), 2, "same", "zeros", 6, 5, True, (9, 7, 11)),
    ((3, 1, 2), (1, 2, 1), "same", "zeros", 3, 18, True, (7, 8, 9)),
    ((3, 3, 3), 1, ((2, 2),) * 3, "reflect", 4, 4, False, (3, 2, 4)),
    # the discriminator's conv0 (1 -> 64 at 128^3 on the path), cut in size
    ((4, 4, 4), 2, ((1, 1),) * 3, "reflect", 1, 64, False, (18, 16, 20)),
])
def test_conv3d_kernel_matches_plain(cuda, dtype, k, stride, padding, pad_mode, ci, co,
                                     bias, dims):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, ci, *dims, generator=g).to(cuda, dtype)
    w = (torch.randn(co, ci, *k, generator=g) * 0.3).to(cuda)
    b = torch.randn(co, generator=g).to(cuda) if bias else None
    before = conv_ops.launches
    with torch.inference_mode():
        got = conv3d(x, w, b, stride, padding, pad_mode)
        s = norm_stride(stride)
        want = conv3d_plain(x, w, b, s, norm_padding(padding, k, s, dims), pad_mode)
    torch.cuda.synchronize()
    assert conv_ops.launches == before + 1
    assert got.shape == want.shape and got.dtype == dtype
    assert _rel_err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["none", "relu", "leaky_relu"])
@pytest.mark.parametrize("shape", [(2, 3, 5, 7, 9), (1, 16, 8, 8, 16), (2, 1, 40, 40, 40),
                                   (2, 512, 6, 5, 7)])  # the discriminator's down2
def test_instnorm_kernel_matches_plain(cuda, dtype, act, shape):
    g = torch.Generator().manual_seed(1)
    x = (torch.randn(*shape, generator=g) * 2 + 0.5).to(cuda, dtype)
    gamma = (torch.randn(shape[1], generator=g) * 0.5 + 1).to(cuda)
    beta = (torch.randn(shape[1], generator=g) * 0.2).to(cuda)
    before = in_ops.launches
    with torch.inference_mode():
        got = in_ops.instance_norm_act(x, gamma, beta, 1e-3, act, 0.2)
        want = in_ops.instance_norm_act_plain(x, gamma, beta, 1e-3, act, 0.2)
    torch.cuda.synchronize()
    assert in_ops.launches == before + 1
    assert got.dtype == dtype
    assert _rel_err(got, want) <= TOL[dtype]


def test_instnorm_kernel_large_offset(cuda):
    """Welford/Chan statistics: mean 50, std 0.1 in float32."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy((rng.normal(size=(1, 3, 16, 16, 32)) * 0.1 + 50).astype(np.float32))
    ones, zeros = torch.ones(3), torch.zeros(3)
    want = in_ops.instance_norm_act_plain(x, ones, zeros)  # two-pass f32 on the CPU
    with torch.inference_mode():
        got = in_ops.instance_norm_act(x.to(cuda), ones.to(cuda), zeros.to(cuda)).cpu()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3)


CONV_CASES = [
    ((3, 3, 3), 1, ((1, 1),) * 3, "reflect", 5, 7, True, (9, 10, 11)),
    ((3, 3, 3), 2, ((1, 1),) * 3, "reflect", 16, 32, False, (12, 9, 13)),
    ((4, 4, 4), 2, ((1, 1),) * 3, "zeros", 1, 20, False, (10, 12, 9)),
    ((1, 1, 1), 1, "same", "zeros", 48, 16, False, (8, 8, 8)),
    ((1, 1, 1), 2, "same", "zeros", 16, 32, False, (9, 8, 7)),
    ((1, 1, 1), 1, "same", "zeros", 16, 1, True, (6, 7, 8)),
    ((3, 3, 3), 2, "same", "zeros", 6, 5, True, (9, 7, 11)),
    ((4, 4, 4), 1, "same", "zeros", 3, 4, False, (7, 6, 9)),  # TF SAME pads (1, 2)
    ((3, 1, 2), (1, 2, 1), "same", "zeros", 3, 18, True, (7, 8, 9)),
    ((3, 3, 3), 1, ((2, 2),) * 3, "reflect", 4, 4, False, (3, 2, 4)),
    # the discriminator's conv0 (1 -> 64 at 128^3 on the path), cut in size
    ((4, 4, 4), 2, ((1, 1),) * 3, "reflect", 1, 64, False, (18, 16, 20)),
    ((3, 3, 3), 1, ((1, 1),) * 3, "reflect", 96, 32, False, (6, 5, 7)),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,stride,padding,pad_mode,ci,co,bias,dims", CONV_CASES)
def test_conv3d_grad_kernels_match_plain(cuda, dtype, k, stride, padding, pad_mode, ci, co,
                                         bias, dims):
    """dx (the forward kernel per stride parity) and dW (conv3d_wgrad.cu)
    through the autograd Function, against conv3d_dgrad_plain /
    conv3d_wgrad_plain; dx rel 1e-4 (f32) / 2e-2 (bf16), dW 1e-3 / 2e-2:
    dW sums over every voxel in another order."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, ci, *dims, generator=g).to(cuda, dtype).requires_grad_()
    w = (torch.randn(co, ci, *k, generator=g) * 0.3).to(cuda).requires_grad_()
    b = torch.randn(co, generator=g).to(cuda).requires_grad_() if bias else None
    s = norm_stride(stride)
    pads = norm_padding(padding, k, s, dims)
    y = conv3d(x, w, b, stride, padding, pad_mode)
    gy = torch.randn(y.shape, generator=g).to(cuda, dtype)
    before = (conv_ops.dgrad_launches, conv_ops.wgrad_launches)
    y.backward(gy)
    torch.cuda.synchronize()
    n_parities = int(np.prod([sum(len(range(p, kk, ss)) > 0 for p in range(ss))
                              for kk, ss in zip(k, s)]))
    assert (conv_ops.dgrad_launches, conv_ops.wgrad_launches) == \
        (before[0] + n_parities, before[1] + 1)
    dx = conv_ops.conv3d_dgrad_plain(gy, w.detach(), x.shape, s, pads, pad_mode)
    dw = conv_ops.conv3d_wgrad_plain(x.detach(), gy, w.shape, s, pads, pad_mode)
    assert x.grad.dtype == dtype and w.grad.dtype == torch.float32
    assert _rel_err(x.grad, dx) <= TOL[dtype]
    assert _rel_err(w.grad, dw) <= (1e-3 if dtype == torch.float32 else 2e-2)
    if bias:
        torch.testing.assert_close(b.grad, gy.float().sum((0, 2, 3, 4)))


# bf16 shapes for the tensor-core and thin routes, with the route each of K1,
# K3 and the parities of K2 takes: (k, stride, padding, pad_mode, batch, ci,
# co, bias, dims, (fwd route, wgrad route))
BF16_ROUTE_CASES = [
    # Co not a multiple of 16, a ragged brick in every axis
    ((3, 3, 3), 1, ((1, 1),) * 3, "reflect", 2, 20, 24, True, (13, 7, 9), ("mma", "mma")),
    # Ci = 1: the forward takes the CUDA-core body, K3 pads the channels
    ((3, 3, 3), 1, ((1, 1),) * 3, "reflect", 2, 1, 16, False, (13, 7, 9), ("thin", "mma")),
    # Co = 1 (the head), 1^3: one 8-wide n tile, K3 splits voxels over warps
    ((1, 1, 1), 1, "same", "zeros", 3, 16, 1, True, (13, 7, 9), ("mma", "mma")),
    # 2^3 kernels, as the 4^3 stride-2 convs' parity sub-kernels
    ((2, 2, 2), 1, ((1, 0),) * 3, "zeros", 2, 17, 33, False, (9, 10, 11), ("mma", "mma")),
    # 4^3 stride 2 (the discriminator's conv0 with more channels): 2 tap groups
    ((4, 4, 4), 2, ((1, 1),) * 3, "reflect", 2, 18, 40, False, (18, 16, 20), ("mma", "mma")),
    # reflect pads wider than 1, a reflect wider than the axis
    ((3, 3, 3), 1, ((3, 3), (2, 2), (1, 1)), "reflect", 2, 32, 16, False, (5, 3, 12),
     ("mma", "mma")),
    # stride 2 with a 1^3 kernel: the halo keeps every other position
    ((1, 1, 1), 2, "same", "zeros", 3, 48, 16, False, (13, 7, 9), ("mma", "mma")),
    # Co = 96 in two tiles of 48, at batch 3
    ((3, 3, 3), 2, ((1, 1),) * 3, "reflect", 3, 16, 96, False, (11, 12, 9), ("mma", "mma")),
    # mixed kernel extents and strides
    ((3, 1, 2), (1, 2, 1), "same", "zeros", 3, 40, 18, True, (7, 8, 9), ("mma", "mma")),
]


@pytest.mark.parametrize("k,stride,padding,pad_mode,batch,ci,co,bias,dims,routes",
                         BF16_ROUTE_CASES)
def test_conv3d_bf16_routes_match_plain(cuda, k, stride, padding, pad_mode, batch, ci, co,
                                        bias, dims, routes):
    """K1, K2 and K3 in bfloat16 on the route conv_plan gives each shape,
    against the plain versions: rel 2e-2 of the reference's max (bf16
    inputs, f32 sums in another order, one rounding of the output)."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn(batch, ci, *dims, generator=g).to(cuda, torch.bfloat16).requires_grad_()
    w = (torch.randn(co, ci, *k, generator=g) * 0.3).to(cuda).requires_grad_()
    b = torch.randn(co, generator=g).to(cuda).requires_grad_() if bias else None
    s = norm_stride(stride)
    pads = norm_padding(padding, k, s, dims)
    y = conv3d(x, w, b, stride, padding, pad_mode)
    out_dims = y.shape[2:]
    plans = [conv_ops.conv_plan(op, ci, co, k, s, out_dims, torch.bfloat16, batch)
             for op in ("fwd", "wgrad")]
    assert tuple(p.route for p in plans) == routes
    with torch.inference_mode():
        want = conv3d_plain(x.detach(), w.detach(), None if b is None else b.detach(), s, pads,
                            pad_mode)
    assert y.dtype == torch.bfloat16 and _rel_err(y.detach(), want) <= 2e-2
    gy = torch.randn(y.shape, generator=g).to(cuda, torch.bfloat16)
    y.backward(gy)
    torch.cuda.synchronize()
    dx = conv_ops.conv3d_dgrad_plain(gy, w.detach(), x.shape, s, pads, pad_mode)
    dw = conv_ops.conv3d_wgrad_plain(x.detach(), gy, w.shape, s, pads, pad_mode)
    assert _rel_err(x.grad, dx) <= 2e-2
    assert _rel_err(w.grad, dw) <= 2e-2


@pytest.mark.parametrize("k,stride,padding,pad_mode,batch,ci,co,bias,dims,routes",
                         BF16_ROUTE_CASES[:3] + BF16_ROUTE_CASES[4:5])
def test_conv3d_wgrad_bf16_is_bit_identical(cuda, k, stride, padding, pad_mode, batch, ci, co,
                                            bias, dims, routes):
    """K3 on the tensor cores sums its split-K partial tiles in a fixed order:
    two runs on the same inputs give the same bits."""
    g = torch.Generator().manual_seed(8)
    s = norm_stride(stride)
    pads = norm_padding(padding, k, s, dims)
    x = torch.randn(batch, ci, *dims, generator=g).to(cuda, torch.bfloat16)
    out_dims = [(n + lo + hi - kk) // ss + 1 for n, (lo, hi), kk, ss in zip(dims, pads, k, s)]
    gy = torch.randn(batch, co, *out_dims, generator=g).to(cuda, torch.bfloat16)
    first = conv_ops.conv3d_wgrad(x, gy, (co, ci, *k), s, pads, pad_mode)
    second = conv_ops.conv3d_wgrad(x, gy, (co, ci, *k), s, pads, pad_mode)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["none", "relu", "leaky_relu"])
@pytest.mark.parametrize("shape", [(2, 3, 5, 7, 9), (1, 16, 8, 8, 16), (2, 1, 40, 40, 40),
                                   (2, 512, 6, 5, 7)])
def test_instnorm_backward_kernel_matches_plain(cuda, dtype, act, shape):
    """dx, dgamma, dbeta against instance_norm_act_bwd_plain, rel 1e-4 (f32) /
    2e-2 (bf16) of each reference's max."""
    g = torch.Generator().manual_seed(4)
    x = (torch.randn(*shape, generator=g) * 2 + 0.5).to(cuda, dtype).requires_grad_()
    gamma = (torch.randn(shape[1], generator=g) * 0.5 + 1).to(cuda).requires_grad_()
    beta = (torch.randn(shape[1], generator=g) * 0.2).to(cuda).requires_grad_()
    gy = torch.randn(*shape, generator=g).to(cuda, dtype)
    y = in_ops.instance_norm_act(x, gamma, beta, 1e-3, act, 0.2)
    before = in_ops.bwd_launches
    y.backward(gy)
    torch.cuda.synchronize()
    assert in_ops.bwd_launches == before + 1
    want = in_ops.instance_norm_act_bwd_plain(x.detach(), gy, gamma.detach(), beta.detach(),
                                              1e-3, act, 0.2)
    assert x.grad.dtype == dtype
    for got, ref in zip((x.grad, gamma.grad, beta.grad), want):
        assert _rel_err(got, ref) <= TOL[dtype]


@pytest.mark.parametrize("iters", [0, 1, 4])
@pytest.mark.parametrize("dims", [(1, 1, 1), (2, 5, 17), (33, 2, 5), (17, 17, 33)])
def test_soft_skel_backward_kernel_matches_autograd(cuda, dims, iters):
    """On distinct values, where any tie rule gives the same input gradient:
    max |diff| <= 1e-5 * max |g| against autograd of morphology.soft_skel."""
    rng = np.random.default_rng(5)
    n = int(np.prod(dims)) * 2
    data = (rng.permutation(n).reshape(2, *dims, 1) / n).astype(np.float32)
    x = torch.from_numpy(data).to(cuda).requires_grad_()
    xp = torch.from_numpy(data).to(cuda).requires_grad_()
    gy = torch.from_numpy(rng.normal(size=data.shape).astype(np.float32)).to(cuda)
    before = (skel_ops.launches, skel_ops.bwd_launches)
    skel_ops.soft_skel(x, iters).backward(gy)
    torch.cuda.synchronize()
    assert (skel_ops.launches, skel_ops.bwd_launches) == \
        (before[0] + iters + 1, before[1] + iters + 1)
    morphology.soft_skel(xp, iters).backward(gy)
    scale = float(xp.grad.abs().max())
    assert float((x.grad - xp.grad).abs().max()) <= 1e-5 * max(scale, 1e-30)


def _faces_volume(rng, shape):
    """Binary data with random structures on every face and three faces full."""
    v = (rng.uniform(size=shape) > 0.7).astype(np.float32)
    v[:, 0] = 1.0
    v[:, :, -1] = 1.0
    v[:, :, :, 0] = 1.0
    return v


@pytest.mark.parametrize("iters", [0, 1, 15])
@pytest.mark.parametrize("dims", [(1, 1, 1), (2, 5, 17), (33, 2, 5), (5, 33, 1), (17, 17, 33),
                                  (1, 33, 2)])
def test_soft_skel_kernel_bit_exact(cuda, dims, iters):
    rng = np.random.default_rng(3)
    for data in (_faces_volume(rng, (2, *dims, 1)),
                 rng.uniform(size=(2, *dims, 1)).astype(np.float32)):
        x = torch.from_numpy(data).to(cuda)
        before = skel_ops.launches
        with torch.inference_mode():
            got = skel_ops.soft_skel(x, iters)
            want = morphology.soft_skel(x, iters)
        torch.cuda.synchronize()
        assert skel_ops.launches == before + iters + 1
        assert got.shape == want.shape == x.shape
        assert float((got - want).abs().max()) == 0.0
