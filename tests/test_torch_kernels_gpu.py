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

import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from vangan_torch.ops import conv3d as conv_ops
from vangan_torch.ops import instnorm as in_ops
from vangan_torch.ops import morphology
from vangan_torch.ops import skeleton as skel_ops
from vangan_torch.ops.conv3d import conv3d, conv3d_plain, norm_padding, norm_stride

from test_torch_conv3d_plan import PATH_CONVS  # noqa: E402  (a sibling module: the path's convs)

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
    # the other generators' shapes, cut in size: the ResNet's 7^3 reflect
    # stem and head (343 taps: in bfloat16 the 1 -> 8 forward and the 8 -> 1
    # input gradient on route 3, the 8 -> 1 forward and the 1 -> 8 input
    # gradient in tap chunks; float32 on the CUDA cores), its 4^3 TF SAME upsample
    # conv (pads (1, 2)), the i2s V-Net's 3^3 zero 'same' upconv and its
    # 3^3 reflect conv, both 64 -> 32
    ((7, 7, 7), 1, ((3, 3),) * 3, "reflect", 1, 8, False, (11, 9, 10)),
    ((7, 7, 7), 1, ((3, 3),) * 3, "reflect", 8, 1, True, (9, 10, 11)),
    ((4, 4, 4), 1, "same", "zeros", 64, 32, False, (9, 8, 10)),
    ((3, 3, 3), 1, "same", "zeros", 64, 32, True, (9, 10, 8)),
    ((3, 3, 3), 1, ((1, 1),) * 3, "reflect", 64, 32, True, (9, 8, 10)),
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
                                   (2, 512, 6, 5, 7),  # the discriminator's down2
                                   # the i2s V-Net's and ResNet's deep planes
                                   (3, 256, 16, 16, 16), (3, 512, 8, 8, 8)])
def test_instnorm_kernel_matches_plain(cuda, dtype, act, shape):
    g = torch.Generator().manual_seed(1)
    x = (torch.randn(*shape, generator=g) * 2 + 0.5).to(cuda, dtype)
    gamma = (torch.randn(shape[1], generator=g) * 0.5 + 1).to(cuda)
    beta = (torch.randn(shape[1], generator=g) * 0.2).to(cuda)
    before = (in_ops.launches, in_ops.fwd_kernel_launches)
    with torch.inference_mode():
        got = in_ops.instance_norm_act(x, gamma, beta, 1e-3, act, 0.2)
        want = in_ops.instance_norm_act_plain(x, gamma, beta, 1e-3, act, 0.2)
    torch.cuda.synchronize()
    assert (in_ops.launches, in_ops.fwd_kernel_launches) == (before[0] + 1, before[1] + 1)
    assert got.dtype == dtype
    assert _rel_err(got, want) <= TOL[dtype]


def _in_forward(cuda, dtype, shape, act, seed=7):
    """(kernel y, stats) on ``fwd_plan``'s route and the plain y, on seeded
    data."""
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(*shape, generator=g) * 2 + 0.5).to(cuda, dtype)
    gamma = (torch.randn(shape[1], generator=g) * 0.5 + 1).to(cuda)
    beta = (torch.randn(shape[1], generator=g) * 0.2).to(cuda)
    with torch.inference_mode():
        y, stats = in_ops._instance_norm_act_cuda(x, gamma, beta, 1e-3, act, 0.2)
        want = in_ops.instance_norm_act_plain(x, gamma, beta, 1e-3, act, 0.2)
    torch.cuda.synchronize()
    return y, stats, want


# K4 on each route of fwd_plan: small (aligned and not), clusters of 1, 2, 4,
# 8 and 16 blocks with ragged last runs, the unaligned 31^3 plane (runs
# sharing their end vectors), streamed planes (128^3, f32 and bf16;
# unaligned and ragged) and the stream body with its runs held whole
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (3, 5, 16, 16, 16),      # small
    (2, 3, 5, 7, 9),         # small, unaligned
    (2, 3, 31, 31, 31),      # cluster of 1 (bf16) / 2 (f32), unaligned
    (1, 3, 33, 35, 37),      # ragged last run
    (2, 2, 64, 64, 64),      # cluster of 8 (bf16) / 16 (f32)
    (1, 2, 128, 128, 128),   # stream on a cluster of 16
    (1, 1, 97, 101, 103),    # stream, unaligned, ragged
    (2, 1, 50, 50, 50),      # cluster of 4 (bf16) / 8 (f32), ragged
    (1, 2, 90, 90, 90),      # the stream body, runs held whole (bf16) / re-read (f32)
    (2, 1, 40, 40, 40),      # cluster of 2 (bf16) / 4 (f32)
    (1, 1, 80, 80, 79),      # cluster of 16 (bf16) / stream, held whole (f32), unaligned
])
def test_instnorm_forward_routes_match_plain(cuda, dtype, shape):
    n = int(np.prod(shape[2:]))
    esize = 4 if dtype == torch.float32 else 2
    plan = in_ops.fwd_plan(n, dtype, n * esize % 16 == 0)
    before = in_ops.fwd_kernel_launches
    for act in ("none", "leaky_relu"):
        got, stats, want = _in_forward(cuda, dtype, shape, act)
        assert got.dtype == dtype and got.shape == want.shape
        assert _rel_err(got, want) <= TOL[dtype]
        assert bool(torch.isfinite(stats).all())
    assert in_ops.fwd_kernel_launches == before + 2 * plan.launches


@pytest.mark.parametrize("shape", [(3, 16, 128, 128, 128), (3, 32, 64, 64, 64),
                                   (2, 3, 31, 31, 31), (3, 16, 16, 16, 16)])
def test_instnorm_forward_is_deterministic(cuda, shape):
    """Every block merges the cluster's partials in rank order: two runs, the
    same bits (y and the stats the backward reads)."""
    first = _in_forward(cuda, torch.bfloat16, shape, "relu")
    second = _in_forward(cuda, torch.bfloat16, shape, "relu")
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


def test_instnorm_forward_refuses_a_plan_it_does_not_hold(cuda):
    """The C entry takes only the plans fwd_plan makes: one whose blocks do
    not cover the plane, a small block given a cluster, other sizes than the
    route's, or a stream plan for a plane a cluster holds is refused (1000),
    not run, and counts no launch."""
    import ctypes
    import dataclasses

    from vangan_torch.ops import build

    plan = in_ops.fwd_plan(64 ** 3, torch.bfloat16, True)
    stream = in_ops.fwd_plan(128 ** 3, torch.bfloat16, True)
    x = torch.zeros(1, 1, 64, 64, 64, device=cuda, dtype=torch.bfloat16)
    y = torch.empty_like(x)
    one, zero = torch.ones(1, device=cuda), torch.zeros(1, device=cuda)
    stats = torch.empty(4, device=cuda)
    for bad in (dataclasses.replace(plan, vecs_per_block=plan.vecs_per_block // 2),
                dataclasses.replace(plan, route="small"),
                dataclasses.replace(plan, threads=in_ops.FWD_STREAM_THREADS),
                dataclasses.replace(plan, smem_vecs=plan.smem_vecs // 2),
                dataclasses.replace(plan, rpt=2),
                dataclasses.replace(stream, vecs_per_block=plan.vecs_per_block,
                                    cluster=plan.cluster, smem_vecs=plan.smem_vecs)):
        launched = ctypes.c_int(0)
        status = build.library().vg_instnorm_fwd(
            x.data_ptr(), one.data_ptr(), zero.data_ptr(), y.data_ptr(), stats.data_ptr(), 1,
            1, 1, 64 ** 3, in_ops.FWD_ROUTES[bad.route], bad.cluster, bad.threads, bad.rpt,
            bad.vecs_per_block, bad.smem_vecs, 1e-3, 0, 0.2,
            torch.cuda.current_stream().cuda_stream, ctypes.byref(launched))
        assert (status, launched.value) == (1000, 0), bad


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
    # the other generators' shapes, cut in size: the ResNet's 7^3 reflect
    # stem and head (343 taps: in bfloat16 the 1 -> 8 forward and the 8 -> 1
    # input gradient on route 3, the 8 -> 1 forward and the 1 -> 8 input
    # gradient in tap chunks; float32 on the CUDA cores), its 4^3 TF SAME upsample
    # conv (pads (1, 2)), the i2s V-Net's 3^3 zero 'same' upconv and its
    # 3^3 reflect conv, both 64 -> 32
    ((7, 7, 7), 1, ((3, 3),) * 3, "reflect", 1, 8, False, (11, 9, 10)),
    ((7, 7, 7), 1, ((3, 3),) * 3, "reflect", 8, 1, True, (9, 10, 11)),
    ((4, 4, 4), 1, "same", "zeros", 64, 32, False, (9, 8, 10)),
    ((3, 3, 3), 1, "same", "zeros", 64, 32, True, (9, 10, 8)),
    ((3, 3, 3), 1, ((1, 1),) * 3, "reflect", 64, 32, True, (9, 8, 10)),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,stride,padding,pad_mode,ci,co,bias,dims", CONV_CASES)
def test_conv3d_grad_kernels_match_plain(cuda, dtype, k, stride, padding, pad_mode, ci, co,
                                         bias, dims):
    """dx (conv3d_dgrad.cu: one launch, and one fold launch for a reflect
    pad) and dW (conv3d_wgrad.cu) through the autograd Function, against
    conv3d_dgrad_plain / conv3d_wgrad_plain; dx rel 1e-4 (f32) / 2e-2 (bf16),
    dW 1e-3 / 2e-2: dW sums over every voxel in another order."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, ci, *dims, generator=g).to(cuda, dtype).requires_grad_()
    w = (torch.randn(co, ci, *k, generator=g) * 0.3).to(cuda).requires_grad_()
    b = torch.randn(co, generator=g).to(cuda).requires_grad_() if bias else None
    s = norm_stride(stride)
    pads = norm_padding(padding, k, s, dims)
    y = conv3d(x, w, b, stride, padding, pad_mode)
    gy = torch.randn(y.shape, generator=g).to(cuda, dtype)
    before = (conv_ops.dgrad_launches, conv_ops.dgrad_fold_launches, conv_ops.wgrad_launches)
    y.backward(gy)
    torch.cuda.synchronize()
    folds = int(pad_mode == "reflect" and any(lo or hi for lo, hi in pads))
    assert (conv_ops.dgrad_launches, conv_ops.dgrad_fold_launches, conv_ops.wgrad_launches) == \
        (before[0] + 1, before[1] + folds, before[2] + 1)
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


@pytest.mark.parametrize("dtype,k,ci,co,dims,batch", [
    (torch.float32, (3, 3, 3), 16, 24, (13, 7, 9), 2),
    (torch.float32, (4, 4, 4), 32, 64, (17, 16, 18), 3),
    # 343-tap convs that the tap chunks do not take (Ci < 16): the
    # CUDA-core body in bf16
    (torch.bfloat16, (7, 7, 7), 1, 8, (20, 18, 22), 2),
    (torch.bfloat16, (7, 7, 7), 8, 1, (20, 18, 22), 2)])
def test_conv3d_wgrad_cuda_core_is_bit_identical(cuda, dtype, k, ci, co, dims, batch):
    """K3's CUDA-core body writes its split-K partial tiles to a workspace
    that one launch sums in a fixed order: two runs on the same inputs give
    the same bits, and dW is within 1e-4 (f32) / 2e-2 (bf16) of the plain
    version ('same' reflect pads, unit stride)."""
    g = torch.Generator().manual_seed(9)
    s = (1, 1, 1)
    pads = tuple((kk // 2, kk - 1 - kk // 2) for kk in k)
    x = torch.randn(batch, ci, *dims, generator=g).to(cuda, dtype)
    gy = torch.randn(batch, co, *dims, generator=g).to(cuda, dtype)
    plan = conv_ops.conv_plan("wgrad", ci, co, k, s, dims, dtype, batch)
    assert plan.route in ("f32", "thin") and plan.split > 1
    first = conv_ops.conv3d_wgrad(x, gy, (co, ci, *k), s, pads, "reflect")
    second = conv_ops.conv3d_wgrad(x, gy, (co, ci, *k), s, pads, "reflect")
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    want = conv_ops.conv3d_wgrad_plain(x, gy, (co, ci, *k), s, pads, "reflect")
    assert _rel_err(first, want) <= (1e-4 if dtype == torch.float32 else 2e-2)


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
    max |diff| <= 1e-5 * max |g| against autograd of morphology.soft_skel;
    one kernel launch per round."""
    rng = np.random.default_rng(5)
    n = int(np.prod(dims)) * 2
    data = (rng.permutation(n).reshape(2, *dims, 1) / n).astype(np.float32)
    x = torch.from_numpy(data).to(cuda).requires_grad_()
    xp = torch.from_numpy(data).to(cuda).requires_grad_()
    gy = torch.from_numpy(rng.normal(size=data.shape).astype(np.float32)).to(cuda)
    before = (skel_ops.launches, skel_ops.bwd_launches, skel_ops.bwd_kernel_launches)
    skel_ops.soft_skel(x, iters).backward(gy)
    torch.cuda.synchronize()
    assert (skel_ops.launches, skel_ops.bwd_launches, skel_ops.bwd_kernel_launches) == \
        (before[0] + iters + 1, before[1] + iters + 1, before[2] + iters + 1)
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


# K7 against its gather in torch (skeleton.round_bwd_plain), round by round
# from the same kept volumes: the same tie rule and the same sums in the same
# order, so the same values (max |diff| == 0), also on binary data, where
# ties are everywhere and autograd routes them otherwise
@pytest.mark.parametrize("dims", [(1, 1, 1), (2, 5, 17), (33, 2, 5), (17, 19, 35), (9, 40, 70),
                                  (40, 3, 33)])
def test_soft_skel_backward_kernel_matches_round_gather(cuda, dims):
    rng = np.random.default_rng(12)
    iters = 3
    for data in (_faces_volume(rng, (2, *dims, 1)),
                 (rng.permutation(2 * int(np.prod(dims))).reshape(2, *dims, 1)
                  / (2 * np.prod(dims))).astype(np.float32)):
        x = torch.from_numpy(data).to(cuda)
        gy = torch.from_numpy(rng.normal(size=data.shape).astype(np.float32)).to(cuda)
        with torch.inference_mode():
            _, imgs, skels = skel_ops._soft_skel_cuda(x, iters, keep=True)
            got = skel_ops._soft_skel_bwd_cuda(imgs, skels, gy, x.shape)
            d_skel, d_img = gy[..., 0], None
            for t in reversed(range(iters + 1)):
                d_img, d_skel = skel_ops.round_bwd_plain(
                    imgs[t], imgs[t + 1], skels[t - 1] if t else None, d_img, d_skel)
        torch.cuda.synchronize()
        assert float((got[..., 0] - d_img).abs().max()) == 0.0


# K6 against the plain skeleton, max |diff| == 0, on both paths: without
# residuals (``soft_skel`` under inference mode) and with them (``keep``, the
# differentiated path), where every kept round is also held against the plain
# round from the kernel's own inputs (morphology's erosion and update, and
# skeleton.round_fwd_plain). The later dims straddle the kernel's tiles: X not
# a multiple of its chunk of 16 planes, Y not of its 16 rows, Z not of a
# warp's 28 z, a dimension of 1.
@pytest.mark.parametrize("keep", [False, True])
@pytest.mark.parametrize("batch", [1, 2, 3])
@pytest.mark.parametrize("iters", [0, 1, 15])
@pytest.mark.parametrize("dims", [(1, 1, 1), (2, 5, 17), (33, 2, 5), (5, 33, 1), (17, 17, 33),
                                  (1, 33, 2), (37, 19, 29), (20, 1, 30), (17, 35, 57),
                                  (33, 17, 1)])
def test_soft_skel_kernel_bit_exact(cuda, dims, iters, batch, keep):
    rng = np.random.default_rng(3)
    for data in (_faces_volume(rng, (batch, *dims, 1)),
                 rng.uniform(size=(batch, *dims, 1)).astype(np.float32)):
        x = torch.from_numpy(data).to(cuda)
        before = skel_ops.launches
        with torch.inference_mode():
            if keep:
                got, imgs, skels = skel_ops._soft_skel_cuda(x, iters, keep=True)
            else:
                got = skel_ops.soft_skel(x, iters)
            want = morphology.soft_skel(x, iters)
        torch.cuda.synchronize()
        assert skel_ops.launches == before + iters + 1
        assert got.shape == want.shape == x.shape
        assert float((got - want).abs().max()) == 0.0
        if not keep:
            continue
        assert len(imgs) == len(skels) + 1 == iters + 2
        with torch.inference_mode():
            for t in range(iters + 1):
                v, prev = imgs[t], skels[t - 1] if t else None
                e = morphology._erode(v[:, None])[:, 0]
                delta = torch.relu(v - morphology._dilate(e[:, None])[:, 0])
                skel = delta if prev is None else prev + torch.relu(delta - prev * delta)
                skel_sep, e_sep = skel_ops.round_fwd_plain(v, prev)
                for ref_skel, ref_e in ((skel, e), (skel_sep, e_sep)):
                    assert float((imgs[t + 1] - ref_e).abs().max()) == 0.0
                    assert float((skels[t] - ref_skel).abs().max()) == 0.0


# K2 at every kernel conv shape of the path (tests/test_torch_conv3d_plan.py),
# batch 1: one launch per conv and a fold launch for a reflect pad
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(PATH_CONVS))
def test_conv3d_dgrad_at_path_shapes(cuda, dtype, name):
    ci, co, k, stride, padding, pad_mode, n = PATH_CONVS[name]
    k, s, dims = (k,) * 3, (stride,) * 3, (n,) * 3
    pads = norm_padding(padding, k, s, dims)
    out = [(d + lo + hi - kk) // ss + 1 for d, (lo, hi), kk, ss in zip(dims, pads, k, s)]
    g = torch.Generator().manual_seed(9)
    gy = torch.randn(1, co, *out, generator=g).to(cuda, dtype)
    w = (torch.randn(co, ci, *k, generator=g) * 0.1).to(cuda)
    plan = conv_ops.conv_plan("dgrad", ci, co, k, s, out, dtype, 1, in_dims=dims, pads=pads,
                              pad_mode=pad_mode)
    before = (conv_ops.dgrad_launches, conv_ops.dgrad_fold_launches)
    with torch.inference_mode():
        got = conv_ops.conv3d_dgrad(gy, w, (1, ci, *dims), s, pads, pad_mode)
        want = conv_ops.conv3d_dgrad_plain(gy, w, (1, ci, *dims), s, pads, pad_mode)
    torch.cuda.synchronize()
    assert (conv_ops.dgrad_launches, conv_ops.dgrad_fold_launches) == \
        (before[0] + 1, before[1] + plan.launches - 1)
    assert got.shape == want.shape and got.dtype == dtype
    assert _rel_err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["none", "relu", "leaky_relu"])
@pytest.mark.parametrize("shape", [(3, 256, 16, 16, 16), (3, 512, 8, 8, 8)])
def test_instnorm_backward_at_deep_planes(cuda, dtype, act, shape):
    """K5 on the i2s V-Net's and the ResNet's deep planes (3 x 512 x 8^3,
    3 x 256 x 16^3) against instance_norm_act_bwd_plain, rel 1e-4 (f32) /
    2e-2 (bf16). With this many voxels some pre-activations lie at act's
    kink, where the two sides' f32 pre-activations may fall on different
    sides and either one-sided slope is a subgradient: dx leaves out the
    voxels within 1e-6 of max |pre| of it, and dgamma / dbeta may differ
    per channel by those voxels' share, as ``chip_smoke.py``'s phase 3."""
    g = torch.Generator().manual_seed(4)
    x = (torch.randn(*shape, generator=g) * 2 + 0.5).to(cuda, dtype)
    gamma = (torch.randn(shape[1], generator=g) * 0.5 + 1).to(cuda)
    beta = (torch.randn(shape[1], generator=g) * 0.2).to(cuda)
    gy = torch.randn(*shape, generator=g).to(cuda, dtype)
    with torch.inference_mode():
        _, stats = in_ops._instance_norm_act_cuda(x, gamma, beta, 1e-3, act, 0.2)
        got = in_ops._instance_norm_act_bwd_cuda(x, gy, stats, act, 0.2)
        want = in_ops.instance_norm_act_bwd_plain(x, gy, gamma, beta, 1e-3, act, 0.2)
    torch.cuda.synchronize()
    xd = x.double()
    var, mean = torch.var_mean(xd, dim=(2, 3, 4), unbiased=False, keepdim=True)
    xhat = (xd - mean) * torch.rsqrt(var + 1e-3)
    pre = xhat * gamma.double().reshape(1, -1, 1, 1, 1) + beta.double().reshape(1, -1, 1, 1, 1)
    kink = pre.abs() <= 1e-6 * float(pre.abs().max())
    if act == "none":
        kink = torch.zeros_like(kink)
    gk = gy.double().abs() * kink
    slack = (None, (gk * xhat.abs()).sum(dim=(0, 2, 3, 4)), gk.sum(dim=(0, 2, 3, 4)))
    for part, a, b, sl in zip(("dx", "dgamma", "dbeta"), got, want, slack):
        diff = (a.double() - b.double()).abs()
        diff = diff[~kink] if sl is None else (diff - sl).clamp(min=0.0)
        assert float(diff.max()) <= TOL[dtype] * float(b.double().abs().max()), part


# the kernel convs that the other generators add to the path, at their full
# size, batch 1: (ci, co, k, stride, padding, pad_mode, n); in bfloat16 the
# ResNet's 7^3 head takes the tap chunks (K1, K3) and route 3 (K2), its stem
# route 3 (K1), the tap chunks (K2) and the CUDA-core body (K3)
OTHER_PATH_CONVS = {
    "vnet_i2s.down0.conv1": (32, 32, 3, 1, ((1, 1),) * 3, "reflect", 128),
    "vnet_i2s.upconv3": (64, 32, 3, 1, "same", "zeros", 128),
    "vnet_i2s.up3.conv0": (64, 32, 3, 1, ((1, 1),) * 3, "reflect", 128),
    "vnet_i2s.head": (32, 1, 1, 1, "same", "zeros", 128),
    "resnet.stem_conv": (1, 32, 7, 1, ((3, 3),) * 3, "reflect", 128),
    "resnet.down0": (32, 64, 3, 2, ((1, 1),) * 3, "reflect", 128),
    "resnet.up2": (64, 32, 4, 1, "same", "zeros", 128),
    "resnet.head": (32, 1, 7, 1, ((3, 3),) * 3, "reflect", 128),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(OTHER_PATH_CONVS))
def test_conv3d_kernels_at_other_generator_shapes(cuda, dtype, name):
    """K1, K2 and K3 through the autograd Function at each of these shapes
    against the plain versions, with the tolerances of the tests above."""
    ci, co, k, stride, padding, pad_mode, n = OTHER_PATH_CONVS[name]
    k, s, dims = (k,) * 3, (stride,) * 3, (n,) * 3
    pads = norm_padding(padding, k, s, dims)
    g = torch.Generator().manual_seed(10)
    x = torch.randn(1, ci, *dims, generator=g).to(cuda, dtype).requires_grad_()
    w = (torch.randn(co, ci, *k, generator=g) * (2.0 / (ci * np.prod(k))) ** 0.5).to(cuda)
    w.requires_grad_()
    y = conv3d(x, w, None, stride, padding, pad_mode)
    with torch.no_grad():
        want = conv3d_plain(x, w, None, s, pads, pad_mode)
    assert _rel_err(y, want) <= TOL[dtype]
    gy = torch.randn(y.shape, generator=g).to(cuda, dtype)
    y.backward(gy)
    torch.cuda.synchronize()
    dx = conv_ops.conv3d_dgrad_plain(gy, w.detach(), x.shape, s, pads, pad_mode)
    dw = conv_ops.conv3d_wgrad_plain(x.detach(), gy, w.shape, s, pads, pad_mode)
    assert _rel_err(x.grad, dx) <= TOL[dtype]
    assert _rel_err(w.grad, dw) <= (1e-3 if dtype == torch.float32 else 2e-2)


def _in_backward(cuda, dtype, shape, act, seed=6):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(*shape, generator=g) * 2 + 0.5).to(cuda, dtype)
    gamma = (torch.randn(shape[1], generator=g) * 0.5 + 1).to(cuda)
    beta = (torch.randn(shape[1], generator=g) * 0.2).to(cuda)
    gy = torch.randn(*shape, generator=g).to(cuda, dtype)
    with torch.inference_mode():
        _, stats = in_ops._instance_norm_act_cuda(x, gamma, beta, 1e-3, act, 0.2)
        got = in_ops._instance_norm_act_bwd_cuda(x, gy, stats, act, 0.2)
        want = in_ops.instance_norm_act_bwd_plain(x, gy, gamma, beta, 1e-3, act, 0.2)
    torch.cuda.synchronize()
    return got, want


# K5 on both sides of the small-plane threshold (8 * 256 * 4 bf16 elements
# per plane), with several blocks per plane and a ragged last chunk, and on
# planes that are not a multiple of 16 bytes
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,route", [
    ((3, 5, 16, 16, 32), None),       # 8192 elements: the largest small bf16 plane
    ((3, 5, 16, 16, 40), "split"),    # aligned, just past it: two passes
    ((3, 5, 15, 17, 33), "split"),    # not a multiple of 16 bytes, past it
    ((3, 7, 32, 32, 32), "split"),    # 2 blocks a plane, 21 planes
    ((2, 3, 8, 31, 271), "split"),    # 5 blocks a plane, the last one shorter
    ((2, 3, 5, 7, 9), "small"),       # small and not a multiple of 16 bytes
])
def test_instnorm_backward_plans_match_plain(cuda, dtype, shape, route):
    n = int(np.prod(shape[2:]))
    esize = 4 if dtype == torch.float32 else 2
    plan = in_ops.bwd_plan(n, dtype, n * esize % 16 == 0)
    if route is not None:
        assert plan.route == route
    before = in_ops.bwd_launches
    for act in ("none", "relu"):
        got, want = _in_backward(cuda, dtype, shape, act)
        for a, b in zip(got, want):
            assert _rel_err(a, b) <= TOL[dtype]
    assert in_ops.bwd_launches == before + 2  # one call each


@pytest.mark.parametrize("shape", [(3, 16, 16, 16, 16), (3, 16, 64, 64, 64), (2, 3, 5, 7, 9)])
def test_instnorm_backward_is_deterministic(cuda, shape):
    """The partial sums are added in a fixed order: two runs, the same bits."""
    first, _ = _in_backward(cuda, torch.bfloat16, shape, "leaky_relu")
    second, _ = _in_backward(cuda, torch.bfloat16, shape, "leaky_relu")
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# --- the training slice on the card: the pinned hand-off and checkpoints ---


def _tiny_training(tmp_path, seed=0):
    """A small VanGan on the card (every conv below 128 channels: all on the
    kernels, which are deterministic) and its config."""
    from vangan_torch.config import VanGanConfig
    from vangan_torch.vangan import VanGan

    cfg = VanGanConfig(BATCH_SIZE=2, SUBVOL_PATCH_SIZE=(32, 32, 32), gen_filters=4,
                       disc_filters=8, cldice_iters=2, output_dir=str(tmp_path), seed=seed)
    return cfg, VanGan(cfg, device="cuda")


def _partitions(tmp_path):
    rng = np.random.default_rng(0)
    parts = []
    for seg in (False, True):
        paths = []
        for i in range(2):
            v = (np.where(rng.uniform(size=(40, 36, 34, 1)) > 0.9, 1.0, -1.0) if seg
                 else rng.normal(size=(40, 36, 34, 1))).astype(np.float32)
            paths.append(str(tmp_path / f"{'seg' if seg else 'img'}{i}.npy"))
            np.save(paths[-1], v)
        parts.append({"training": paths, "validation": paths})
    return parts


def test_pinned_batches_give_the_pageable_step(cuda, tmp_path):
    """The feed's pinned batches (device cuda), copied without blocking,
    give the same steps as the same batches from pageable memory."""
    from vangan_torch.data.pipeline import VanGanDataset

    parts = _partitions(tmp_path)
    runs = []
    for device in ("cuda", "cpu"):
        cfg, gan = _tiny_training(tmp_path / device)
        ds = VanGanDataset(cfg, *parts, seed=1, device=device)
        it = ds.train_batches()
        try:
            for _ in range(2):
                x, y = next(it)
                assert x.is_pinned() == y.is_pinned() == (device == "cuda")
                losses = gan.distributed_train_step(x, y, 0.1, True)
        finally:
            ds.close()
        runs.append((gan, {k: float(v) for k, v in losses.items()}))
    (a, la), (b, lb) = runs
    assert la == lb
    for name in a.nets:
        for p, q in zip(a.nets[name].parameters(), b.nets[name].parameters()):
            assert torch.equal(p, q)


def test_checkpoint_round_trip_with_fused_adam_on_the_card(cuda, tmp_path):
    """Save after a step, load into a fresh VanGan on the card (the fused
    Adam's step tensors stay float32 on the device), and the next step of
    both is the same."""
    rng = np.random.default_rng(2)
    batch = [rng.normal(size=(2, 32, 32, 32, 1)).astype(np.float32),
             np.where(rng.uniform(size=(2, 32, 32, 32, 1)) > 0.8, 1.0, -1.0).astype(np.float32)]
    _, gan = _tiny_training(tmp_path)
    gan.distributed_train_step(*batch, 0.1, True)
    gan.save_checkpoint(epoch=0)
    _, fresh = _tiny_training(tmp_path, seed=5)
    fresh.load_checkpoint(epoch=1)
    assert fresh.checkpoint_loaded and fresh.state.step == 1
    for name in gan.nets:
        for p, q in zip(gan.nets[name].parameters(), fresh.nets[name].parameters()):
            assert torch.equal(p, q)
            sp, sq = gan.state.opt[name].state[p], fresh.state.opt[name].state[q]
            assert sq["step"].device.type == "cuda" and sq["step"].dtype == torch.float32
            assert all(torch.equal(sp[k], sq[k]) for k in ("step", "exp_avg", "exp_avg_sq"))
    fresh.generator.set_state(gan.generator.get_state())
    gan.distributed_train_step(*batch, 0.1, True)
    fresh.distributed_train_step(*batch, 0.1, True)
    for name in gan.nets:
        for p, q in zip(gan.nets[name].parameters(), fresh.nets[name].parameters()):
            assert torch.equal(p, q)


# K6 at the metric's shapes: whole volumes whose dims meet the warp tile's
# partial tiles (28 stored z a warp, 8 rows of y, chunks of 16 X planes), and
# the config's 512 x 512 x 128 segmentation volume
@pytest.mark.parametrize("shape", [(1, 97, 61, 45, 1), (2, 33, 130, 29, 1),
                                   (1, 512, 512, 128, 1)])
def test_soft_skel_kernel_bit_exact_at_volume_shapes(cuda, shape):
    rng = np.random.default_rng(5)
    for data in (_faces_volume(rng, shape), rng.uniform(size=shape).astype(np.float32)):
        x = torch.from_numpy(data).to(cuda)
        before = skel_ops.launches
        with torch.inference_mode():
            got = skel_ops.soft_skel(x, 15)
            want = morphology.soft_skel(x, 15)
        torch.cuda.synchronize()
        assert skel_ops.launches == before + 16
        assert got.shape == want.shape and float((got - want).abs().max()) == 0.0


def test_evaluate_segmentation_on_the_card_equals_the_cpu(cuda):
    """The metric on K6 (16 launches a skeleton) gives the CPU's plain
    scores exactly, on a binary volume and a stitched 0..255 one."""
    from vangan_torch import metrics

    rng = np.random.default_rng(6)
    shape = (97, 61, 45)
    truth = np.where(rng.uniform(size=shape) > 0.7, 1.0, -1.0).astype(np.float32)
    truth[20:60, 10:20, 5:40] = 1.0
    pred = np.where(truth > 0, rng.uniform(100, 255, shape), rng.uniform(0, 140, shape))
    for p in (pred.astype(np.float32), (truth > 0).astype(np.float32)):
        for iters in (5, 15):
            before = skel_ops.launches
            got = metrics.evaluate_segmentation(p, truth, iters=iters, device="cuda")
            assert skel_ops.launches == before + 2 * (iters + 1)
            want = metrics.evaluate_segmentation(p, truth, iters=iters, device="cpu")
            assert got == want and 0.0 < got["cldice"] <= 1.0


def test_preprocess_worker_pool_under_a_cuda_context(cuda, tmp_path):
    """``preprocess`` with two spawned workers, from a process that holds a
    CUDA context, on ten volumes (a 7/2/1 split, so the training and
    validation splits go through the pool): it finishes, and its volumes
    and partitions equal the serial run's."""
    from PIL import Image

    from vangan_torch.data.preprocess import DataPreprocessor
    from vangan_torch.utils import preprocess_rsom_images

    torch.ones(1, device=cuda).sum().item()  # the context exists before the pool starts
    rng = np.random.default_rng(7)
    raw = tmp_path / "raw"
    raw.mkdir()
    for i in range(10):
        pages = [Image.fromarray(p) for p in
                 rng.integers(0, 4096, (16, 24, 24)).astype(np.uint16)]
        pages[0].save(raw / f"v{i}.tiff", save_all=True, append_images=pages[1:])
    outs = {}
    for workers in (2, 1):
        out = tmp_path / f"w{workers}"
        out.mkdir()
        t0 = time.perf_counter()
        DataPreprocessor(raw_path=str(raw), main_dir=str(out), partition_id="A",
                         partition_filename="dataA_partition.pkl", tiff_size=(24, 24, 16),
                         target_size=(20, 20, 12), num_workers=workers, seed=3).preprocess(
            preprocess_fn=preprocess_rsom_images, resize=True)
        print(f"preprocess of 10 volumes with {workers} worker(s): "
              f"{time.perf_counter() - t0:.3f} s")
        outs[workers] = {os.path.relpath(os.path.join(d, f), out): np.load(os.path.join(d, f))
                         for d, _, fs in os.walk(out) for f in fs if f.endswith(".npy")}
    assert len(outs[2]) == 10 and sorted(outs[2]) == sorted(outs[1])
    for k, v in outs[2].items():
        assert v.shape == (20, 20, 12, 1) and np.array_equal(v, outs[1][k]), k
    assert sum(k.startswith("trainA") for k in outs[2]) == 7


# --- second derivatives (WGAN-GP's gradient penalty) through the Functions ---

DOUBLE_CONV_CASES = [
    # k, stride, padding, pad_mode, ci, co, bias, dims
    ((3, 3, 3), 1, "same", "zeros", 5, 7, True, (9, 10, 11)),
    ((3, 3, 3), 2, ((1, 1),) * 3, "reflect", 6, 8, False, (12, 9, 13)),
    # the discriminator's conv0 (1 -> 64, 4^3, stride 2, reflect 1), cut in size
    ((4, 4, 4), 2, ((1, 1),) * 3, "reflect", 1, 64, True, (18, 16, 20)),
    ((3, 1, 2), (1, 2, 1), "same", "zeros", 3, 18, True, (7, 8, 9)),
]


def _conv_second_derivative(x, w, b, gy, r, rw, stride, padding, pad_mode, plain):
    """(d/dx, d/dw, d/dgy) of sum(r dx) + sum(rw dw), with (dx, dw) the
    conv's first-order gradients for the cotangent gy under create_graph: K1
    (conv(r, w), conv(x, rw)), K2 (D(gy, rw)) and K3 (W(r, gy)) on the
    kernel path, torch's double backward of ``conv3d_plain`` on the plain one."""
    if plain:
        pads = norm_padding(padding, w.shape[2:], norm_stride(stride), x.shape[2:])
        y = conv3d_plain(x, w, b, norm_stride(stride), pads, pad_mode)
    else:
        y = conv3d(x, w, b, stride, padding, pad_mode)
    dx, dw = torch.autograd.grad(y, (x, w), gy, create_graph=True)
    s = (dx.float() * r).sum() + (dw.float() * rw).sum()
    return torch.autograd.grad(s, (x, w, gy), allow_unused=True, materialize_grads=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,stride,padding,pad_mode,ci,co,bias,dims", DOUBLE_CONV_CASES)
def test_conv3d_second_derivative_kernels_match_plain(cuda, dtype, k, stride, padding,
                                                      pad_mode, ci, co, bias, dims):
    """The conv's double backward on K1-K3 against torch's of the plain
    version: rel 1e-4 (f32; d/dw, a weight gradient summed over every voxel,
    1e-3) / 2e-2 (bf16); every kernel launched."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, ci, *dims, generator=g).to(cuda, dtype).requires_grad_()
    w = (torch.randn(co, ci, *k, generator=g) * 0.3).to(cuda).requires_grad_()
    b = torch.randn(co, generator=g).to(cuda).requires_grad_() if bias else None
    with torch.no_grad():
        y_shape = conv3d(x, w, b, stride, padding, pad_mode).shape
    gy = torch.randn(y_shape, generator=g).to(cuda, dtype).requires_grad_()
    r = torch.randn(x.shape, generator=g).to(cuda)
    rw = torch.randn(w.shape, generator=g).to(cuda)
    before = (conv_ops.launches, conv_ops.dgrad_launches, conv_ops.wgrad_launches)
    got = _conv_second_derivative(x, w, b, gy, r, rw, stride, padding, pad_mode, False)
    torch.cuda.synchronize()
    # first order: K1, K2, K3; second: K1 twice, K2 once, K3 once
    assert (conv_ops.launches, conv_ops.dgrad_launches, conv_ops.wgrad_launches) == \
        (before[0] + 3, before[1] + 2, before[2] + 2)
    want = _conv_second_derivative(x, w, b, gy, r, rw, stride, padding, pad_mode, True)
    for name, a, e in zip(("x", "w", "gy"), got, want):
        tol = TOL[dtype] * (10 if name == "w" and dtype == torch.float32 else 1)
        assert a.shape == e.shape and _rel_err(a, e) <= tol, (name, _rel_err(a, e))


@pytest.mark.parametrize("stride,pad_mode,bias", [(1, "zeros", True), (2, "reflect", False),
                                                  ((2, 1, 2), "reflect", True)])
def test_conv3d_gradgradcheck_float64_on_the_card(cuda, monkeypatch, stride, pad_mode, bias):
    """gradgradcheck in float64 through the Functions on CUDA tensors, with
    the launches swapped for the plain versions (the kernels take float32
    and bfloat16 only): the Functions' structure on the card."""
    from torch.autograd import gradgradcheck

    monkeypatch.setattr(conv_ops, "_forward", conv3d_plain)
    monkeypatch.setattr(conv_ops, "conv3d_dgrad", conv_ops.conv3d_dgrad_plain)
    monkeypatch.setattr(conv_ops, "conv3d_wgrad", conv_ops.conv3d_wgrad_plain)
    g = torch.Generator().manual_seed(4)
    f64 = dict(device=cuda, dtype=torch.float64)
    x = torch.randn(1, 2, 5, 4, 6, generator=g).to(**f64).requires_grad_()
    w = torch.randn(3, 2, 3, 2, 3, generator=g).to(**f64).requires_grad_()
    b = torch.randn(3, generator=g).to(**f64).requires_grad_() if bias else None
    pads = ((1, 1), (1, 0), (1, 1))
    args = (x, w) + ((b,) if bias else ())
    assert gradgradcheck(lambda x, w, *b: conv3d(x, w, b[0] if b else None, stride, pads,
                                                 pad_mode), args)


def _in_second_derivative(x, gamma, beta, gy, r, p, q, act, plain):
    """(d/dx, d/dgamma, d/dgy) of sum(r dx) + sum(p dgamma) + sum(q dbeta),
    with the norm's first-order gradients for gy under create_graph."""
    fn = in_ops.instance_norm_act_plain if plain else in_ops.instance_norm_act
    y = fn(x, gamma, beta, 1e-3, act, 0.2)
    dx, dgamma, dbeta = torch.autograd.grad(y, (x, gamma, beta), gy, create_graph=True)
    s = (dx.float() * r).sum() + (dgamma * p).sum() + (dbeta * q).sum()
    return torch.autograd.grad(s, (x, gamma, gy), allow_unused=True, materialize_grads=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["none", "relu", "leaky_relu"])
@pytest.mark.parametrize("shape", [(2, 3, 5, 7, 9), (2, 16, 32, 32, 32), (3, 64, 16, 16, 16)])
def test_instnorm_second_derivative_matches_plain(cuda, dtype, act, shape):
    """The norm's double backward (torch ops on K4's statistics and K5's
    sums) against torch's of the plain version: rel 1e-4 (f32) / 2e-2 (bf16)."""
    g = torch.Generator().manual_seed(5)
    c = shape[1]
    x = (torch.randn(shape, generator=g) * 2 + 0.5).to(cuda, dtype).requires_grad_()
    gamma = (torch.rand(c, generator=g) + 0.5).to(cuda).requires_grad_()
    beta = (torch.randn(c, generator=g) * 0.3).to(cuda).requires_grad_()
    gy = torch.randn(shape, generator=g).to(cuda, dtype).requires_grad_()
    r = torch.randn(shape, generator=g).to(cuda)
    p, q = (torch.randn(c, generator=g).to(cuda) for _ in range(2))
    before = (in_ops.launches, in_ops.bwd_launches)
    got = _in_second_derivative(x, gamma, beta, gy, r, p, q, act, False)
    torch.cuda.synchronize()
    assert (in_ops.launches, in_ops.bwd_launches) == (before[0] + 1, before[1] + 1)
    want = _in_second_derivative(x, gamma, beta, gy, r, p, q, act, True)
    for name, a, e in zip(("x", "gamma", "gy"), got, want):
        assert a.shape == e.shape and _rel_err(a, e) <= TOL[dtype], (name, _rel_err(a, e))


@pytest.mark.parametrize("act", ["none", "relu", "leaky_relu"])
def test_instnorm_gradgradcheck_float64_on_the_card(cuda, monkeypatch, act):
    """gradgradcheck in float64 through the Functions on CUDA tensors, with
    K4 and K5 swapped for the plain versions: the Functions' structure on the
    card, the statistics the double backward reads included."""
    from torch.autograd import gradgradcheck

    g = torch.Generator().manual_seed(6)
    f64 = dict(device=cuda, dtype=torch.float64)
    x = torch.randn(2, 3, 3, 4, 3, generator=g).to(**f64).requires_grad_()
    gamma = (torch.rand(3, generator=g) + 0.5).to(**f64).requires_grad_()
    beta = torch.randn(3, generator=g).to(**f64).requires_grad_()
    monkeypatch.setattr(in_ops, "_forward", lambda x, gm, bt, eps, act, alpha: (
        in_ops.instance_norm_act_plain(x, gm, bt, eps, act, alpha), None))
    monkeypatch.setattr(in_ops, "_bwd_cuda", lambda x, gy, stats, act, alpha: in_ops._bwd_plain(
        x, gy, gamma.detach(), beta.detach(), 1e-3, act, alpha))
    assert gradgradcheck(lambda x, gm, bt: in_ops.instance_norm_act(x, gm, bt, 1e-3, act, 0.2),
                         (x, gamma, beta))


@pytest.mark.parametrize("use_SN", [False, True])
def test_critic_gradient_penalty_on_the_kernels(cuda, use_SN):
    """The gradient penalty of a Wasserstein critic (f=8, so every conv takes
    the kernels; 32^3, batch 2, f32, head dropout on, the same draws on both
    paths) and its gradient w.r.t. the critic's parameters, on the kernels
    against the plain path: the penalty within 1e-4 relative, the gradient
    within 1e-3 relative L2 (second-order sums over every voxel in another
    order). With spectral norm every conv's weight is a normalised copy, and
    no InstanceNorm runs."""
    from vangan_torch.losses import LossScales, gradient_penalty
    from vangan_torch.models.discriminator import PatchGANDiscriminator3D

    g = torch.Generator().manual_seed(8)
    critic = PatchGANDiscriminator3D(filters=8, wasserstein=True, use_SN=use_SN,
                                     patch_size=(32, 32, 32), generator=g).to(cuda)
    real = (torch.rand(2, 32, 32, 32, 1, generator=g) * 2 - 1).to(cuda)
    fake = torch.tanh(torch.randn(2, 32, 32, 32, 1, generator=g)).to(cuda)
    alpha = torch.randn(2, 1, 1, 1, 1, generator=g).to(cuda)
    scales = LossScales(global_batch_size=2, n_devices=1)
    out = {}
    for kernels in (True, False):
        critic.set_use_kernels(kernels)
        draws = torch.Generator(device=cuda).manual_seed(0)
        before = (conv_ops.launches, conv_ops.wgrad_launches)
        gp = gradient_penalty(scales, lambda x: critic(x, True, 0.0, draws, update_stats=False),
                              real, fake, alpha=alpha)
        grads = torch.autograd.grad(gp, list(critic.parameters()), allow_unused=True,
                                    materialize_grads=True)
        torch.cuda.synchronize()
        if kernels:  # the second order ran K1 and K3
            assert conv_ops.launches - before[0] > 4 and conv_ops.wgrad_launches > before[1]
        out[kernels] = (float(gp), torch.cat([t.flatten() for t in grads]))
    (gp_k, g_k), (gp_p, g_p) = out[True], out[False]
    assert abs(gp_k - gp_p) <= 1e-4 * abs(gp_p)
    assert float((g_k - g_p).norm()) <= 1e-3 * float(g_p.norm())


# The 2-D mode's convs (DIMENSIONS=2: depth-1 volumes, (1, k, k) kernels,
# strides (1, s, s), no pad on the depth axis), cut in size: the ResU-Net's
# 3x3 reflect convs at strides 1 and 2, its 1x1 shortcut at stride 2 and
# head, the PatchGAN's 4x4 stride-2 conv0 and 4x4 TF SAME conv, the ResNet's
# 7x7 reflect stem and head (49 taps: the tensor cores, where 7^3 did not
# go), and a bf16 brick three quarters padding on every route
DEPTH1_CASES = [
    ((1, 3, 3), 1, ((0, 0), (1, 1), (1, 1)), "reflect", 16, 16, False, (1, 33, 40)),
    ((1, 3, 3), (1, 2, 2), ((0, 0), (1, 1), (1, 1)), "reflect", 16, 32, False, (1, 34, 29)),
    ((1, 1, 1), (1, 2, 2), "same", "zeros", 32, 64, False, (1, 30, 33)),
    ((1, 1, 1), 1, "same", "zeros", 16, 1, True, (1, 40, 36)),
    ((1, 4, 4), (1, 2, 2), ((0, 0), (1, 1), (1, 1)), "reflect", 1, 64, False, (1, 36, 34)),
    ((1, 4, 4), 1, "same", "zeros", 64, 32, False, (1, 17, 19)),
    ((1, 7, 7), 1, ((0, 0), (3, 3), (3, 3)), "reflect", 1, 32, False, (1, 31, 30)),
    ((1, 7, 7), 1, ((0, 0), (3, 3), (3, 3)), "reflect", 32, 1, True, (1, 29, 33)),
    ((1, 3, 3), 1, ((0, 0), (1, 1), (1, 1)), "reflect", 96, 32, False, (1, 8, 8)),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,stride,padding,pad_mode,ci,co,bias,dims", DEPTH1_CASES)
def test_conv3d_kernels_on_depth1_volumes(cuda, dtype, k, stride, padding, pad_mode, ci, co,
                                          bias, dims):
    """K1, K2 (with its fold on H and W) and K3 at the 2-D path's shapes
    against the plain versions, at batch 3; the bf16 dW bit-identical in
    two runs."""
    g = torch.Generator().manual_seed(13)
    x = torch.randn(3, ci, *dims, generator=g).to(cuda, dtype).requires_grad_()
    w = (torch.randn(co, ci, *k, generator=g) * 0.3).to(cuda).requires_grad_()
    b = torch.randn(co, generator=g).to(cuda).requires_grad_() if bias else None
    s = norm_stride(stride)
    pads = norm_padding(padding, k, s, dims)
    before = (conv_ops.launches, conv_ops.dgrad_launches, conv_ops.wgrad_launches)
    y = conv3d(x, w, b, stride, padding, pad_mode)
    gy = torch.randn(y.shape, generator=g).to(cuda, dtype)
    y.backward(gy)
    torch.cuda.synchronize()
    assert (conv_ops.launches, conv_ops.dgrad_launches, conv_ops.wgrad_launches) == \
        (before[0] + 1, before[1] + 1, before[2] + 1)
    with torch.inference_mode():
        want = conv3d_plain(x.detach(), w.detach(), None if b is None else b.detach(), s, pads,
                            pad_mode)
    assert y.shape == want.shape and y.shape[2] == 1
    assert _rel_err(y.detach(), want) <= TOL[dtype]
    dx = conv_ops.conv3d_dgrad_plain(gy, w.detach(), x.shape, s, pads, pad_mode)
    dw = conv_ops.conv3d_wgrad_plain(x.detach(), gy, w.shape, s, pads, pad_mode)
    assert _rel_err(x.grad, dx) <= TOL[dtype]
    assert _rel_err(w.grad, dw) <= (1e-3 if dtype == torch.float32 else 2e-2)
    if dtype == torch.bfloat16:
        again = conv_ops.conv3d_wgrad(x.detach(), gy, w.shape, s, pads, pad_mode)
        assert torch.equal(w.grad, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["none", "relu", "leaky_relu"])
@pytest.mark.parametrize("shape", [(3, 256, 1, 2, 2), (3, 256, 1, 4, 4), (3, 256, 1, 8, 8),
                                   (3, 16, 1, 128, 128), (2, 7, 1, 3, 5)])
def test_instnorm_kernels_on_small_planes(cuda, dtype, act, shape):
    """K4 and K5 on the 2-D mode's planes: 4, 16 and 64 elements (a bf16
    2 x 2 plane is 8 bytes, not one 16-byte vector), 128 x 128, and a ragged
    15-element one; forward and backward against the plain versions."""
    g = torch.Generator().manual_seed(14)
    x = (torch.randn(*shape, generator=g) * 2 + 0.5).to(cuda, dtype).requires_grad_()
    gamma = (torch.randn(shape[1], generator=g) * 0.5 + 1).to(cuda).requires_grad_()
    beta = (torch.randn(shape[1], generator=g) * 0.2).to(cuda).requires_grad_()
    gy = torch.randn(*shape, generator=g).to(cuda, dtype)
    before = (in_ops.launches, in_ops.fwd_kernel_launches, in_ops.bwd_launches)
    y = in_ops.instance_norm_act(x, gamma, beta, 1e-3, act, 0.2)
    y.backward(gy)
    torch.cuda.synchronize()
    assert (in_ops.launches, in_ops.fwd_kernel_launches, in_ops.bwd_launches) == \
        (before[0] + 1, before[1] + 1, before[2] + 1)
    with torch.inference_mode():
        want = in_ops.instance_norm_act_plain(x.detach(), gamma.detach(), beta.detach(), 1e-3,
                                              act, 0.2)
    assert _rel_err(y.detach(), want) <= TOL[dtype]
    grads = in_ops.instance_norm_act_bwd_plain(x.detach(), gy, gamma.detach(), beta.detach(),
                                               1e-3, act, 0.2)
    for got, ref in zip((x.grad, gamma.grad, beta.grad), grads):
        assert _rel_err(got, ref) <= TOL[dtype]


def test_2d_generator_and_cldice_on_the_card(cuda):
    """A 2-D ResU-Net (f=8, 4 levels) on 64 x 64 images: the f32 kernel path
    within 1e-3 of the plain path on the tanh outputs (chip_smoke.py phase
    5's rule), its narrow convs and every norm on the kernels; the 2-D
    clDice loss with the skeleton kernels switched on launches no skeleton
    kernel."""
    from vangan_torch.losses.cldice import soft_dice_cldice_grouped
    from vangan_torch.models.resunet import ResUNet3D

    model = ResUNet3D(filters=8, num_layers=4, upsample_mode="simple", dims=2,
                      generator=torch.Generator().manual_seed(0)).to(cuda).eval()
    x = torch.rand(2, 64, 64, 1, generator=torch.Generator().manual_seed(1)).to(cuda) * 2 - 1
    before = (conv_ops.launches, in_ops.launches)
    with torch.inference_mode():
        got = model(x)
        model.set_use_kernels(False)
        want = model(x)
    torch.cuda.synchronize()
    # convs with max(Ci, Co) < 128 on the kernels: 23 of the 30 at f=8
    assert conv_ops.launches - before[0] == 23 and in_ops.launches - before[1] == 28
    assert got.shape == (2, 64, 64, 1) and float((got - want).abs().max()) <= 1e-3
    truth = (x > 0.3).float()
    pred = torch.sigmoid(x * 3).requires_grad_()
    skel0 = (skel_ops.launches, skel_ops.bwd_launches)
    loss = soft_dice_cldice_grouped(truth, pred, 1, iters=5, use_kernel=True)
    loss.backward()
    torch.cuda.synchronize()
    assert (skel_ops.launches, skel_ops.bwd_launches) == skel0
    plain = soft_dice_cldice_grouped(truth.cpu(), pred.detach().cpu(), 1, iters=5)
    assert abs(float(loss) - float(plain)) <= 1e-5 * abs(float(plain))


# K1 and K3 above 64 taps: (ci, co, k, pad_mode, dims, batch). In bfloat16
# the convs to one channel take the tensor cores in tap chunks (route 2:
# the ResNet's head, 32 -> 1, and 16 and 48 channels, one chunk and a
# padded third), the 1 -> 32 stem's K1 route 3 and its K3 the CUDA-core
# body; float32 always the f32 route. Ragged bricks on every axis (20, 18, 22 and 9, 10, 11 against
# columns of 4 x 8 and 10 or 12 z outputs).
TAP_CHUNK_CASES = [
    (32, 1, 7, "reflect", (20, 18, 22), 2),
    (32, 1, 7, "zeros", (9, 10, 11), 1),
    (16, 1, 7, "reflect", (9, 10, 11), 2),
    (48, 1, 7, "zeros", (20, 18, 22), 1),
    (48, 1, 5, "reflect", (9, 10, 11), 2),
    (16, 1, 5, "zeros", (20, 18, 22), 1),
    (32, 1, 5, "reflect", (20, 18, 22), 2),
    (1, 32, 7, "reflect", (20, 18, 22), 2),
    (1, 32, 5, "zeros", (9, 10, 11), 1),
]


def _tap_chunk_inputs(cuda, dtype, ci, co, k, dims, batch, seed=11):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, ci, *dims, generator=g).to(cuda, dtype)
    w = (torch.randn(co, ci, k, k, k, generator=g) * (2.0 / (ci * k ** 3)) ** 0.5).to(cuda)
    b = (torch.randn(co, generator=g) * 0.1).to(cuda)
    gy = torch.randn(batch, co, *dims, generator=g).to(cuda, dtype)
    return x, w, b, gy, ((k // 2, k // 2),) * 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ci,co,k,pad_mode,dims,batch", TAP_CHUNK_CASES)
def test_conv3d_above_64_taps_match_plain(cuda, dtype, ci, co, k, pad_mode, dims, batch):
    """K1 and K3 on the route conv_plan gives these shapes, against the
    float32 plain versions: y within 1e-4 (float32) / 2e-2 (bfloat16) of
    max |y|, dW within 1e-3 / 2e-2; K3 bit-identical in two runs (its
    split-K slices summed in a fixed order) on every route."""
    x, w, b, gy, pads = _tap_chunk_inputs(cuda, dtype, ci, co, k, dims, batch)
    s, ks = (1, 1, 1), (k,) * 3
    plans = [conv_ops.conv_plan(op, ci, co, ks, s, dims, dtype, batch) for op in ("fwd", "wgrad")]
    chunks = dtype == torch.bfloat16 and co == 1
    assert [p.tap_chunks for p in plans] == [k * chunks] * 2, plans
    before = (conv_ops.launches, conv_ops.wgrad_launches)
    with torch.inference_mode():
        y = conv3d(x, w, b, 1, pads, pad_mode)
        dw = conv_ops.conv3d_wgrad(x, gy, w.shape, s, pads, pad_mode)
        again = conv_ops.conv3d_wgrad(x, gy, w.shape, s, pads, pad_mode)
        want = conv3d_plain(x.float(), w, b, s, pads, pad_mode)
        dwant = conv_ops.conv3d_wgrad_plain(x.float(), gy.float(), w.shape, s, pads, pad_mode)
    torch.cuda.synchronize()
    assert (conv_ops.launches, conv_ops.wgrad_launches) == (before[0] + 1, before[1] + 2)
    assert y.dtype == dtype and _rel_err(y, want) <= TOL[dtype]
    assert torch.equal(dw, again)
    assert _rel_err(dw, dwant) <= (1e-3 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("ci,co,k,pad_mode,dims,batch", TAP_CHUNK_CASES[:4])
def test_conv3d_above_64_taps_through_autograd(cuda, ci, co, k, pad_mode, dims, batch):
    """The head's shapes through the autograd Function in bfloat16: K1 and K3
    on the tap chunks, K2 (and its fold for a reflect pad) on route 3, each
    launched once, against the plain versions (2e-2)."""
    x, w, b, gy, pads = _tap_chunk_inputs(cuda, torch.bfloat16, ci, co, k, dims, batch, 12)
    x.requires_grad_()
    w.requires_grad_()
    s = (1, 1, 1)
    before = (conv_ops.launches, conv_ops.dgrad_launches, conv_ops.dgrad_fold_launches,
              conv_ops.wgrad_launches)
    conv3d(x, w, b, 1, pads, pad_mode).backward(gy)
    torch.cuda.synchronize()
    fold = int(pad_mode == "reflect")
    assert (conv_ops.launches, conv_ops.dgrad_launches, conv_ops.dgrad_fold_launches,
            conv_ops.wgrad_launches) == (before[0] + 1, before[1] + 1, before[2] + fold,
                                         before[3] + 1)
    dx = conv_ops.conv3d_dgrad_plain(gy.float(), w.detach(), x.shape, s, pads, pad_mode)
    dw = conv_ops.conv3d_wgrad_plain(x.detach().float(), gy.float(), w.shape, s, pads, pad_mode)
    assert _rel_err(x.grad, dx) <= 2e-2 and _rel_err(w.grad, dw) <= 2e-2


def test_tap_chunks_refuse_what_they_do_not_take(cuda):
    """The head's tap-chunk plans forced on shapes route 2 does not take (Co *
    kz above 8, a stride other than 1, float32) raise and launch nothing:
    no fallback to another body."""
    bf16 = torch.bfloat16
    x, w, _, gy, pads = _tap_chunk_inputs(cuda, bf16, 32, 1, 7, (9, 10, 11), 1)
    fwd = conv_ops.conv_plan("fwd", 32, 1, (7, 7, 7), (1, 1, 1), (9, 10, 11), bf16, 1)
    wgrad = conv_ops.conv_plan("wgrad", 32, 1, (7, 7, 7), (1, 1, 1), (9, 10, 11), bf16, 1)
    assert fwd.tap_chunks == wgrad.tap_chunks == 7
    lo = [3, 3, 3]
    before = (conv_ops.launches, conv_ops.wgrad_launches)
    with torch.inference_mode():
        with pytest.raises(ValueError):  # Co * kz = 14
            conv_ops._launch_fwd(x, w.repeat(2, 1, 1, 1, 1), None, (1, 1, 1), lo, True,
                                 [9, 10, 11], "conv3d", plan=fwd)
        with pytest.raises(ValueError):  # stride 2
            conv_ops._launch_fwd(x, w, None, (2, 2, 2), lo, True, [5, 5, 6], "conv3d", plan=fwd)
        with pytest.raises(ValueError):  # float32
            conv_ops._launch_fwd(x.float(), w, None, (1, 1, 1), lo, True, [9, 10, 11],
                                 "conv3d", plan=fwd)
        with pytest.raises(ValueError):  # stride 2
            conv_ops._conv3d_wgrad_cuda(x, gy[:, :, :5, :5, :6].contiguous(), w.shape,
                                        (2, 2, 2), pads, "reflect", plan=wgrad)
        with pytest.raises(ValueError):  # float32
            conv_ops._conv3d_wgrad_cuda(x.float(), gy.float(), w.shape, (1, 1, 1), pads,
                                        "reflect", plan=wgrad)
    torch.cuda.synchronize()
    assert (conv_ops.launches, conv_ops.wgrad_launches) == before


# K1's route 3 (one input channel, the (dx, dy) pairs on K) and K2 above 64
# taps on K1's bodies (route 3 where g has one channel, route 2 where dx has
# Ci * kz <= 8): (ci, co, k, pad_mode, dims, batch, (K1 body, K2 body)). The
# ResNet's stem and head at batch 3 and 128^3 (batch 1 is OTHER_PATH_CONVS),
# Z = 130 against columns of 16 and 10 z, a Co of 40 (two tiles of 24), 20
# (one of 24), 8 (one n tile), and 5^3, 6^3 (36 pairs: three k-steps) and 8^3
# kernels with 'same' pads.
PAIR_CASES = [
    (1, 32, 7, "reflect", (128, 128, 128), 3, (3, 2)),
    (32, 1, 7, "reflect", (128, 128, 128), 3, (2, 3)),
    (1, 32, 7, "zeros", (20, 18, 130), 1, (3, 2)),
    (32, 1, 7, "reflect", (9, 10, 130), 2, (2, 3)),
    (1, 40, 7, "zeros", (9, 10, 11), 2, (3, 2)),
    (1, 8, 5, "reflect", (11, 9, 10), 1, (3, 2)),
    (16, 1, 5, "zeros", (20, 18, 22), 2, (2, 3)),
    (1, 20, 6, "reflect", (13, 7, 17), 2, (3, 2)),
    (24, 1, 8, "zeros", (9, 10, 11), 1, (2, 3)),
]


def _pair_inputs(cuda, ci, co, k, dims, batch, seed=13):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, ci, *dims, generator=g).to(cuda, torch.bfloat16)
    w = (torch.randn(co, ci, k, k, k, generator=g) * (2.0 / (ci * k ** 3)) ** 0.5).to(cuda)
    b = (torch.randn(co, generator=g) * 0.1).to(cuda)
    gy = torch.randn(batch, co, *dims, generator=g).to(cuda, torch.bfloat16)
    return x, w, b, gy, ((k // 2, k - 1 - k // 2),) * 3


@pytest.mark.parametrize("ci,co,k,pad_mode,dims,batch,bodies", PAIR_CASES)
def test_conv3d_343_tap_routes_match_plain(cuda, ci, co, k, pad_mode, dims, batch, bodies):
    """K1 and K2 in bfloat16 on the bodies conv_plan gives these shapes,
    each launched once (K2's fold once for a reflect pad), against the
    float32 plain versions within 2e-2 of max |y| and max |dx|; dx
    bit-identical in two runs (no atomics: every value is written once)."""
    x, w, b, gy, pads = _pair_inputs(cuda, ci, co, k, dims, batch)
    s, ks, bf16 = (1, 1, 1), (k,) * 3, torch.bfloat16
    fwd = conv_ops.conv_plan("fwd", ci, co, ks, s, dims, bf16, batch)
    dg = conv_ops.conv_plan("dgrad", ci, co, ks, s, dims, bf16, batch, in_dims=dims, pads=pads,
                            pad_mode=pad_mode)
    assert (fwd.body, dg.body) == bodies, (fwd, dg)
    names = ("launches", "pair_launches", "tap_chunk_launches", "dgrad_launches",
             "dgrad_tap_launches", "dgrad_fold_launches")
    before = [getattr(conv_ops, n) for n in names]
    with torch.inference_mode():
        y = conv3d(x, w, b, 1, pads, pad_mode)
        dx = conv_ops.conv3d_dgrad(gy, w, x.shape, s, pads, pad_mode)
        again = conv_ops.conv3d_dgrad(gy, w, x.shape, s, pads, pad_mode)
        want = conv3d_plain(x.float(), w, b, s, pads, pad_mode)
        dwant = conv_ops.conv3d_dgrad_plain(gy.float(), w, x.shape, s, pads, pad_mode)
    torch.cuda.synchronize()
    fold = 2 * int(pad_mode == "reflect")
    assert [getattr(conv_ops, n) - v for n, v in zip(names, before)] == \
        [1, int(fwd.body == 3), int(fwd.body == 2), 2, 2, fold]
    assert y.dtype == bf16 and _rel_err(y, want) <= 2e-2
    assert dx.dtype == bf16 and dx.shape == x.shape and _rel_err(dx, dwant) <= 2e-2
    assert torch.equal(dx, again)


def test_pair_routes_refuse_what_they_do_not_take(cuda):
    """Route 3's plans forced on shapes it does not take (two input
    channels, a stride other than 1, float32, a Co tile above 32; for K2 a g
    of two channels) and route 2's K2 plan on a dx with Ci * kz above 8 raise
    and launch nothing: no fallback to another body."""
    bf16, s = torch.bfloat16, (1, 1, 1)
    x, w, _, gy, pads = _pair_inputs(cuda, 1, 32, 7, (9, 10, 11), 1)
    fwd = conv_ops.conv_plan("fwd", 1, 32, (7, 7, 7), s, (9, 10, 11), bf16, 1)
    assert fwd.body == 3 and fwd.co_tile == 32
    kw = dict(in_dims=(9, 10, 11), pads=pads, pad_mode="reflect")
    head = conv_ops.conv_plan("dgrad", 32, 1, (7, 7, 7), s, (9, 10, 11), bf16, 1, **kw)
    stem = conv_ops.conv_plan("dgrad", 1, 32, (7, 7, 7), s, (9, 10, 11), bf16, 1, **kw)
    assert (head.body, stem.body) == (3, 2)
    lo = [3, 3, 3]
    names = ("launches", "dgrad_launches", "dgrad_fold_launches")
    before = [getattr(conv_ops, n) for n in names]
    with torch.inference_mode():
        with pytest.raises(ValueError):  # Ci = 2
            conv_ops._launch_fwd(x.repeat(1, 2, 1, 1, 1), w.repeat(1, 2, 1, 1, 1), None, s, lo,
                                 True, [9, 10, 11], "conv3d", plan=fwd)
        with pytest.raises(ValueError):  # stride 2
            conv_ops._launch_fwd(x, w, None, (2, 2, 2), lo, True, [5, 5, 6], "conv3d", plan=fwd)
        with pytest.raises(ValueError):  # float32
            conv_ops._launch_fwd(x.float(), w, None, s, lo, True, [9, 10, 11], "conv3d",
                                 plan=fwd)
        wide = dataclasses.replace(fwd, co_tile=40)
        with pytest.raises(ValueError):  # a Co tile of 40
            conv_ops._launch_fwd(x, w.repeat(2, 1, 1, 1, 1)[:40], None, s, lo, True,
                                 [9, 10, 11], "conv3d", plan=wide)
        g32 = torch.randn(1, 32, 9, 10, 11, device=cuda).to(bf16)
        with pytest.raises(ValueError):  # route 3 on a g of two channels
            conv_ops._conv3d_dgrad_cuda(g32[:, :2].contiguous(), w.new_ones(2, 32, 7, 7, 7),
                                        (1, 32, 9, 10, 11), s, pads, "reflect", plan=head)
        with pytest.raises(ValueError):  # route 2 on a dx of two channels: Ci * kz = 14
            conv_ops._conv3d_dgrad_cuda(g32, w.repeat(1, 2, 1, 1, 1), (1, 2, 9, 10, 11), s, pads,
                                        "reflect", plan=stem)
    torch.cuda.synchronize()
    assert [getattr(conv_ops, n) for n in names] == before
