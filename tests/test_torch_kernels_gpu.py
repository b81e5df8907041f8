"""The port's CUDA kernels against their plain torch versions, on the card.

These need an NVIDIA GPU and nvcc (marker ``gpu``); without a card each test
skips. They import torch and the port only, so they also run on a machine
without JAX: ``python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py``.
Shapes are small and odd on purpose (ragged blocks, non-cubic kernels,
unaligned planes); ``chip_smoke.py`` checks the predict path's own shapes.

Tolerances, relative to the plain output's max |y|: float32 (TF32 off in the
plain conv) 1e-4 — f32 sums in another order; bfloat16 2e-2 — the two sides
round the f32 result to bf16 at different points (about 2^-8 relative). The
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


def test_kernels_refuse_autograd(cuda):
    x = torch.randn(1, 2, 4, 4, 4, device=cuda, requires_grad=True)
    w = torch.randn(2, 2, 3, 3, 3, device=cuda)
    with pytest.raises(RuntimeError, match="forward only"):
        conv3d(x, w)
    with pytest.raises(RuntimeError, match="forward only"):
        in_ops.instance_norm_act(x, torch.ones(2, device=cuda), torch.zeros(2, device=cuda))
    with pytest.raises(RuntimeError, match="forward only"):
        skel_ops.soft_skel(torch.rand(1, 4, 4, 4, 1, device=cuda, requires_grad=True), 2)


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
