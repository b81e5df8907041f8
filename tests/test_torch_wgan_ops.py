"""Second derivatives of the port's kernel ops on the CPU, where each op's
Functions run their plain versions: the structure that runs the kernels on
the card is the same.

WGAN-GP differentiates the discriminator's input gradient, so the conv and
InstanceNorm backwards must themselves be differentiable through the port's
Functions, which launch K1-K3 and K5 on a CUDA tensor: a backward built of
bare launches would give results autograd treats as constants, and a CPU
test that only compares numbers would pass while the card dropped every
second-order term. Here: ``gradgradcheck`` in float64 (its default
tolerances) through the Functions, the ``grad_fn`` of each first-order
result, and the ops without a second derivative, which must raise.
"""

import pytest
import torch
from torch.autograd import gradcheck, gradgradcheck

from vangan_torch.ops import conv3d as conv_ops
from vangan_torch.ops import instnorm as in_ops
from vangan_torch.ops import morphology, skeleton
from vangan_torch.ops.conv3d import conv3d
from vangan_torch.ops.instnorm import instance_norm_act

F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """gradgradcheck runs thousands of tiny ops: one intra-op thread is
    faster on them, and leaves the cores to the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("stride,pad_mode,bias", [
    ((1, 1, 1), "zeros", True), ((2, 2, 2), "reflect", False), ((2, 1, 2), "reflect", True),
    ((2, 2, 2), "zeros", False)])
def test_conv3d_gradgradcheck_float64(stride, pad_mode, bias):
    g = _gen(0)
    x = torch.randn(2, 2, 4, 3, 5, dtype=F64, generator=g).requires_grad_()
    w = torch.randn(2, 2, 3, 2, 3, dtype=F64, generator=g).requires_grad_()
    b = torch.randn(2, dtype=F64, generator=g).requires_grad_() if bias else None
    pads = ((1, 1), (1, 0), (1, 2))

    def f(x, w, *b):
        return conv3d(x, w, b[0] if b else None, stride, pads, pad_mode)

    args = (x, w) + ((b,) if bias else ())
    assert gradcheck(f, args)
    assert gradgradcheck(f, args)


@pytest.mark.parametrize("fn", ["dgrad", "wgrad"])
def test_conv3d_gradient_functions_are_differentiable_again(fn):
    """The input and weight gradients as Functions of their own two inputs
    (a third derivative of the conv), at a strided reflect conv."""
    g = _gen(1)
    x_shape, w_shape = (1, 2, 5, 4, 5), (2, 2, 3, 3, 2)
    stride, pads = (2, 1, 2), ((1, 1), (1, 1), (0, 1))
    gy = torch.randn(1, 2, 3, 4, 3, dtype=F64, generator=g).requires_grad_()
    if fn == "dgrad":
        w = torch.randn(*w_shape, dtype=F64, generator=g).requires_grad_()
        args = (gy, w)
        f = lambda gy, w: conv_ops._Conv3dDgrad.apply(gy, w, x_shape, stride, pads,  # noqa: E731
                                                      "reflect")
    else:
        x = torch.randn(*x_shape, dtype=F64, generator=g).requires_grad_()
        args = (x, gy)
        f = lambda x, gy: conv_ops._Conv3dWgrad.apply(x, gy, w_shape, stride, pads,  # noqa: E731
                                                      "reflect")
    assert gradcheck(f, args)
    assert gradgradcheck(f, args)


@pytest.mark.parametrize("act", ["none", "relu", "leaky_relu"])
def test_instance_norm_act_gradgradcheck_float64(act):
    g = _gen(2)
    x = torch.randn(2, 3, 3, 4, 3, dtype=F64, generator=g).requires_grad_()
    gamma = (torch.rand(3, dtype=F64, generator=g) + 0.5).requires_grad_()
    beta = torch.randn(3, dtype=F64, generator=g).requires_grad_()

    def f(x, gamma, beta):
        return instance_norm_act(x, gamma, beta, 1e-3, act, 0.2)

    assert gradcheck(f, (x, gamma, beta))
    assert gradgradcheck(f, (x, gamma, beta))


def test_first_order_results_carry_the_ports_backward_functions():
    """Under ``create_graph`` the conv's dx and dw and the norm's dx come out of
    the port's Functions (K2, K3 and K5 on the card), not out of bare ops."""
    g = _gen(3)
    x = torch.randn(2, 2, 6, 6, 6, generator=g).requires_grad_()
    w = torch.randn(4, 2, 4, 4, 4, generator=g).requires_grad_()
    gamma = torch.ones(4, requires_grad=True)
    beta = torch.zeros(4, requires_grad=True)
    y = conv3d(x, w, None, 2, ((1, 1),) * 3, "reflect")
    dx, dw = torch.autograd.grad(y, (x, w), torch.randn(y.shape, generator=g),
                                 create_graph=True)
    assert type(dx.grad_fn) is conv_ops._Conv3dDgrad._backward_cls
    assert type(dw.grad_fn) is conv_ops._Conv3dWgrad._backward_cls
    z = instance_norm_act(y.detach().requires_grad_(), gamma, beta, 1e-3, "leaky_relu")
    dz, = torch.autograd.grad(z, z.grad_fn.next_functions[0][0].variable,
                              torch.randn(z.shape, generator=g), create_graph=True)
    assert type(dz.grad_fn) is in_ops._InstanceNormActBwd._backward_cls
    # and the second-order terms reach the parameters
    ddw, = torch.autograd.grad(dx.square().sum(), w)
    assert float(ddw.abs().max()) > 0


def test_instance_norm_third_derivative_raises():
    x = torch.randn(1, 2, 3, 3, 3, generator=_gen(4)).requires_grad_()
    gamma = torch.ones(2, requires_grad=True)
    beta = torch.zeros(2, requires_grad=True)
    y = instance_norm_act(x, gamma, beta, 1e-3, "relu")
    dx, = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    ddx, = torch.autograd.grad(dx.square().sum(), x, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable: it has no derivative"):
        torch.autograd.grad(ddx.sum(), x)


def test_soft_skeleton_second_derivative_raises(monkeypatch):
    """``_SoftSkel`` (the K6 forward and K7 backward) has no second
    derivative: taking one raises, here with its launches replaced by the
    plain versions so that the Function runs on the CPU."""
    def fwd(img, iters, keep):
        return morphology.soft_skel(img, iters), [img], [img]

    def bwd(imgs, skels, g, shape):
        return g * 0.5

    monkeypatch.setattr(skeleton, "_soft_skel_cuda", fwd)
    monkeypatch.setattr(skeleton, "_soft_skel_bwd_cuda", bwd)
    img = torch.rand(1, 6, 6, 6, 1, generator=_gen(5)).requires_grad_()
    skel = skeleton._SoftSkel.apply(img, 2)
    d_img, = torch.autograd.grad(skel.square().sum(), img, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable: it has no derivative"):
        torch.autograd.grad(d_img.sum(), img)
