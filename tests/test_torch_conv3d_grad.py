"""The port's conv3d gradients (the autograd Function on the CPU, which takes
the plain versions ``conv3d_dgrad_plain`` / ``conv3d_wgrad_plain``) against
``jax.vjp`` of the JAX CXYZ conv: the Pallas K2/K3 kernels in interpret mode
and the XLA reference.

Inputs and the cotangent come from numpy in float32; the JAX side runs on
(B, X, C, Y, Z) with a flax (kx, ky, kz, Ci, Co) weight, the port on
(B, C, X, Y, Z) with a torch (Co, Ci, kx, ky, kz) weight, transposed in the
test. Tolerance: atol 1e-5 * sqrt(fan) — float32 sums of ``fan`` products
in another order (dx: Co * k^3 taps; dW: B * output voxels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_conv3d import CASES

from vangan_tpu.ops.pallas import conv3d as C
from vangan_torch.ops import conv3d as conv_ops
from vangan_torch.ops.conv3d import conv3d


def _jax_grads(fn, x, w, b, gy, stride, padding, pad_mode):
    args = (jnp.asarray(x), jnp.asarray(w)) + (() if b is None else (jnp.asarray(b),))

    def f(*a):
        return fn(a[0], a[1], a[2] if len(a) > 2 else None, stride, padding, pad_mode)

    _, vjp = jax.vjp(f, *args)
    return [np.asarray(t) for t in vjp(jnp.asarray(gy))]


@pytest.mark.parametrize("case", sorted(CASES))
def test_conv3d_grads_match_jax(rng, case):
    k, stride, padding, pad_mode, ci, co, bias_on, dims = CASES[case]
    x = rng.normal(size=(2, dims[0], ci, dims[1], dims[2])).astype(np.float32)  # NXCYZ
    w = (rng.normal(size=(*k, ci, co)) * 0.3).astype(np.float32)
    b = rng.normal(size=(co,)).astype(np.float32) if bias_on else None
    xt = torch.from_numpy(x.transpose(0, 2, 1, 3, 4).copy()).requires_grad_()
    wt = torch.from_numpy(w.transpose(4, 3, 0, 1, 2).copy()).requires_grad_()
    bt = None if b is None else torch.from_numpy(b).requires_grad_()
    y = conv3d(xt, wt, bt, stride, padding, pad_mode)
    gy = rng.normal(size=y.shape).astype(np.float32)  # (B, Co, Xo, Yo, Zo)
    before = (conv_ops.launches, conv_ops.dgrad_launches, conv_ops.wgrad_launches)
    y.backward(torch.from_numpy(gy))
    assert (conv_ops.launches, conv_ops.dgrad_launches, conv_ops.wgrad_launches) == before
    got = [xt.grad.numpy().transpose(0, 2, 1, 3, 4), wt.grad.numpy().transpose(2, 3, 4, 1, 0)]
    if bias_on:
        got.append(bt.grad.numpy())
    gy_j = gy.transpose(0, 2, 1, 3, 4)
    with C.force_interpret():
        pallas = _jax_grads(C.conv3d_cxyz, x, w, b, gy_j, stride, padding, pad_mode)
    xla = _jax_grads(C.conv3d_cxyz_reference, x, w, b, gy_j, stride, padding, pad_mode)
    fans = [co * int(np.prod(k)), int(np.prod(gy.shape[2:])) * 2, int(np.prod(gy.shape[2:])) * 2]
    for i, (g, fan) in enumerate(zip(got, fans)):
        assert g.shape == pallas[i].shape == xla[i].shape
        atol = 1e-5 * fan ** 0.5
        np.testing.assert_allclose(g, pallas[i], atol=atol, rtol=0, err_msg=f"grad {i} vs Pallas")
        np.testing.assert_allclose(g, xla[i], atol=atol, rtol=0, err_msg=f"grad {i} vs XLA")


@pytest.mark.parametrize("need", ["x", "w"])
def test_backward_computes_only_the_gradients_asked_for(rng, need):
    """A stem conv reads data: only dW is computed; a frozen conv: only dx."""
    x = torch.from_numpy(rng.normal(size=(1, 2, 5, 6, 7)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 2, 3, 3, 3)).astype(np.float32))
    (x if need == "x" else w).requires_grad_()
    conv3d(x, w, None, 1, ((1, 1),) * 3, "reflect").sum().backward()
    assert (x.grad is not None) == (need == "x") and (w.grad is not None) == (need == "w")


@pytest.mark.parametrize("mode", ["reflect", "zeros"])
def test_pad3d_grad_is_the_vjp_of_pad3d(rng, mode):
    """The fold-back against autograd of the index-map pad, wider than the axis."""
    from vangan_torch.ops.pad import pad3d, pad3d_grad

    x = torch.from_numpy(rng.normal(size=(1, 2, 3, 1, 4)).astype(np.float32)).requires_grad_()
    pads = ((2, 3), (4, 1), (0, 5))
    y = pad3d(x, pads, mode)
    g = torch.from_numpy(rng.normal(size=y.shape).astype(np.float32))
    y.backward(g)
    np.testing.assert_allclose(pad3d_grad(g, pads, mode).numpy(), x.grad.numpy(), atol=1e-6)
