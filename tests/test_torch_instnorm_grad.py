"""The port's InstanceNorm+act gradients (the autograd Function on the CPU,
which takes ``instance_norm_act_bwd_plain``) against ``jax.vjp`` of the
Pallas ``instance_norm_act`` in interpret mode (its backward is the TPU
kernels ``bwd_reduce_sums`` and ``bwd_dx``).

Inputs and the cotangent come from numpy in float32; JAX runs on
(B, X, C, Y, Z), the port on (B, C, X, Y, Z). Tolerances: dx atol 1e-5 (f32,
sums of 1024 voxels in another order); dgamma and dbeta atol 1e-4 (sums of
2 x 1024 products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vangan_tpu.ops.pallas import instnorm as IN
from vangan_torch.ops import instnorm as in_ops
from vangan_torch.ops.instnorm import instance_norm_act, instance_norm_act_bwd_plain


@pytest.mark.parametrize("act", ["none", "relu", "leaky_relu"])
def test_instnorm_grads_match_jax_fused_kernel(rng, act):
    x = (rng.normal(size=(2, 8, 5, 8, 16)) * 3 + 1).astype(np.float32)  # NXCYZ
    gamma = (rng.normal(size=(5,)) * 0.5 + 1).astype(np.float32)
    beta = (rng.normal(size=(5,)) * 0.2).astype(np.float32)
    gy = rng.normal(size=x.shape).astype(np.float32)
    with IN.force_interpret():
        _, vjp = jax.vjp(lambda a, g_, b_: IN.instance_norm_act(a, g_, b_, 1e-3, act, 0.2),
                         jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
        want = [np.asarray(t) for t in vjp(jnp.asarray(gy))]
    xt = torch.from_numpy(x.transpose(0, 2, 1, 3, 4).copy()).requires_grad_()
    gt = torch.from_numpy(gamma).requires_grad_()
    bt = torch.from_numpy(beta).requires_grad_()
    before = (in_ops.launches, in_ops.bwd_launches)
    instance_norm_act(xt, gt, bt, 1e-3, act, 0.2).backward(
        torch.from_numpy(gy.transpose(0, 2, 1, 3, 4).copy()))
    assert (in_ops.launches, in_ops.bwd_launches) == before  # CPU: the plain versions
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 1, 3, 4), want[0], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(gt.grad.numpy(), want[1], atol=1e-4, rtol=0)
    np.testing.assert_allclose(bt.grad.numpy(), want[2], atol=1e-4, rtol=0)


@pytest.mark.parametrize("act", ["none", "relu", "leaky_relu"])
def test_plain_backward_matches_autograd_of_plain_forward(rng, act):
    """instance_norm_act_bwd_plain is the vjp of instance_norm_act_plain
    (odd sizes, C = 1 and 3, gamma with a zero), atol 1e-5."""
    for c in (1, 3):
        x = torch.from_numpy((rng.normal(size=(2, c, 5, 7, 9)) * 2 - 1).astype(np.float32))
        gamma = torch.from_numpy((rng.normal(size=(c,)) + 1).astype(np.float32))
        gamma[0] = 0.0
        beta = torch.from_numpy(rng.normal(size=(c,)).astype(np.float32))
        gy = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
        leaves = [t.clone().requires_grad_() for t in (x, gamma, beta)]
        in_ops.instance_norm_act_plain(*leaves, 1e-3, act, 0.2).backward(gy)
        got = instance_norm_act_bwd_plain(x, gy, gamma, beta, 1e-3, act, 0.2)
        for g, leaf in zip(got, leaves):
            np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(), atol=1e-5, rtol=0)
