"""The gradient of the port's plain soft skeleton (autograd of
``morphology.soft_skel``, the plain version of the K6/K7 kernels) against
``jax.grad`` of the JAX package's: ``vangan_tpu.ops.morphology.soft_skel``
(XLA) and ``soft_skel_pallas`` (the Pallas forward and backward kernels) in
interpret mode with float32 residuals.

Shape (1, 8, 16, 128, 1) — the Pallas kernel needs Z % 128 == 0 and
Y % 16 == 0 — with 3 iterations, on seeded data with distinct values, where
every tie rule routes the gradient to the same input voxel (see
``csrc/skeleton_bwd.cu``). Tolerance: atol 1e-5 * max |g|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vangan_tpu.ops import morphology as jax_morphology
from vangan_tpu.ops.pallas import skeleton as pallas_skeleton
from vangan_torch.ops import morphology, skeleton

SHAPE = (1, 8, 16, 128, 1)
ITERS = 3


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    n = int(np.prod(SHAPE))
    x = (rng.permutation(n).reshape(SHAPE) / n).astype(np.float32)
    w = rng.normal(size=SHAPE).astype(np.float32)  # the loss is sum(w * skel)
    t = torch.from_numpy(x).requires_grad_()
    before = (skeleton.launches, skeleton.bwd_launches)
    (skeleton.soft_skel(t, ITERS) * torch.from_numpy(w)).sum().backward()
    assert (skeleton.launches, skeleton.bwd_launches) == before  # CPU: the plain version
    return x, w, t.grad.numpy()


def _jax_grad(fn, x, w):
    return np.asarray(jax.grad(lambda a: jnp.sum(jnp.asarray(w) * fn(a, ITERS)))(jnp.asarray(x)))


def test_skeleton_grad_matches_jax_morphology(data):
    x, w, got = data
    want = _jax_grad(jax_morphology.soft_skel, x, w)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_skeleton_grad_matches_pallas_kernel_interpret(data, monkeypatch):
    x, w, got = data
    monkeypatch.setenv("VANGAN_SKEL_RES_DTYPE", "float32")
    with pallas_skeleton.force_interpret():
        want = _jax_grad(pallas_skeleton.soft_skel_pallas, x, w)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_plain_skeleton_grad_is_finite_on_binary_data():
    """Binary data ties everywhere; the gradient stays finite and the
    ground-truth path (no gradient) builds no graph."""
    x = torch.from_numpy((np.random.default_rng(3).uniform(size=(2, 9, 7, 5, 1)) > 0.6)
                         .astype(np.float32)).requires_grad_()
    morphology.soft_skel(x, 2).sum().backward()
    assert torch.isfinite(x.grad).all()
    assert not skeleton.soft_skel(x.detach(), 2).requires_grad
