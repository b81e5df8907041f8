"""The port's soft skeleton (the plain version of the skeleton kernel) against
the JAX package's.

``vangan_torch.ops.morphology.soft_skel`` (and ``ops.skeleton.soft_skel``,
which takes it for a CPU tensor) against ``vangan_tpu.ops.morphology.soft_skel``
and against the Pallas skeleton kernel run in interpret mode, on seeded
numpy inputs with B=2 and odd X, Y, Z. Tolerances: bit-exact on binary data
(min and max are exact, and on {0, 1} the update is exact whatever the
rounding); within 2 ulp on continuous data, because XLA's CPU build contracts
``skel + relu(delta - skel * delta)`` into an FMA where torch rounds each op
(measured: one ulp at most).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vangan_tpu.ops import morphology as jax_morphology
from vangan_tpu.ops.pallas import skeleton as pallas_skeleton
from vangan_torch.ops import morphology, skeleton

SHAPES = [(2, 9, 17, 5, 1), (2, 12, 7, 33, 1)]


def _binary_faces(rng, shape):
    """Binary vessel-like data with structures on all six faces."""
    v = (rng.uniform(size=shape) > 0.7).astype(np.float32)
    for face in (v[:, 0], v[:, -1], v[:, :, 0], v[:, :, -1], v[:, :, :, 0], v[:, :, :, -1]):
        face[..., : face.shape[-2] // 2, :] = 1.0
    return v


def _jax(x, iters):
    return np.asarray(jax_morphology.soft_skel(jnp.asarray(x), iters))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("iters", [0, 1, 2, 5, 15])
def test_binary_bit_exact(shape, iters):
    x = _binary_faces(np.random.default_rng(iters), shape)
    got = morphology.soft_skel(torch.from_numpy(x), iters).numpy()
    assert got.shape == x.shape
    assert np.abs(got - _jax(x, iters)).max() == 0.0


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("iters", [0, 1, 2, 5, 15])
def test_continuous_within_two_ulp(shape, iters):
    x = np.random.default_rng(10 + iters).uniform(size=shape).astype(np.float32)
    got = morphology.soft_skel(torch.from_numpy(x), iters).numpy()
    np.testing.assert_array_max_ulp(got, _jax(x, iters), maxulp=2)


@pytest.mark.parametrize("binary", [True, False])
def test_against_pallas_kernel_interpret(binary):
    """The Pallas kernel in interpret mode, as tests/test_skeleton_fused.py runs it."""
    rng = np.random.default_rng(5)
    shape = (1, 16, 16, 128, 1)
    x = _binary_faces(rng, shape) if binary else rng.uniform(size=shape).astype(np.float32)
    with pallas_skeleton.force_interpret():
        want = np.asarray(pallas_skeleton.soft_skel_pallas(jnp.asarray(x), 5))
    got = morphology.soft_skel(torch.from_numpy(x), 5).numpy()
    if binary:
        assert np.abs(got - want).max() == 0.0
    else:
        np.testing.assert_array_max_ulp(got, want, maxulp=2)


def test_erode_dilate_open_match_jax():
    x = np.random.default_rng(6).uniform(size=SHAPES[1]).astype(np.float32)
    t = torch.from_numpy(x)
    for ours, theirs in ((morphology.soft_erode, jax_morphology.soft_erode),
                         (morphology.soft_dilate, jax_morphology.soft_dilate),
                         (morphology.soft_open, jax_morphology.soft_open)):
        assert np.array_equal(ours(t).numpy(), np.asarray(theirs(jnp.asarray(x))))


def test_dispatch_cpu_takes_plain_version():
    x = torch.from_numpy(np.random.default_rng(7).uniform(size=SHAPES[0]).astype(np.float32))
    before = skeleton.launches
    assert torch.equal(skeleton.soft_skel(x, 3), morphology.soft_skel(x, 3))
    assert skeleton.launches == before  # no kernel launch for a CPU tensor


def test_dispatch_other_device_raises():
    with pytest.raises(ValueError, match="no kernel for device meta"):
        skeleton.soft_skel(torch.empty(1, 4, 4, 4, 1, device="meta"), 2)
