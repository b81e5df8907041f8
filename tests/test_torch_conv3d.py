"""The port's conv3d (plain version, which serves CPU tensors) against the
JAX CXYZ conv: the Pallas kernel in interpret mode and its XLA reference.

Inputs come from numpy in float32; the JAX side runs on (B, X, C, Y, Z), the
port on (B, C, X, Y, Z), transposed in the test. Tolerance: atol
1e-5 * sqrt(fan_in) — float32 sums of fan_in products taken in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vangan_tpu.ops.pallas import conv3d as C
from vangan_torch.ops import conv3d as conv_ops
from vangan_torch.ops.conv3d import conv3d, norm_padding
from vangan_torch.ops.pad import pad3d

CASES = {
    "3x3_s1_reflect": ((3, 3, 3), (1, 1, 1), ((1, 1),) * 3, "reflect", 3, 2, True, (8, 10, 9)),
    "3x3_s2_reflect": ((3, 3, 3), (2, 2, 2), ((1, 1),) * 3, "reflect", 3, 4, False, (8, 10, 9)),
    "4x4_s2_zeros": ((4, 4, 4), (2, 2, 2), ((1, 1),) * 3, "zeros", 1, 4, False, (8, 10, 9)),
    "1x1_s1_same": ((1, 1, 1), (1, 1, 1), "same", "zeros", 4, 2, True, (8, 10, 9)),
    "1x1_s2_same": ((1, 1, 1), (2, 2, 2), "same", "zeros", 3, 2, False, (8, 10, 9)),
    "3x3_s2_same_odd_dims": ((3, 3, 3), (2, 2, 2), "same", "zeros", 2, 3, True, (9, 7, 11)),
}


def _run_both(rng, k, stride, padding, pad_mode, ci, co, bias_on, dims):
    x = rng.normal(size=(2, dims[0], ci, dims[1], dims[2])).astype(np.float32)  # NXCYZ
    w = (rng.normal(size=(*k, ci, co)) * 0.3).astype(np.float32)  # flax (kx,ky,kz,Ci,Co)
    b = rng.normal(size=(co,)).astype(np.float32) if bias_on else None
    jb = None if b is None else jnp.asarray(b)
    with C.force_interpret():
        pallas = np.asarray(C.conv3d_cxyz(jnp.asarray(x), jnp.asarray(w), jb, stride,
                                          padding, pad_mode))
    xla = np.asarray(C.conv3d_cxyz_reference(jnp.asarray(x), jnp.asarray(w), jb, stride,
                                             padding, pad_mode))
    got = conv3d(torch.from_numpy(x.transpose(0, 2, 1, 3, 4).copy()),
                 torch.from_numpy(w.transpose(4, 3, 0, 1, 2).copy()),
                 None if b is None else torch.from_numpy(b), stride, padding, pad_mode)
    return got.numpy().transpose(0, 2, 1, 3, 4), pallas, xla, ci * int(np.prod(k))


@pytest.mark.parametrize("case", sorted(CASES))
def test_conv3d_matches_jax(rng, case):
    before = conv_ops.launches
    got, pallas, xla, fan_in = _run_both(rng, *CASES[case])
    assert conv_ops.launches == before  # a CPU tensor takes the plain version
    assert got.shape == pallas.shape == xla.shape
    atol = 1e-5 * fan_in ** 0.5
    np.testing.assert_allclose(got, pallas, atol=atol, rtol=0)
    np.testing.assert_allclose(got, xla, atol=atol, rtol=0)


def test_reflect_pad_wider_than_axis_matches_jax(rng):
    """jnp.pad reflects any width (a 3^3 conv at a 1- or 2-voxel level of a
    small U-Net); torch's F.pad refuses a pad as wide as the axis."""
    k, stride, pads = (3, 3, 3), (1, 1, 1), ((2, 2), (1, 3), (2, 1))
    x = rng.normal(size=(1, 2, 2, 1, 3)).astype(np.float32)  # NXCYZ, X=2 Y=1 Z=3
    w = (rng.normal(size=(*k, 2, 3)) * 0.3).astype(np.float32)
    xla = np.asarray(C.conv3d_cxyz_reference(jnp.asarray(x), jnp.asarray(w), None, stride,
                                             pads, "reflect"))
    got = conv3d(torch.from_numpy(x.transpose(0, 2, 1, 3, 4).copy()),
                 torch.from_numpy(w.transpose(4, 3, 0, 1, 2).copy()), None, stride, pads,
                 "reflect").numpy().transpose(0, 2, 1, 3, 4)
    np.testing.assert_allclose(got, xla, atol=1e-5 * 54 ** 0.5, rtol=0)


@pytest.mark.parametrize("mode", ["reflect", "zeros"])
def test_pad3d_matches_numpy(rng, mode):
    x = rng.normal(size=(1, 2, 3, 1, 4)).astype(np.float32)
    pads = ((2, 3), (4, 1), (0, 5))
    want = np.pad(x, ((0, 0), (0, 0), *pads), mode="reflect" if mode == "reflect" else "constant")
    np.testing.assert_array_equal(pad3d(torch.from_numpy(x), pads, mode).numpy(), want)


@pytest.mark.parametrize("n", [7, 8, 9, 16, 33])
@pytest.mark.parametrize("k,s", [(1, 1), (1, 2), (3, 1), (3, 2), (4, 2), (7, 1)])
def test_norm_padding_matches_jax(n, k, s):
    dims = (n, n + 1, n + 2)
    for padding in ("same", "valid", ((1, 2), (0, 0), (3, 3))):
        assert norm_padding(padding, (k,) * 3, (s,) * 3, dims) == \
            C._norm_padding(padding, (k,) * 3, (s,) * 3, dims)
