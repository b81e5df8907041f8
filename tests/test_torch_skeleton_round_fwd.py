"""The forward kernel's decomposition (``skeleton.round_fwd_plain``: separable
min/max passes with the kernel's boundary fills) chained over the rounds,
against the plain skeleton and against the JAX package's.

Seeded numpy inputs at odd shapes (a dimension of 1, B = 1 and 3) on three
kinds of data: binary with structures on every face, distinct values (a
permutation), and continuous uniform values. Tolerances: against
``morphology.soft_skel`` and its erosion, max |diff| == 0 on all three (min
and max are exact and order-free, and both sides round every other op on its
own); against ``vangan_tpu.ops.morphology``, max |diff| == 0 for the erosion
on all three and for the skeleton on binary data, and within 2 ulp for the
skeleton on the other two, because XLA's CPU build contracts
``skel + relu(delta - skel * delta)`` into an FMA (as
``tests/test_torch_skeleton.py`` states).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vangan_tpu.ops import morphology as jax_morphology
from vangan_torch.ops import morphology, skeleton

SHAPES = [(1, 9, 17, 5), (3, 12, 7, 33), (2, 1, 6, 29), (1, 30, 19, 1)]
KINDS = ["binary", "distinct", "continuous"]


def _data(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "binary":
        v = (rng.uniform(size=shape) > 0.7).astype(np.float32)
        v[:, 0] = 1.0
        v[:, :, -1] = 1.0
        v[:, :, :, 0] = 1.0
        return v
    if kind == "distinct":
        n = int(np.prod(shape))
        return (rng.permutation(n).reshape(shape) / n).astype(np.float32)
    return rng.uniform(size=shape).astype(np.float32)


def _chain(x, iters):
    """(final skel, [e of each round], [skel of each round]) by round_fwd_plain."""
    v, skel, es, skels = torch.from_numpy(x), None, [], []
    for _ in range(iters + 1):
        skel, v = skeleton.round_fwd_plain(v, skel)
        es.append(v)
        skels.append(skel)
    return skel, es, skels


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("iters", [0, 1, 4])
def test_rounds_match_plain_skeleton(kind, shape, iters):
    x = _data(kind, shape, iters)
    got, es, skels = _chain(x, iters)
    want = morphology.soft_skel(torch.from_numpy(x)[..., None], iters)[..., 0]
    assert got.shape == want.shape
    assert float((got - want).abs().max()) == 0.0
    # round by round: e against the plain erosion, skel against the plain update
    v, skel = torch.from_numpy(x), None
    for e, s in zip(es, skels):
        e_want = morphology._erode(v[:, None])[:, 0]
        delta = torch.relu(v - morphology._dilate(e_want[:, None])[:, 0])
        skel = delta if skel is None else skel + torch.relu(delta - skel * delta)
        assert float((e - e_want).abs().max()) == 0.0
        assert float((s - skel).abs().max()) == 0.0
        v = e_want


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_rounds_match_jax(kind, shape):
    iters = 4
    x = _data(kind, shape, 20 + len(kind))
    got, es, _ = _chain(x, iters)
    want = np.asarray(jax_morphology.soft_skel(jnp.asarray(x[..., None]), iters))[..., 0]
    if kind == "binary":
        assert np.abs(got.numpy() - want).max() == 0.0
    else:
        np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=2)
    v = jnp.asarray(x[..., None])
    for e in es:
        v = jax_morphology.soft_erode(v)
        assert np.abs(e.numpy() - np.asarray(v)[..., 0]).max() == 0.0


def test_round_fwd_plain_boundary_fills():
    """A single finite voxel: the erosion keeps it (out-of-volume +inf never
    wins), the dilation of e gives it back (out-of-volume -inf never wins), so
    delta is 0 and e equals img."""
    x = torch.full((1, 1, 1, 1), 0.25)
    skel, e = skeleton.round_fwd_plain(x, None)
    assert torch.equal(e, x) and torch.equal(skel, torch.zeros_like(x))
