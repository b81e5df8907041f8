"""The soft-skeleton backward round as the fused kernel computes it
(``skeleton.round_bwd_plain``: tile by tile, with the kernel's halos and
its first-in-scan-order tie rule, in torch) against autograd of one uniform
round of ``morphology`` on the CPU, and, composed over the rounds, against
autograd of ``morphology.soft_skel`` and ``jax.grad`` of the JAX package's.

On distinct values every tie rule routes the gradient to the same input
voxel (see ``csrc/skeleton_bwd.cu``), so the two agree up to the order of
f32 sums: max |diff| <= 1e-5 * max |g|. Dims are odd and not multiples of
the tiles, so tiles are ragged and halos cross every face.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vangan_tpu.ops import morphology as jax_morphology
from vangan_torch.ops import morphology, skeleton

TILES = [skeleton.BWD_TILE, (8, 8, 32)]  # the kernel's, and another


def _round(img, skel_prev):
    """One uniform round on (B, X, Y, Z): (e, skel)."""
    v = img[:, None]
    e = morphology._erode(v)
    delta = torch.relu(v - morphology._dilate(e))
    if skel_prev is None:
        return e[:, 0], delta[:, 0]
    s = skel_prev[:, None]
    return e[:, 0], (s + torch.relu(delta - s * delta))[:, 0]


def _distinct(rng, shape):
    n = int(np.prod(shape))
    return torch.from_numpy((rng.permutation(n).reshape(shape) / n).astype(np.float32))


def _close(got, want):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * max(scale, 1e-30)


@pytest.mark.parametrize("tile", [*TILES, (2, 3, 4)])
@pytest.mark.parametrize("dims", [(9, 10, 33), (1, 5, 7), (17, 3, 2)])
@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_round_gather_matches_autograd(tile, dims, where):
    """Round 0 (no skel_prev), a middle round, and the last round (no
    d_e_next)."""
    rng = np.random.default_rng(len(where) * 100 + sum(dims) + sum(tile))
    shape = (2, *dims)
    img = _distinct(rng, shape).requires_grad_()
    skel_prev = None if where == "first" else _distinct(rng, shape).requires_grad_()
    d_e_next = None if where == "last" else torch.from_numpy(
        rng.normal(size=shape).astype(np.float32))
    d_skel = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    e, skel = _round(img, skel_prev)
    loss = (skel * d_skel).sum() + (0.0 if d_e_next is None else (e * d_e_next).sum())
    leaves = [img] if skel_prev is None else [img, skel_prev]
    want = torch.autograd.grad(loss, leaves)
    got_img, got_sp = skeleton.round_bwd_plain(img.detach(), e.detach(), None if skel_prev is None
                                               else skel_prev.detach(), d_e_next, d_skel, tile)
    _close(got_img, want[0])
    if skel_prev is None:
        assert got_sp is None
    else:
        _close(got_sp, want[1])


def _skeleton_grad_by_rounds(x, w, iters, tile):
    """dL/dx of sum(w * soft_skel(x)) from round_bwd_plain over the rounds in
    reverse, with the forward's kept volumes, as the kernel path runs it."""
    imgs, skels = [x], []
    with torch.no_grad():
        for t in range(iters + 1):
            e, skel = _round(imgs[-1], skels[-1] if skels else None)
            imgs.append(e)
            skels.append(skel)
    d_skel, d_img = w, None
    for t in reversed(range(iters + 1)):
        d_img, d_skel = skeleton.round_bwd_plain(
            imgs[t], imgs[t + 1], skels[t - 1] if t else None, d_img, d_skel, tile)
    return d_img


@pytest.mark.parametrize("tile", TILES)
def test_rounds_compose_to_the_skeleton_gradient(tile):
    """Over 3 iterations at an odd shape: against autograd of the plain
    skeleton and jax.grad of the JAX package's morphology.soft_skel."""
    rng = np.random.default_rng(21)
    shape = (2, 11, 9, 35)
    x, w = _distinct(rng, shape), torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    got = _skeleton_grad_by_rounds(x, w, 3, tile)
    xp = x[..., None].clone().requires_grad_()
    (morphology.soft_skel(xp, 3)[..., 0] * w).sum().backward()
    _close(got, xp.grad[..., 0])
    want = np.asarray(jax.grad(lambda a: jnp.sum(jnp.asarray(w.numpy()) * jax_morphology.soft_skel(
        a[..., None], 3)[..., 0]))(jnp.asarray(x.numpy())))
    _close(got, torch.from_numpy(want.copy()))


def test_round_gather_is_finite_on_binary_data():
    """Binary data ties everywhere: the gather takes the first extremum and
    stays finite."""
    rng = np.random.default_rng(8)
    shape = (1, 9, 10, 33)
    img = torch.from_numpy((rng.uniform(size=shape) > 0.6).astype(np.float32))
    skel_prev = torch.from_numpy((rng.uniform(size=shape) > 0.5).astype(np.float32))
    e, _ = _round(img, skel_prev)
    d = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    d_img, d_sp = skeleton.round_bwd_plain(img, e, skel_prev, d, d)
    assert torch.isfinite(d_img).all() and torch.isfinite(d_sp).all()
