"""Spatial padding of ``(B, C, X, Y, Z)`` tensors with ``jnp.pad`` semantics.

torch's ``F.pad(mode='reflect')`` refuses a pad as wide as the axis, which
``jnp.pad`` (and so the JAX package) accepts: a 3^3 reflect-padded conv at a
1-voxel level of a small U-Net. Reflect padding here is an index gather with
numpy's rule for any width. There is no 'symmetric' mode: the stitcher pads
its volume on the host with ``np.pad`` before the single upload.
``pad3d_grad`` is its gradient: the cotangent of the padded tensor folded back
onto the unpadded one, as ``jnp.pad``'s vjp folds it in the JAX package.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

Pad3 = Tuple[Tuple[int, int], Tuple[int, int], Tuple[int, int]]


def reflect_index(n: int, lo: int, hi: int, device=None) -> torch.Tensor:
    """Source index of each position of an axis of length ``n`` reflect-padded
    by ``(lo, hi)`` (numpy 'reflect': period 2(n-1), edges not repeated)."""
    i = torch.arange(-lo, n + hi, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i < n, i, period - i)


def pad3d(x: torch.Tensor, pads: Sequence[Tuple[int, int]], mode: str = "zeros") -> torch.Tensor:
    """Pad the last three axes of ``x`` by ``pads`` ((lo, hi) per axis),
    ``mode`` 'zeros' or 'reflect'."""
    if not any(lo or hi for lo, hi in pads):
        return x
    if mode == "zeros":
        (lx, hx), (ly, hy), (lz, hz) = pads
        return F.pad(x, (lz, hz, ly, hy, lx, hx))
    if mode != "reflect":
        raise ValueError(f"pad mode must be 'zeros' or 'reflect', got {mode!r}")
    for axis, (lo, hi) in zip((2, 3, 4), pads):
        if lo or hi:
            x = x.index_select(axis, reflect_index(x.shape[axis], lo, hi, x.device))
    return x


def pad3d_grad(dxp: torch.Tensor, pads: Sequence[Tuple[int, int]],
               mode: str = "zeros") -> torch.Tensor:
    """The gradient of ``pad3d``: the cotangent ``dxp`` of the padded tensor
    folded back onto the unpadded axes, as a view of ``dxp``. 'zeros' drops
    the pad; 'reflect' adds each padded position into the voxel it copies (the
    same index map), axis by axis, in place: each pad slab is added into the
    interior of ``dxp``, so ``dxp`` is consumed, and only the slabs and the
    planes they fold onto move. The sums run in position order (lo slab,
    interior, hi slab), the order of an ``index_add_`` over the whole axis."""
    if not any(lo or hi for lo, hi in pads):
        return dxp
    if mode == "zeros":
        (lx, hx), (ly, hy), (lz, hz) = pads
        X, Y, Z = dxp.shape[2:]
        return dxp[:, :, lx:X - hx, ly:Y - hy, lz:Z - hz]
    if mode != "reflect":
        raise ValueError(f"pad mode must be 'zeros' or 'reflect', got {mode!r}")
    for axis, (lo, hi) in zip((2, 3, 4), pads):
        if lo or hi:
            n = dxp.shape[axis] - lo - hi
            src = reflect_index(n, lo, hi)  # interior positions map to themselves
            inner = dxp.narrow(axis, lo, n)
            if lo:  # the planes the lo slab folds onto: (their lo sums) + interior
                a, b = int(src[:lo].min()), int(src[:lo].max()) + 1
                planes = inner.narrow(axis, a, b - a)
                planes.copy_(torch.zeros_like(planes).index_add_(
                    axis, (src[:lo] - a).to(dxp.device), dxp.narrow(axis, 0, lo)) + planes)
            if hi:
                inner.index_add_(axis, src[lo + n:].to(dxp.device), dxp.narrow(axis, lo + n, hi))
            dxp = inner
    return dxp
