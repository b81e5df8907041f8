"""Soft morphology for the clDice loss, in plain torch.

Counterpart of ``vangan_tpu.ops.morphology`` (the reference's
clDice_func.py:8-80) for 3-D channels-last ``(B, X, Y, Z, C)`` volumes. The
min-pools are ``-max_pool3d(-x)``; ``max_pool3d`` pads with -inf, so
out-of-volume voxels never win, which is the TF SAME pooling the reference
gets from ``reduce_window``. Min and max are exact, so these agree bit for bit
with the JAX functions wherever the JAX side rounds each op on its own.

``soft_skel`` is the plain version of the skeleton kernel
(``vangan_torch.ops.skeleton``), and computes what it computes: the
reference loop re-indexed as ``iters + 1`` uniform rounds with
``skel_{-1} = 0`` (as ``vangan_tpu/ops/pallas/skeleton.py`` does)::

    e     = erode(img)
    delta = relu(img - dilate(e))           # open(img) = dilate(erode(img))
    skel  = skel + relu(delta - skel * delta)   (round 0: skel = delta)
    img   = e

Every round erodes once: the reference's ``img = erode(img); open(img)``
erodes the same image twice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_ERODE_WINDOWS = ((3, 3, 1), (3, 1, 3), (1, 3, 3))  # over (X, Y, Z), clDice_func.py:23-26


def _min_pool(v: torch.Tensor, window) -> torch.Tensor:
    return -F.max_pool3d(-v, window, stride=1, padding=tuple(k // 2 for k in window))


def _erode(v: torch.Tensor) -> torch.Tensor:
    """soft_erode on (N, C, X, Y, Z)."""
    p1, p2, p3 = (_min_pool(v, w) for w in _ERODE_WINDOWS)
    return torch.minimum(torch.minimum(p1, p2), p3)


def _dilate(v: torch.Tensor) -> torch.Tensor:
    """soft_dilate (3^3 max-pool) on (N, C, X, Y, Z)."""
    return F.max_pool3d(v, 3, stride=1, padding=1)


def _channels_first(img: torch.Tensor) -> torch.Tensor:
    if img.dim() != 5:
        raise ValueError(f"expected (B, X, Y, Z, C), got shape {tuple(img.shape)}")
    return img.movedim(-1, 1)


def soft_erode(img: torch.Tensor) -> torch.Tensor:
    """Min of the (3,3,1), (3,1,3), (1,3,3) min-pools (clDice_func.py:8-26)."""
    return _erode(_channels_first(img)).movedim(1, -1)


def soft_dilate(img: torch.Tensor) -> torch.Tensor:
    """3^3 max-pool (clDice_func.py:29-42)."""
    return _dilate(_channels_first(img)).movedim(1, -1)


def soft_open(img: torch.Tensor) -> torch.Tensor:
    """Erosion followed by dilation (clDice_func.py:45-57)."""
    return soft_dilate(soft_erode(img))


def soft_skel(img: torch.Tensor, iters: int) -> torch.Tensor:
    """Soft skeleton of a (B, X, Y, Z, C) volume (clDice_func.py:60-80)."""
    v = _channels_first(img)
    skel = None
    for _ in range(iters + 1):
        e = _erode(v)
        delta = torch.relu(v - _dilate(e))
        skel = delta if skel is None else skel + torch.relu(delta - skel * delta)
        v = e
    return skel.movedim(1, -1)
