"""Soft morphology for the clDice loss, in plain torch.

Counterpart of ``vangan_tpu.ops.morphology`` (the reference's
clDice_func.py:8-80) for 3-D channels-last ``(B, X, Y, Z, C)`` volumes and
2-D ``(B, H, W, C)`` images (the DIMENSIONS=2 mode), dispatched on rank as
there: the 3-D erosion is the min of the (3,3,1), (3,1,3) and (1,3,3)
windows, the 2-D one of (3,1) and (1,3) only (clDice_func.py:18-26), so a
2-D image is not a depth-1 volume here (the (3,3,1) window would make its
erosion the full 3x3 min). The min-pools are ``-max_pool(-x)``; max-pooling
pads with -inf, so
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

# the erosion's windows by rank (clDice_func.py:18-26): over (X, Y, Z) / (H, W)
_ERODE_WINDOWS = {3: ((3, 3, 1), (3, 1, 3), (1, 3, 3)), 2: ((3, 1), (1, 3))}
_MAX_POOL = {3: F.max_pool3d, 2: F.max_pool2d}


def _min_pool(v: torch.Tensor, window) -> torch.Tensor:
    return -_MAX_POOL[len(window)](-v, window, stride=1,
                                   padding=tuple(k // 2 for k in window))


def _erode(v: torch.Tensor) -> torch.Tensor:
    """soft_erode on (N, C, X, Y, Z) or (N, C, H, W)."""
    pools = [_min_pool(v, w) for w in _ERODE_WINDOWS[v.dim() - 2]]
    out = pools[0]
    for p in pools[1:]:
        out = torch.minimum(out, p)
    return out


def _dilate(v: torch.Tensor) -> torch.Tensor:
    """soft_dilate (3^3 or 3x3 max-pool) on (N, C, X, Y, Z) or (N, C, H, W)."""
    return _MAX_POOL[v.dim() - 2](v, 3, stride=1, padding=1)


def _channels_first(img: torch.Tensor) -> torch.Tensor:
    if img.dim() not in (4, 5):
        raise ValueError(f"expected (B, X, Y, Z, C) or (B, H, W, C), got shape "
                         f"{tuple(img.shape)}")
    return img.movedim(-1, 1)


def soft_erode(img: torch.Tensor) -> torch.Tensor:
    """Min of the (3,3,1), (3,1,3), (1,3,3) min-pools, in 2-D of the (3,1)
    and (1,3) ones (clDice_func.py:8-26)."""
    return _erode(_channels_first(img)).movedim(1, -1)


def soft_dilate(img: torch.Tensor) -> torch.Tensor:
    """3^3 (in 2-D 3x3) max-pool (clDice_func.py:29-42)."""
    return _dilate(_channels_first(img)).movedim(1, -1)


def soft_open(img: torch.Tensor) -> torch.Tensor:
    """Erosion followed by dilation (clDice_func.py:45-57)."""
    return soft_dilate(soft_erode(img))


def soft_skel(img: torch.Tensor, iters: int) -> torch.Tensor:
    """Soft skeleton of a (B, X, Y, Z, C) volume or a (B, H, W, C) image
    (clDice_func.py:60-80)."""
    v = _channels_first(img)
    skel = None
    for _ in range(iters + 1):
        e = _erode(v)
        delta = torch.relu(v - _dilate(e))
        skel = delta if skel is None else skel + torch.relu(delta - skel * delta)
        v = e
    return skel.movedim(1, -1)
