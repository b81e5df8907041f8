"""Normalisation primitives of the loss path.

Counterparts of the tensor functions of ``vangan_tpu.ops.norms`` (the
reference's utils.py); its numpy helpers belong to preprocessing, which is not
ported yet (ROADMAP.md Queue 1, preprocessing).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def min_max_norm(arr: torch.Tensor, axis: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Min-max normalise to [0, 1], over everything or per ``axis`` (utils.py:27-48).

    Like the reference, a constant slice gives NaN (0 / 0).
    """
    if axis is None:
        lo, hi = arr.min(), arr.max()
    else:
        lo = arr.amin(dim=tuple(axis), keepdim=True)
        hi = arr.amax(dim=tuple(axis), keepdim=True)
    return (arr - lo) / (hi - lo)


def rescale_arr(arr: torch.Tensor, alpha: float = -0.5, beta: float = 0.5) -> torch.Tensor:
    """(arr + alpha) / beta, zeros where beta == 0 (utils.py:51-65)."""
    if beta == 0:
        return torch.zeros_like(arr)
    return (arr + alpha) / beta


def minmax_to_pm1(tensor: torch.Tensor, axis=(1, 2, 3, 4), keepdims: bool = True) -> torch.Tensor:
    """Per-sample min-max normalisation to [-1, 1] (main.py:169-177)."""
    hi = tensor.amax(dim=tuple(axis), keepdim=keepdims)
    lo = tensor.amin(dim=tuple(axis), keepdim=keepdims)
    return 2.0 * (tensor - lo) / (hi - lo) - 1.0
