"""Normalisation primitives, counterparts of ``vangan_tpu.ops.norms`` (the
reference's utils.py).

The tensor functions serve the loss path and the data feed. The numpy ones
(``min_max_norm_np``, ``z_score_norm``, ``threshold_outliers``) serve the
host-side preprocessing of raw TIFFs; they live in ``ops.norms_np``, which
does not import torch, and are re-exported here.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from vangan_torch.ops.norms_np import (  # noqa: F401  (re-exported)
    min_max_norm_np,
    threshold_outliers,
    z_score_norm,
)


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


def z_score_norm_batch(data: torch.Tensor, epsilon: float = 1e-8) -> torch.Tensor:
    """Per-sample z-score over all non-batch dims (utils.py:89-105); the
    standard deviation is the biased one, as ``jnp.std``."""
    axes = tuple(range(1, data.dim()))
    mean = data.mean(dim=axes, keepdim=True)
    std = data.std(dim=axes, keepdim=True, correction=0)
    return (data - mean) / torch.where(std > epsilon, std, torch.full_like(std, epsilon))


def binarise(arr: torch.Tensor) -> torch.Tensor:
    """Map >= 0 to +1 and < 0 to -1 (utils.py:162-174)."""
    return torch.where(arr >= 0, torch.ones_like(arr), -torch.ones_like(arr))


def clip_images(images: torch.Tensor) -> torch.Tensor:
    """Clip to [-1, 1] (utils.py:191-201)."""
    return torch.clamp(images, -1.0, 1.0)


def minmax_to_pm1(tensor: torch.Tensor, axis=(1, 2, 3, 4), keepdims: bool = True) -> torch.Tensor:
    """Per-sample min-max normalisation to [-1, 1] (main.py:169-177)."""
    hi = tensor.amax(dim=tuple(axis), keepdim=keepdims)
    lo = tensor.amin(dim=tuple(axis), keepdim=keepdims)
    return 2.0 * (tensor - lo) / (hi - lo) - 1.0
