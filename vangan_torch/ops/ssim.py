"""3-D (and 2-D) SSIM loss map, in plain torch.

Counterpart of ``vangan_tpu.ops.ssim.ssim3d_loss_map`` (the reference's
loss_functions.py:87-117): a separable 3-tap Gaussian (σ 1.5) on the
reference's grid ``[-1, 0, 1]``, zero SAME padding, computed in float32,
k1 = 0.01, k2 = 0.03; returns the per-voxel ``1 - SSIM`` map. The blur is
shifted adds along each spatial axis, in the JAX package's order: X, Y, Z
of a ``(B, X, Y, Z, C)`` volume, H and W of a ``(B, H, W, C)`` image (the
DIMENSIONS=2 mode). A 2-D image is never blurred as a depth-1 volume: on a
size-1 axis the zero-padded blur would scale every value by the centre tap.
"""

from __future__ import annotations

import numpy as np
import torch


def _gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    """1-D Gaussian taps summing to 1 on the grid ``range(-size // 2 + 1,
    size // 2 + 1)``: (-3) // 2 = -2 gives [-1, 0, 1] for size 3."""
    grid = np.arange((-size) // 2 + 1, size // 2 + 1, dtype=np.float32)
    g = np.exp(-0.5 * (grid / sigma) ** 2) / (sigma * np.sqrt(2.0 * np.pi))
    return (g / g.sum()).astype(np.float32)


def _blur_axis(x: torch.Tensor, taps: np.ndarray, axis: int) -> torch.Tensor:
    """Zero-padded SAME FIR along ``axis``: out[i] = sum_t taps[t] x[i + t - r]."""
    r = len(taps) // 2
    n = x.shape[axis]
    acc = torch.zeros_like(x)
    for t, w in enumerate(taps):
        off = t - r
        m = n - abs(off)
        if m > 0:
            acc.narrow(axis, max(0, -off), m).add_(x.narrow(axis, max(0, off), m) * float(w))
    return acc


def _blur3d(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Separable blur over the spatial axes of a channels-last tensor:
    (B, X, Y, Z, C) or (B, H, W, C)."""
    for axis in range(1, x.dim() - 1):
        x = _blur_axis(x, taps, axis)
    return x


def ssim3d_loss_map(y_true: torch.Tensor, y_pred: torch.Tensor, max_val: float = 1.0,
                    filter_size: int = 3, filter_sigma: float = 1.5, k1: float = 0.01,
                    k2: float = 0.03) -> torch.Tensor:
    """Per-voxel ``1 - SSIM`` between two (B, X, Y, Z, C) tensors, or per
    pixel between two (B, H, W, C) images."""
    taps = _gaussian_kernel(filter_size, filter_sigma)
    y_true = y_true.float()
    y_pred = y_pred.float()

    mu_true = _blur3d(y_true, taps)
    mu_pred = _blur3d(y_pred, taps)
    mu_true_sq = mu_true ** 2
    mu_pred_sq = mu_pred ** 2
    mu_true_pred = mu_true * mu_pred

    sigma_true_sq = _blur3d(y_true ** 2, taps) - mu_true_sq
    sigma_pred_sq = _blur3d(y_pred ** 2, taps) - mu_pred_sq
    sigma_true_pred = _blur3d(y_true * y_pred, taps) - mu_true_pred

    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    ssim_map = (2 * mu_true_pred + c1) * (2 * sigma_true_pred + c2) / (
        (mu_true_sq + mu_pred_sq + c1) * (sigma_true_sq + sigma_pred_sq + c2))
    return 1.0 - ssim_map
