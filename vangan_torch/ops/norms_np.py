"""The numpy normalisations of ``vangan_torch.ops.norms`` (the reference's
utils.py), for the host-side preprocessing of raw TIFFs.

This module imports numpy only, so the worker processes that
``vangan_torch.data.preprocess`` spawns start without importing torch.
"""

from __future__ import annotations

import numpy as np


def min_max_norm_np(data: np.ndarray) -> np.ndarray:
    """Min-max normalise a numpy array to [0, 1] (utils.py:10-24); a constant
    array raises."""
    dmin = np.min(data)
    dmax = np.max(data)
    if (dmax - dmin) == 0:
        raise ValueError("Cannot perform min-max normalization when max and min are equal.")
    return (data - dmin) / (dmax - dmin)


def z_score_norm(data: np.ndarray) -> np.ndarray:
    """Z-score normalise a numpy array; mean-centre only if std == 0 (utils.py:68-83)."""
    dstd = np.std(data)
    if dstd > 0.0:
        return (data - np.mean(data)) / dstd
    return data - np.mean(data)


def threshold_outliers(image_volume: np.ndarray, threshold: float = 6) -> np.ndarray:
    """Clip voxels beyond a z-score threshold to the extreme inlier values (utils.py:108-133)."""
    mean_intensity = np.mean(image_volume)
    std_intensity = np.std(image_volume)
    z_scores = np.abs((image_volume - mean_intensity) / std_intensity)
    upper_limit = np.max(image_volume[z_scores <= threshold])
    lower_limit = np.min(image_volume[z_scores <= threshold])
    return np.clip(image_volume, a_min=lower_limit, a_max=upper_limit)
