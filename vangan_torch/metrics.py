"""Segmentation evaluation metrics: Dice and clDice.

Counterpart of ``vangan_tpu.metrics``: the standard binary definitions (the
reference repo ships no quantitative evaluation, SURVEY.md §4), plus a
volume-level evaluation of stitched predictions. A volume's skeleton runs
on ``vangan_torch.ops.skeleton.soft_skel`` without a gradient: on the card
its kernel (``csrc/skeleton_fwd.cu``, one launch a round), on the CPU its
plain version. A 2-D image's (the DIMENSIONS=2 mode) runs
``morphology.soft_skel``'s 2-D erosion in torch ops on either device, as
the JAX package runs it in XLA. The sums are JAX's host sums (float64 for
Dice, numpy float32 sums of the skeleton products for clDice), so on binary
input, where the skeleton is exact, the scores equal the JAX package's to
the last bit.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from vangan_torch.device import resolve_device
from vangan_torch.ops import morphology, skeleton


def dice_coefficient(y_true: np.ndarray, y_pred: np.ndarray, smooth: float = 1.0) -> float:
    """Binary Dice coefficient (higher is better)."""
    t = np.asarray(y_true, dtype=np.float64).ravel()
    p = np.asarray(y_pred, dtype=np.float64).ravel()
    inter = float((t * p).sum())
    return (2.0 * inter + smooth) / (t.sum() + p.sum() + smooth)


def _skeletonize(binary: np.ndarray, iters: int = 15, device="cuda") -> np.ndarray:
    """Morphological skeleton via the soft skeleton on binary input: a bare
    (X, Y, Z) volume or (H, W) image, or a batched (B, X, Y, Z, C) or
    (B, H, W, C) one."""
    if binary.ndim not in (2, 3, 4, 5):
        raise ValueError(f"expected (X, Y, Z), (H, W) or their batched (B, ..., C), got shape "
                         f"{binary.shape}")
    wrap = binary.ndim in (2, 3)
    v = torch.from_numpy(np.asarray(binary, np.float32)).to(resolve_device(device))
    if wrap:
        v = v[None, ..., None]
    skel = skeleton.soft_skel if v.dim() == 5 else morphology.soft_skel
    with torch.no_grad():
        out = skel(v, iters).cpu().numpy()
    return out[0, ..., 0] if wrap else out


def cldice_metric(
    y_true: np.ndarray, y_pred: np.ndarray, iters: int = 15, smooth: float = 1.0,
    device="cuda",
) -> float:
    """Centre-line Dice score (Shit et al.): harmonic mean of topology
    precision (skeleton of prediction inside truth) and sensitivity
    (skeleton of truth inside prediction). Higher is better."""
    t = np.asarray(y_true, dtype=np.float32)
    p = np.asarray(y_pred, dtype=np.float32)
    skel_p = _skeletonize(p, iters, device)
    skel_t = _skeletonize(t, iters, device)
    tprec = (float((skel_p * t).sum()) + smooth) / (float(skel_p.sum()) + smooth)
    tsens = (float((skel_t * p).sum()) + smooth) / (float(skel_t.sum()) + smooth)
    return 2.0 * tprec * tsens / (tprec + tsens)


def binarise_prediction(pred: np.ndarray, threshold: Optional[float] = None) -> np.ndarray:
    """Binarise a stitched uint8/float prediction volume. Default threshold:
    midpoint of the value range (tanh output stitched to 0..255 -> 127.5)."""
    pred = np.asarray(pred, dtype=np.float32)
    if threshold is None:
        threshold = 0.5 * (float(pred.max()) + float(pred.min()))
    return (pred >= threshold).astype(np.float32)


def evaluate_segmentation(
    pred: np.ndarray, truth: np.ndarray, threshold: Optional[float] = None, iters: int = 15,
    device="cuda",
) -> Dict[str, float]:
    """Dice + clDice of a (stitched) prediction against a ground-truth volume,
    the skeletons on ``device`` (the card unless the caller asks for the CPU).

    ``truth`` may be in {-1, 1} (the preprocessed segmentation domain) or
    {0, 1}; it is mapped to {0, 1}.
    """
    t = np.asarray(truth, dtype=np.float32)
    t = (t > 0.5 * (t.max() + t.min())).astype(np.float32)
    p = binarise_prediction(pred, threshold)
    if p.shape != t.shape:
        raise ValueError(f"shape mismatch: pred {p.shape} vs truth {t.shape}")
    return {
        "dice": dice_coefficient(t, p),
        "cldice": cldice_metric(t, p, iters=iters, device=device),
    }
