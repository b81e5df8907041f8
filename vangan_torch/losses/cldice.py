"""Soft Dice + clDice topology-preserving loss (clDice_func.py:83-149).

Counterpart of ``vangan_tpu.losses.cldice``. Dice and clDice take global sums
over the whole tensor (the reference's ``K.sum`` with no axis), so the value
depends on the per-device batch grouping; ``soft_dice_cldice_grouped``
reproduces it by summing per group and averaging over groups.
"""

from __future__ import annotations

import torch

from vangan_torch.ops import morphology, skeleton


def _skel(img: torch.Tensor, iters: int, use_kernel: bool = False, needs_grad: bool = True
          ) -> torch.Tensor:
    """Soft skeleton; ``use_kernel`` takes ``ops.skeleton`` (the CUDA kernels,
    forward and backward, on a CUDA tensor), else the plain version.
    ``needs_grad=False`` marks data (ground truth): its gradient is stopped,
    and the kernel path keeps no residuals for it."""
    if not needs_grad:
        img = img.detach()
    if use_kernel:
        return skeleton.soft_skel(img, iters)
    return morphology.soft_skel(img, iters)


def _cldice_from_sums(pres_num, pres_den, rec_num, rec_den):
    smooth = 1.0
    pres = (pres_num + smooth) / (pres_den + smooth)
    rec = (rec_num + smooth) / (rec_den + smooth)
    return 1.0 - 2.0 * (pres * rec) / (pres + rec)


def soft_clDice_loss(y_true: torch.Tensor, y_pred: torch.Tensor, iter_: int = 50
                     ) -> torch.Tensor:
    """Soft centre-line Dice loss over the whole tensor (clDice_func.py:83-102),
    on the plain skeleton (its one caller, the cldice identity loss, runs off
    the main path)."""
    skel_pred = _skel(y_pred, iter_)
    skel_true = _skel(y_true, iter_, needs_grad=False)
    return _cldice_from_sums(torch.sum(skel_pred * y_true), torch.sum(skel_pred),
                             torch.sum(skel_true * y_pred), torch.sum(skel_true))


def soft_dice(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Soft Dice loss over the whole tensor (clDice_func.py:105-119)."""
    smooth = 1.0
    intersection = torch.sum(y_true * y_pred)
    return 1.0 - (2.0 * intersection + smooth) / (torch.sum(y_true) + torch.sum(y_pred) + smooth)


def soft_dice_cldice_loss(iters: int = 15, alpha: float = 0.5):
    """The (1 - alpha) * dice + alpha * clDice closure (clDice_func.py:122-149)."""

    def loss(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
        cl = soft_clDice_loss(y_true, y_pred, iters)
        return (1.0 - alpha) * soft_dice(y_true, y_pred) + alpha * cl

    return loss


def soft_dice_cldice_grouped(y_true: torch.Tensor, y_pred: torch.Tensor, groups: int,
                             iters: int = 15, alpha: float = 0.5,
                             use_kernel: bool = False) -> torch.Tensor:
    """Dice + clDice per group of ``batch / groups`` samples, averaged over
    groups: the mean of the per-replica losses the reference all-reduces
    (loss_functions.py:226). The whole batch is skeletonised at once."""
    if y_true.shape[0] % groups != 0:
        raise ValueError(f"batch {y_true.shape[0]} not divisible into {groups} groups")
    skel_pred = _skel(y_pred, iters, use_kernel)
    skel_true = _skel(y_true, iters, use_kernel, needs_grad=False)

    def gsum(t: torch.Tensor) -> torch.Tensor:
        return t.reshape(groups, -1).sum(dim=1)

    cl = _cldice_from_sums(gsum(skel_pred * y_true), gsum(skel_pred),
                           gsum(skel_true * y_pred), gsum(skel_true))
    smooth = 1.0
    dice = 1.0 - (2.0 * gsum(y_true * y_pred) + smooth) / (gsum(y_true) + gsum(y_pred) + smooth)
    return torch.mean((1.0 - alpha) * dice + alpha * cl)
