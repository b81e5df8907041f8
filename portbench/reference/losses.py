"""The VAN-GAN losses in plain PyTorch (psweens/VAN-GAN ``loss_functions.py``
and ``clDice_func.py``), on channels-last (B, X, Y, Z, 1) float32 tensors, for
one device and a global batch ``gb`` (the reference's reduction contract:
per-sample means summed over the batch and divided by ``gb``; an
``axis=None`` mean times ``n_devices / gb``)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BCE_EPS = 1e-7


def per_sample_minmax(x: torch.Tensor) -> torch.Tensor:
    axes = tuple(range(1, x.dim()))
    lo = x.amin(dim=axes, keepdim=True)
    hi = x.amax(dim=axes, keepdim=True)
    return (x - lo) / (hi - lo)


def mean_global(x: torch.Tensor, gb: int) -> torch.Tensor:
    return x.mean(dim=tuple(range(1, x.dim()))).sum() / gb


def mean_overall(x: torch.Tensor, gb: int, n_devices: int = 1) -> torch.Tensor:
    return x.mean() * n_devices / gb


def bce_probs(y_true: torch.Tensor, y_prob: torch.Tensor) -> torch.Tensor:
    p = y_prob.clamp(BCE_EPS, 1.0 - BCE_EPS)
    return (-(y_true * p.log() + (1.0 - y_true) * (1.0 - p).log())).mean(dim=-1)


def _gauss_taps(size: int = 3, sigma: float = 1.5):
    grid = [i for i in range((-size) // 2 + 1, size // 2 + 1)]
    g = [math.exp(-0.5 * (i / sigma) ** 2) for i in grid]
    s = sum(g)
    return [v / s for v in g]


def _blur(x: torch.Tensor, taps) -> torch.Tensor:
    """Zero-padded separable 3-tap blur over X, Y, Z of (B, X, Y, Z, C)."""
    r = len(taps) // 2
    for axis in (1, 2, 3):
        n = x.shape[axis]
        acc = torch.zeros_like(x)
        for t, w in enumerate(taps):
            off = t - r
            m = n - abs(off)
            if m > 0:
                acc.narrow(axis, max(0, -off), m).add_(x.narrow(axis, max(0, off), m) * w)
        x = acc
    return x


def ssim_loss_map(a: torch.Tensor, b: torch.Tensor, k1: float = 0.01, k2: float = 0.03
                  ) -> torch.Tensor:
    """Per-voxel 1 - SSIM (3-tap Gaussian, sigma 1.5, max value 1)."""
    taps = _gauss_taps()
    mu_a, mu_b = _blur(a, taps), _blur(b, taps)
    s_aa = _blur(a * a, taps) - mu_a ** 2
    s_bb = _blur(b * b, taps) - mu_b ** 2
    s_ab = _blur(a * b, taps) - mu_a * mu_b
    c1, c2 = k1 ** 2, k2 ** 2
    ssim = ((2 * mu_a * mu_b + c1) * (2 * s_ab + c2)
            / ((mu_a ** 2 + mu_b ** 2 + c1) * (s_aa + s_bb + c2)))
    return 1.0 - ssim


def soft_skeleton(img: torch.Tensor, iters: int) -> torch.Tensor:
    """clDice's soft skeleton of (B, X, Y, Z, 1): erosion is the min of the
    (3,3,1), (3,1,3), (1,3,3) min-pools, dilation the 3^3 max-pool; run as
    ``iters + 1`` rounds of: e = erode(v); delta = relu(v - dilate(e));
    skel += relu(delta - skel * delta) (round 0: skel = delta); v = e."""
    v = img.movedim(-1, 1)

    def minpool(t, w):
        return -F.max_pool3d(-t, w, stride=1, padding=tuple(k // 2 for k in w))

    skel = None
    for _ in range(iters + 1):
        e = torch.minimum(torch.minimum(minpool(v, (3, 3, 1)), minpool(v, (3, 1, 3))),
                          minpool(v, (1, 3, 3)))
        delta = torch.relu(v - F.max_pool3d(e, 3, stride=1, padding=1))
        skel = delta if skel is None else skel + torch.relu(delta - skel * delta)
        v = e
    return skel.movedim(1, -1)


def dice_cldice(y_true: torch.Tensor, y_pred: torch.Tensor, groups: int, iters: int,
                alpha: float) -> torch.Tensor:
    """(1 - alpha) soft Dice + alpha soft clDice, each over its group of
    samples' whole volumes, averaged over the groups."""
    skel_pred = soft_skeleton(y_pred, iters)
    skel_true = soft_skeleton(y_true.detach(), iters)

    def gsum(t):
        return t.reshape(groups, -1).sum(dim=1)

    pres = (gsum(skel_pred * y_true) + 1.0) / (gsum(skel_pred) + 1.0)
    rec = (gsum(skel_true * y_pred) + 1.0) / (gsum(skel_true) + 1.0)
    cl = 1.0 - 2.0 * pres * rec / (pres + rec)
    dice = 1.0 - (2.0 * gsum(y_true * y_pred) + 1.0) / (gsum(y_true) + gsum(y_pred) + 1.0)
    return ((1.0 - alpha) * dice + alpha * cl).mean()


def cycle_losses(f: dict, gb: int, real_I, real_S, cycled_I, cycled_S):
    """(seg cycle BCE, seg Dice + clDice, imaging cycle MSE, SSIM
    reconstruction), each with its lambda."""
    groups = f.get("cldice_groups") or 1
    rs, cs = per_sample_minmax(real_S), per_sample_minmax(cycled_S)
    cycle_I = mean_overall(bce_probs(rs, cs), gb) * f["lambda_cycle"]
    seg = dice_cldice(rs, cs, groups, f["cldice_iters"], f["cldice_alpha"]) * f["lambda_topology"]
    cycle_S = mean_global((real_I - cycled_I) ** 2, gb) * f["lambda_cycle"]
    recon = (mean_overall(ssim_loss_map(per_sample_minmax(real_I), per_sample_minmax(cycled_I)),
                          gb) * f["lambda_reconstruction"])
    return cycle_I, seg, cycle_S, recon


def lsgan_generator(d_fake, gb):
    return mean_global((1.0 - d_fake) ** 2, gb)


def lsgan_discriminator(d_real, d_fake, gb):
    return 0.5 * (mean_global((1.0 - d_real) ** 2, gb) + mean_global(d_fake ** 2, gb))
