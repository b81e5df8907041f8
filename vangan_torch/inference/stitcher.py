"""Sliding-window full-volume inference with overlap averaging, on the device.

Counterpart of ``vangan_tpu.inference.stitcher.stitch_subvolumes`` (the
reference's ``GanMonitor.stitch_subvolumes``, custom_callback.py:47-223):

- patch origins follow the reference's clamped walk, duplicate final origins
  included (``stitch_origins``);
- with ``complete=True`` the volume is padded by ``padFactor`` of each axis
  ('symmetric', on the host, before the single upload);
- ``blend='uniform'`` averages patches with a 10% border trim,
  ``blend='gaussian'`` weights them by a Gaussian window;
- the generator sees fixed-size batches, the last one padded by repeating its
  last patch; ``process_img`` min-maxes each patch to [-1, 1] first;
- predictions and coverage accumulate in float32 on the device; a duplicate
  origin is run once and added with its multiplicity; one download at the end;
- a voxel no patch covers would be 0/0 = NaN, as in the reference; with
  stride <= patch such voxels lie only in the margin, which is cropped
  before the division; the result is ``255 * min_max_norm`` (float32 with
  ``complete=True``, else uint8).
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vangan_torch.data.preprocess import write_tiff
from vangan_torch.device import resolve_device


def _axis_origins(length: int, k: int, stride: int) -> List[int]:
    """The reference's clamped origin walk for one axis (custom_callback.py:
    127-190): dim_out = floor((L-k)/s) + 1 steps plus one, each start
    clamped to L-k, so the final origin may repeat."""
    dim_out = int(np.floor((length - k) / stride + 1))
    origins = []
    start = 0
    for _ in range(dim_out + 1):
        if start > length - k:
            start = length - k
        origins.append(start)
        start += stride
    return origins


def stitch_origins(shape: Sequence[int], subvol: Sequence[int], stride: Sequence[int]):
    """All (x, y, z) patch origins in reference walk order."""
    ox = _axis_origins(shape[0], subvol[0], stride[0])
    oy = _axis_origins(shape[1], subvol[1], stride[1])
    oz = _axis_origins(shape[2], subvol[2], stride[2])
    return [(i, j, k) for i in ox for j in oy for k in oz]


def gaussian_window(shape: Sequence[int], sigma_scale: float = 0.125) -> np.ndarray:
    """Separable Gaussian patch weights (sigma = sigma_scale * dim), floored at
    1e-3, shape (*shape, 1)."""
    ws = []
    for n in shape:
        x = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
        ws.append(np.exp(-0.5 * (x / (sigma_scale * n)) ** 2))
    w3 = ws[0][:, None, None] * ws[1][None, :, None] * ws[2][None, None, :]
    return np.maximum(w3, 1e-3).astype(np.float32)[..., None]


def min_max_norm_np(data: np.ndarray) -> np.ndarray:
    """Min-max normalise to [0, 1] (utils.py:10-24); raises on a constant array."""
    dmin, dmax = np.min(data), np.max(data)
    if (dmax - dmin) == 0:
        raise ValueError("Cannot perform min-max normalization when max and min are equal.")
    return (data - dmin) / (dmax - dmin)


def minmax_patches(p: torch.Tensor) -> torch.Tensor:
    """Min-max each patch of a (B, ...) batch to [-1, 1]; a constant patch -> 0."""
    dims = tuple(range(1, p.dim()))
    mn = p.amin(dim=dims, keepdim=True)
    rng = p.amax(dim=dims, keepdim=True) - mn
    safe = torch.where(rng == 0, torch.ones_like(rng), rng)
    return torch.where(rng == 0, torch.zeros_like(p), 2.0 * (p - mn) / safe - 1.0)


def stitch_subvolumes(
    gen: Callable[[torch.Tensor], torch.Tensor],
    img: np.ndarray,
    subvol_size: Sequence[int],
    epoch: int = -1,
    stride: Tuple[int, int, int] = (25, 25, 128),
    name: Optional[str] = None,
    output_path: Optional[str] = None,
    complete: bool = False,
    padFactor: float = 0.25,
    border_removal: bool = True,
    process_img: bool = False,
    model_path: str = ".",
    batch_size: int = 8,
    save: bool = True,
    blend: str = "uniform",
    device="cuda",
) -> np.ndarray:
    """Predict a full (X, Y, Z, C) volume by strided sliding-window stitching.

    ``gen`` maps a float32 batch ``(B, kx, ky, kz, C)`` on ``device`` (the
    card unless ``device="cpu"``; without CUDA a CUDA device raises) to
    predictions of the same shape. ``subvol_size`` follows the reference
    convention ``(GB, kx, ky, kz, C)``. Returns the stitched volume and, with
    ``save``, writes it as a (z, x, y, c) TIFF.
    """
    if blend not in ("uniform", "gaussian"):
        raise ValueError(f"blend must be 'uniform' or 'gaussian', got {blend!r}")
    img = np.asarray(img, dtype=np.float32)
    if img.ndim == 3:
        raise NotImplementedError("2-D stitching is not ported yet "
                                  "(ROADMAP.md Queue 1, other families and modes)")
    if img.ndim != 4:
        raise ValueError(f"expected an (X, Y, Z, C) volume, got shape {img.shape}")
    device = resolve_device(device)

    oimgshape = img.shape
    xspacing = yspacing = zspacing = 0
    if complete:
        xspacing = int(padFactor * img.shape[0])
        yspacing = int(padFactor * img.shape[1])
        if stride[2] != 1:
            zspacing = int(padFactor * img.shape[2])
        img = np.pad(img, ((xspacing, xspacing), (yspacing, yspacing), (zspacing, zspacing),
                           (0, 0)), "symmetric")
    H, W, D, C = img.shape
    kH, kW, kD = subvol_size[1], subvol_size[2], subvol_size[3]
    if kH > H or kW > W or kD > D:
        raise ValueError(f"patch {(kH, kW, kD)} is larger than the (padded) volume "
                         f"{(H, W, D)}")

    if not complete or not border_removal or blend == "gaussian":
        pH = pW = pD = 0
    else:
        pH, pW, pD = int(0.1 * kH), int(0.1 * kW), int(0.1 * kD)
        if kD == D:
            pD = 0

    origins = stitch_origins((H, W, D), (kH, kW, kD), stride)
    if complete:
        print(f"\tImage size (X,Y,Z,C): {oimgshape}")
        print(f"\tImage size w/ padding (X,Y,Z,C): {(H, W, D, C)}")
        print(f"\tSampling patch size (X,Y,Z,C): {(kH, kW, kD, 1)}")
        print(f"\tBorder artefact removal pixel width (X,Y,Z): ({pH}, {pW}, {pD})")
        print(f"\tStride pixel length (X,Y,Z): {tuple(stride)}")
        print(f"\tNo. of patches: {len(origins)}")
    # The generator is deterministic at inference, so a repeated origin runs
    # once and is added with its multiplicity (the same sum, fewer batches).
    uniq, mult = np.unique(np.asarray(origins, np.int64), axis=0, return_counts=True)

    with torch.inference_mode():
        vol = torch.from_numpy(img).to(device)  # the one upload
        pred = torch.zeros(img.shape, dtype=torch.float32, device=device)
        count = torch.zeros(img.shape, dtype=torch.float32, device=device)
        if blend == "gaussian":
            weight = torch.from_numpy(gaussian_window((kH, kW, kD))).to(device)
        else:
            weight = torch.ones((kH - 2 * pH, kW - 2 * pW, kD - 2 * pD, C), device=device)
        for g0 in range(0, len(uniq), batch_size):
            group = uniq[g0 : g0 + batch_size]
            patches = torch.stack([vol[i : i + kH, j : j + kW, k : k + kD]
                                   for i, j, k in group.tolist()])
            if process_img:
                patches = minmax_patches(patches)
            n_valid = len(group)
            if n_valid < batch_size:
                patches = torch.cat([patches, patches[-1:].expand(
                    batch_size - n_valid, *patches.shape[1:])])
            out = gen(patches)[:n_valid].float()
            out = out[:, pH : kH - pH, pW : kW - pW, pD : kD - pD]
            for (i, j, k), o, m in zip(group.tolist(), out, mult[g0 : g0 + batch_size]):
                sl = (slice(i + pH, i + kH - pH), slice(j + pW, j + kW - pW),
                      slice(k + pD, k + kD - pD))
                w = weight * float(m)
                pred[sl] += o * w
                count[sl] += w
        crop = (slice(xspacing, xspacing + oimgshape[0]),
                slice(yspacing, yspacing + oimgshape[1]),
                slice(zspacing, zspacing + oimgshape[2]))
        pred = (pred[crop] / count[crop]).cpu().numpy()  # the one download

    pred = 255 * min_max_norm_np(pred)
    if not complete:
        pred = pred.astype("uint8")
    if save:
        if not complete:
            out_file = os.path.join(model_path, f"e{epoch + 1}_{name}.tiff")
        else:
            out_file = os.path.join(output_path or ".", f"{name}.tiff")
        write_tiff(out_file, np.transpose(pred, (2, 0, 1, 3)))  # (z, x, y, c)
    return pred
