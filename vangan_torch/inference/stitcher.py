"""Sliding-window full-volume inference with overlap averaging, on the device.

Counterpart of ``vangan_tpu.inference.stitcher.stitch_subvolumes`` (the
reference's ``GanMonitor.stitch_subvolumes``, custom_callback.py:47-223):

- patch origins follow the reference's clamped walk, duplicate final origins
  included (``stitch_origins``);
- with ``complete=True`` the volume is padded by ``padFactor`` of each axis
  ('symmetric', on the device, after the single upload of the unpadded
  volume: the margin never crosses the link, as in the JAX package);
- ``blend='uniform'`` averages patches with a 10% border trim,
  ``blend='gaussian'`` weights them by a Gaussian window;
- the generator sees fixed-size batches, the last one padded by repeating its
  last patch; ``process_img`` min-maxes each patch to [-1, 1] first;
- predictions and coverage accumulate in float32 on the device; a duplicate
  origin is run once and added with its multiplicity; one download at the end;
- a voxel no patch covers would be 0/0 = NaN, as in the reference; with
  stride <= patch such voxels lie only in the margin, which is cropped
  before the division; the result is ``255 * min_max_norm`` (float32 with
  ``complete=True``, else uint8), computed on the device before the single
  download and bit for bit numpy's;
- given a data-parallel ``group`` (the JAX package's mesh path), rank r of k
  runs the unique-origin batches r, r + k, ... into private accumulators,
  one sum over the ranks adds them, and rank 0 divides, returns and saves
  the volume (the other ranks return None).
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vangan_torch.data.preprocess import write_tiff
from vangan_torch.device import resolve_device
from vangan_torch.monitor.profiling import span
from vangan_torch.parallel import Group, is_main


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


def symmetric_pad(vol: torch.Tensor, pads: Sequence[int]) -> torch.Tensor:
    """``np.pad(vol, [(p, p) for p in pads] + [(0, 0)], "symmetric")`` of an
    (X, Y, Z, C) tensor, on its device: an ``index_select`` through each
    padded axis's index map, numpy's own symmetric pad of ``arange`` (a few
    hundred entries), so every width holds, those at or beyond the axis
    length too. An unpadded axis is not gathered. (One gather by three
    broadcast index tensors would be one pass, but on CUDA torch makes each
    index tensor as large as the output: 9 GB of int64 at 720^3.)"""
    for axis, p in enumerate(pads):
        if p:
            ix = np.pad(np.arange(vol.shape[axis]), p, "symmetric")
            vol = vol.index_select(axis, torch.from_numpy(ix).to(vol.device))
    return vol


def min_max_255_(pred: torch.Tensor) -> torch.Tensor:
    """``255 * min_max_norm_np(pred)`` (utils.py:10-24) in place on pred's
    device, bit for bit: numpy's float32 operations in numpy's order, the
    division a true one by a device scalar (a Python float would let torch
    multiply by its reciprocal). A constant volume raises, as numpy's does."""
    mn, mx = torch.aminmax(pred)
    rng = mx - mn
    if rng.item() == 0:
        raise ValueError("Cannot perform min-max normalization when max and min are equal.")
    return pred.sub_(mn).div_(rng).mul_(255)


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
    group: Optional[Group] = None,
) -> Optional[np.ndarray]:
    """Predict a full (X, Y, Z, C) volume, or (H, W, C) image, by strided
    sliding-window stitching.

    ``gen`` maps a float32 batch ``(B, kx, ky, kz, C)`` (of an image: ``(B,
    kH, kW, C)``) on ``device`` (the card unless ``device="cpu"``; without
    CUDA a CUDA device raises) to predictions of the same shape.
    ``subvol_size`` follows the reference convention ``(GB, kx, ky, kz, C)``;
    an image takes the 2-D ``(GB, kH, kW, C)``, and reads only the x and y
    of ``stride``. Returns the stitched volume and, with ``save``, writes it
    as a (z, x, y, c) TIFF, an image as an (h, w, c) one. With ``group``
    every rank of it calls this on the same volume (``device`` is the
    rank's): rank 0 returns and saves the volume, the others return None.

    The call is the span ``stitch``; its phases the spans ``stitch.upload``
    (the unpadded volume to the device), ``stitch.pad`` (the symmetric pad,
    on the device), one ``stitch.batch`` a generator call (gather, generator,
    accumulate), ``stitch.normalize`` (the division and the min-max, on the
    device), ``stitch.download`` (the copy to the host) and ``stitch.save``.
    """
    with span("stitch"):
        if blend not in ("uniform", "gaussian"):
            raise ValueError(f"blend must be 'uniform' or 'gaussian', got {blend!r}")
        img = np.ascontiguousarray(img, dtype=np.float32)
        two_d = img.ndim == 3
        if two_d:
            img = img[:, :, None, :]
            if len(subvol_size) == 4:  # (GB, kH, kW, C)
                subvol_size = (*subvol_size[:3], 1, subvol_size[3])
            stride = (stride[0], stride[1], 1)
            gen2 = gen
            gen = lambda p: gen2(p[:, :, :, 0])[:, :, :, None]  # noqa: E731
        if img.ndim != 4:
            raise ValueError(f"expected an (X, Y, Z, C) volume or an (H, W, C) image, got shape "
                             f"{img.shape}")
        device = resolve_device(device if group is None else group.device)

        oimgshape = img.shape
        xspacing = yspacing = zspacing = 0
        if complete:
            xspacing = int(padFactor * img.shape[0])
            yspacing = int(padFactor * img.shape[1])
            if stride[2] != 1:
                zspacing = int(padFactor * img.shape[2])
        pads = (xspacing, yspacing, zspacing)
        H, W, D = (n + 2 * p for n, p in zip(oimgshape, pads))
        C = oimgshape[3]
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
        if complete and is_main(group):
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
            with span("stitch.upload"):
                vol = torch.from_numpy(img).to(device)  # the one upload
            with span("stitch.pad"):  # each step frees its input before acc exists
                vol = symmetric_pad(vol, pads)
            acc = torch.zeros((2, H, W, D, C), dtype=torch.float32, device=device)
            pred, count = acc[0], acc[1]
            if blend == "gaussian":
                weight = torch.from_numpy(gaussian_window((kH, kW, kD))).to(device)
            else:
                weight = torch.ones((kH - 2 * pH, kW - 2 * pW, kD - 2 * pD, C), device=device)
            starts = range(0, len(uniq), batch_size)
            if group is not None:
                starts = starts[group.rank::group.world]
            for g0 in starts:
                with span("stitch.batch"):
                    batch = uniq[g0 : g0 + batch_size]
                    patches = torch.stack([vol[i : i + kH, j : j + kW, k : k + kD]
                                           for i, j, k in batch.tolist()])
                    if process_img:
                        patches = minmax_patches(patches)
                    n_valid = len(batch)
                    if n_valid < batch_size:
                        patches = torch.cat([patches, patches[-1:].expand(
                            batch_size - n_valid, *patches.shape[1:])])
                    out = gen(patches)[:n_valid].float()
                    out = out[:, pH : kH - pH, pW : kW - pW, pD : kD - pD]
                    for (i, j, k), o, m in zip(batch.tolist(), out,
                                               mult[g0 : g0 + batch_size]):
                        sl = (slice(i + pH, i + kH - pH), slice(j + pW, j + kW - pW),
                              slice(k + pD, k + kD - pD))
                        w = weight * float(m)
                        pred[sl] += o * w
                        count[sl] += w
            if group is not None:
                group.sum_(acc)
                if not is_main(group):
                    return None
            crop = (slice(xspacing, xspacing + oimgshape[0]),
                    slice(yspacing, yspacing + oimgshape[1]),
                    slice(zspacing, zspacing + oimgshape[2]))
            with span("stitch.normalize"):
                pred = min_max_255_(pred[crop] / count[crop])
                if not complete:
                    pred = pred.to(torch.uint8)
            with span("stitch.download"):
                pred = pred.cpu().numpy()  # the one download

        if two_d:
            pred = pred[:, :, 0, :]
        if save:
            if not complete:
                out_file = os.path.join(model_path, f"e{epoch + 1}_{name}.tiff")
            else:
                out_file = os.path.join(output_path or ".", f"{name}.tiff")
            # (z, x, y, c); an image (h, w, c) as one page
            with span("stitch.save"):
                write_tiff(out_file, pred[None] if two_d else np.transpose(pred, (2, 0, 1, 3)))
        return pred
