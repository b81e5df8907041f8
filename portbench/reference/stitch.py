"""Sliding-window stitching of a whole volume in plain NumPy and PyTorch
(VAN-GAN's ``GanMonitor.stitch_subvolumes`` with ``complete=True`` and a
Gaussian blend):

- the volume is padded by ``int(pad_factor * n)`` on each side of each axis,
  numpy 'symmetric';
- patch origins per axis: floor((L - k) / s) + 1 steps plus one, each start
  clamped to L - k (a repeated origin counts as often as it occurs);
- each patch's prediction is weighted by a separable Gaussian window
  (sigma k / 8 per axis, floored at 1e-3), summed, and divided by the summed
  weights;
- the padding is cropped and the result is 255 * min-max of the volume.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch


def origins(length: int, k: int, stride: int):
    out, start = [], 0
    for _ in range(int(np.floor((length - k) / stride + 1)) + 1):
        out.append(min(start, length - k))
        start += stride
    return out


def gaussian_window(k: Sequence[int]) -> np.ndarray:
    axes = []
    for n in k:
        x = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
        axes.append(np.exp(-0.5 * (x / (0.125 * n)) ** 2))
    w = axes[0][:, None, None] * axes[1][None, :, None] * axes[2][None, None, :]
    return np.maximum(w, 1e-3).astype(np.float32)


def stitch(gen: Callable[[torch.Tensor], torch.Tensor], img: np.ndarray, k: int, stride: int,
           pad_factor: float, batch: int, device) -> np.ndarray:
    """The stitched (X, Y, Z, 1) float32 volume of ``img`` (X, Y, Z, 1);
    ``gen`` maps a (b, k, k, k, 1) float32 batch on ``device`` to its
    predictions."""
    shape = img.shape[:3]
    sp = [int(pad_factor * n) for n in shape]
    padded = np.pad(img[..., 0], [(p, p) for p in sp], "symmetric")
    L = padded.shape
    grid = [(i, j, l) for i in origins(L[0], k, stride) for j in origins(L[1], k, stride)
            for l in origins(L[2], k, stride)]
    uniq = sorted(set(grid))
    mult = {o: grid.count(o) for o in uniq} if len(uniq) != len(grid) else None
    vol = torch.from_numpy(padded).to(device)
    pred = torch.zeros(L, dtype=torch.float32, device=device)
    cover = torch.zeros(L, dtype=torch.float32, device=device)
    w = torch.from_numpy(gaussian_window((k, k, k))).to(device)
    with torch.no_grad():
        for b0 in range(0, len(uniq), batch):
            chunk = uniq[b0:b0 + batch]
            x = torch.stack([vol[i:i + k, j:j + k, l:l + k] for i, j, l in chunk])[..., None]
            out = gen(x)[..., 0].float()
            for (i, j, l), o in zip(chunk, out):
                c = 1.0 if mult is None else float(mult[(i, j, l)])
                pred[i:i + k, j:j + k, l:l + k] += o * w * c
                cover[i:i + k, j:j + k, l:l + k] += w * c
        crop = tuple(slice(p, p + n) for p, n in zip(sp, shape))
        out = (pred[crop] / cover[crop]).double()
        out = 255.0 * (out - out.min()) / (out.max() - out.min())
    return out.float().cpu().numpy()[..., None]
