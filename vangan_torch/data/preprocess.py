"""TIFF volume I/O with Pillow.

A volume is stored as one float32 page per leading index, as the JAX
package's ``write_tiff`` (imageio's Pillow plugin) stores it: a
``(z, x, y, 1)`` array becomes z pages of x rows and y columns.
"""

from __future__ import annotations

import numpy as np


def write_tiff(path: str, arr: np.ndarray) -> None:
    """Write a ``(pages, rows, cols[, 1])`` array as a multi-page float32 TIFF."""
    from PIL import Image

    arr = np.asarray(arr, np.float32)
    if arr.ndim == 4:
        if arr.shape[-1] != 1:
            raise ValueError(f"one channel per voxel expected, got shape {arr.shape}")
        arr = arr[..., 0]
    if arr.ndim != 3:
        raise ValueError(f"expected a (pages, rows, cols[, 1]) array, got shape {arr.shape}")
    pages = [Image.fromarray(np.ascontiguousarray(p)) for p in arr]
    pages[0].save(path, format="TIFF", save_all=True, append_images=pages[1:])


def read_tiff(path: str) -> np.ndarray:
    """Read a multi-page TIFF written by :func:`write_tiff` as (pages, rows, cols, 1)."""
    from PIL import Image, ImageSequence

    with Image.open(path) as im:
        return np.stack([np.asarray(p, np.float32) for p in ImageSequence.Iterator(im)])[..., None]
