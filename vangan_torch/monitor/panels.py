"""Image panels drawn with Pillow, in place of the JAX package's matplotlib
figures: grey slices (scaled to their own min and max, as ``imshow`` does),
256-bin density histograms, and a grid of columns saved as one PNG."""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

TILE = 160  # pixels of a tile's image area
STRIP = 14  # pixels of a tile's title strip


def _titled(img, title: Optional[str]):
    from PIL import Image, ImageDraw

    out = Image.new("L", (TILE, TILE + STRIP), 255)
    out.paste(img, (0, STRIP))
    if title:
        ImageDraw.Draw(out).text((2, 1), title, fill=0)
    return out


def grey_tile(img2d: np.ndarray, title: Optional[str] = None):
    """A 2-D slice as an 8-bit grey tile, min to black and max to white."""
    from PIL import Image

    a = np.asarray(img2d, np.float32)
    lo, hi = float(a.min()), float(a.max())
    scaled = (a - lo) / (hi - lo) * 255.0 if hi > lo else np.zeros_like(a)
    img = Image.fromarray(scaled.astype(np.uint8)).resize((TILE, TILE),
                                                          Image.Resampling.NEAREST)
    return _titled(img, title)


def histogram_tile(values: np.ndarray, title: Optional[str] = None, bins: int = 256):
    """A density histogram of ``values`` over their own range, in black bars."""
    from PIL import Image, ImageDraw

    v = np.asarray(values, np.float32).ravel()
    lo, hi = float(v.min()), float(v.max())
    counts, _ = np.histogram(v, bins=bins, range=(lo, hi) if hi > lo else (lo - 0.5, lo + 0.5))
    img = Image.new("L", (TILE, TILE), 255)
    draw = ImageDraw.Draw(img)
    top = max(int(counts.max()), 1)
    for i, c in enumerate(counts):
        x = int(i * TILE / bins)
        draw.line([(x, TILE - 1), (x, TILE - 1 - int(c / top * (TILE - 2)))], fill=0)
    return _titled(img, title)


def save_grid(path: str, columns: Sequence[Sequence]) -> None:
    """Save tiles as a grid, ``columns[c][r]`` at column c and row r."""
    from PIL import Image

    rows = max(len(c) for c in columns)
    h = TILE + STRIP
    grid = Image.new("L", (len(columns) * (TILE + 4), rows * (h + 4)), 255)
    for c, col in enumerate(columns):
        for r, tile in enumerate(col):
            grid.paste(tile, (c * (TILE + 4), r * (h + 4)))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    grid.save(path, format="PNG")
