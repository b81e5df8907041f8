"""TIFF volume I/O with Pillow, and the dataset partitions.

A volume is stored as one float32 page per leading index, as the JAX
package's ``write_tiff`` (imageio's Pillow plugin) stores it: a
``(z, x, y, 1)`` array becomes z pages of x rows and y columns.

:class:`DataPreprocessor` reads the partition manifests
(``dataA_partition.pkl``, ``dataB_partition.pkl``) that
``python -m vangan_tpu preprocess`` writes; the preprocessing itself is not
ported yet (ROADMAP.md Queue 1 item 3).
"""

from __future__ import annotations

import pickle

import numpy as np

NOT_PORTED = ("TIFF preprocessing is not ported yet (ROADMAP.md Queue 1 item 3); run "
              "`python -m vangan_tpu preprocess` to write the .npy volumes and partitions")


class DataPreprocessor:
    """One domain's dataset partition (preprocessing.py:14-230):
    ``partition`` maps "training", "validation" and "testing" to the .npy
    paths of that split."""

    def __init__(self, cfg=None, partition_id: str = "A", domain: str = "imaging"):
        self.cfg = cfg
        self.partition_id = partition_id
        self.domain = domain
        self.partition: dict = {}

    def load_partition(self, file_path: str) -> None:
        """Read a partition manifest pickled by the JAX package's
        ``DataPreprocessor.save_partition`` (a file this program's users
        wrote; unpickling runs code, so load only such files)."""
        print(f"*** Loading Dataset {self.partition_id} Partition ***")
        with open(file_path, "rb") as f:
            self.partition = pickle.load(f)

    def preprocess(self, *args, **kwargs) -> None:
        raise NotImplementedError(NOT_PORTED)

    def process_new_data(self, *args, **kwargs) -> None:
        raise NotImplementedError(NOT_PORTED)


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
