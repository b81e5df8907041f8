"""Offline preprocessing of raw TIFFs into normalised .npy volumes and
dataset partitions, and TIFF volume I/O with Pillow.

Counterpart of ``vangan_tpu.data.preprocess`` (the reference's
``DataPreprocessor``, preprocessing.py:14-230): per-domain TIFF ingestion, a
72/18/10 train/val/test split, Lanczos resize (cv2), min-max normalisation
to [-1, 1], segmentation binarisation with the polarity fix, NaN guarding,
and pickled partition manifests (``dataA_partition.pkl``,
``dataB_partition.pkl``), the same bytes of .npy and the same partitions as
the JAX package from the same TIFFs and seed. The segmentation-domain
behaviour is chosen by ``domain='segmentation'``, as there.

Raw TIFFs are read with Pillow, page-major (z, y, x), as float32: uint8,
uint16 (mode ``I;16``) and float32 pages alike. Volumes are fanned out over
worker processes started with ``spawn`` (never ``fork``: the caller may hold
a CUDA context and cv2's threads), so a ``preprocess_fn`` hook must be a
module-level function that pickles, and a script that calls ``preprocess``
does so under ``if __name__ == "__main__":`` (each worker imports the
caller's main script again). This module and the hooks it names import
numpy, Pillow and cv2 but not torch, so a spawned worker does not pay
torch's import.

A volume the port writes is stored as one page per leading index, as the JAX
package's ``write_tiff`` (imageio's Pillow plugin) stores it: a
``(z, x, y, 1)`` array becomes z pages of x rows and y columns.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import random
import shutil
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from vangan_torch.ops.norms_np import min_max_norm_np
from vangan_torch.utils import check_nan

SUBDIRS = {"training": "train", "validation": "val", "testing": "test"}


def resize_volume(img: np.ndarray, target_size: Sequence[int]) -> np.ndarray:
    """Two-pass slice-wise Lanczos4 3-D resize (utils.py:224-255 semantics).

    Pass 1 resizes each z-slice to (target_x, target_y); pass 2 resizes each
    x-slice to (target_y, target_z). Skips pass 1 when XY already matches.
    """
    import cv2

    tx, ty, tz = target_size[0], target_size[1], target_size[2]
    if tuple(img.shape[0:2]) != (tx, ty):
        arr1 = np.empty([tx, ty, img.shape[2]], dtype="float32")
        for i in range(img.shape[2]):
            arr1[:, :, i] = cv2.resize(img[:, :, i], (ty, tx), interpolation=cv2.INTER_LANCZOS4)
    else:
        arr1 = img.astype("float32")
    arr2 = np.empty([tx, ty, tz], dtype="float32")
    for i in range(tx):
        arr2[i, :, :] = cv2.resize(arr1[i], (tz, ty), interpolation=cv2.INTER_LANCZOS4)
    return arr2


def _process_one(task: Tuple) -> Optional[str]:
    """Worker: process one TIFF into an .npy volume. Returns the file name when
    the volume holds a NaN and is skipped."""
    (raw_path, file, out_dir, dimensions, domain, tiff_size, target_size, do_resize,
     preprocess_fn, save_filtered, filtered_dir) = task
    stack = read_tiff(os.path.join(raw_path, file))[..., 0]  # (z, y, x)
    if dimensions == 2 and stack.shape[0] == 1:
        stack = stack[0]  # a one-page image, (y, x), as the JAX package reads it
    base, _ = os.path.splitext(file)

    if dimensions == 3:
        # (z, y, x) -> (x-major spatial, z last) like preprocessing.py:164-165
        stack = np.transpose(stack, (1, 2, 0))

    if preprocess_fn is not None:
        stack = preprocess_fn(stack)

    if do_resize and tuple(tiff_size)[:3] != tuple(target_size)[:3]:
        stack = resize_volume(stack, target_size).astype("float32")
        if domain == "segmentation":
            stack = np.clip(stack, 0.0, 255.0)  # preprocessing.py:175-177

    stack = min_max_norm_np(stack)
    if domain == "segmentation":
        # polarity fix: if background (mode) is 1, invert (preprocessing.py:180-184)
        values, counts = np.unique(stack, return_counts=True)
        mode = values[np.argmax(counts)]
        if mode == 1:
            stack = np.abs(stack - 1.0)
    stack = (stack - 0.5) / 0.5  # [0,1] -> [-1,1]
    if domain == "segmentation":
        stack = np.where(stack < 0.0, -1.0, 1.0).astype("float32")  # preprocessing.py:187-189

    if check_nan(stack):
        return file  # skipped (preprocessing.py:214-215)
    if save_filtered and filtered_dir:
        # filtered uint8 TIFF dump for visual QA (preprocessing.py:193-203)
        os.makedirs(filtered_dir, exist_ok=True)
        arr8 = (np.transpose(stack, (2, 1, 0)) * 127.5 + 127.5).astype("uint8")
        write_tiff(os.path.join(filtered_dir, base + ".tiff"), arr8)
    np.save(os.path.join(out_dir, base), np.expand_dims(stack, axis=dimensions))
    return None


class DataPreprocessor:
    """One domain's dataset (preprocessing.py:14 API surface): ``partition``
    maps "training", "validation" and "testing" to that split's files (raw
    TIFF names after ``split_dataset``, .npy paths after ``save_partition``
    or ``load_partition``)."""

    def __init__(
        self,
        args=None,
        raw_path: Optional[str] = None,
        main_dir: Optional[str] = None,
        partition_id: str = "",
        partition_filename: Optional[str] = None,
        tiff_size: Sequence[int] = (600, 600, 700),
        target_size: Sequence[int] = (600, 600, 700),
        domain: str = "imaging",  # 'imaging' | 'segmentation'
        num_workers: Optional[int] = None,
        seed: Optional[int] = None,
    ):
        self.raw_path = raw_path
        self.main_dir = main_dir
        self.partition_id = partition_id
        self.partition_filename = partition_filename
        self.tiff_size = tuple(tiff_size)
        self.target_size = tuple(target_size)
        self.domain = domain
        self.partition: dict = {}
        self.seed = seed
        self.NUM_WORKERS = num_workers or max(1, int(0.8 * (os.cpu_count() or 2) - 1))
        self.DIMENSIONS = getattr(args, "DIMENSIONS", 3) if args is not None else 3
        self.CHANNELS = getattr(args, "CHANNELS", 1) if args is not None else 1

    # --- partition management (preprocessing.py:38-108) ---

    def split_dataset(self) -> None:
        """Shuffle and split raw files 72/18/10 (0.9 then 0.8 splits)."""
        files = sorted(os.listdir(self.raw_path))
        rng = random.Random(self.seed)
        rng.shuffle(files)
        train_files, test_files = np.split(np.asarray(files, dtype=object), [int(len(files) * 0.9)])
        train_files, validate_files = np.split(train_files, [int(len(train_files) * 0.8)])
        self.partition = {
            "training": train_files,
            "validation": validate_files,
            "testing": test_files,
        }

    def save_partition(self, save_path: Optional[str] = None) -> None:
        """Rewrite partition entries as .npy paths under train/val/test dirs and pickle."""
        if save_path is None:
            raise ValueError("Partition save_path is not provided.")
        new_partition = {}
        for split, files in self.partition.items():
            arr = np.empty(len(files), dtype=object)
            for i, f in enumerate(files):
                base, _ = os.path.splitext(os.path.basename(str(f)))
                arr[i] = os.path.join(save_path, SUBDIRS[split] + self.partition_id, base + ".npy")
            new_partition[split] = arr
        with open(os.path.join(save_path, self.partition_filename), "wb") as f:
            pickle.dump(new_partition, f)
        self.partition = new_partition

    def load_partition(self, file_path: str) -> None:
        """Read a partition manifest pickled by ``save_partition`` (this
        module's or the JAX package's: a file this program's users wrote;
        unpickling runs code, so load only such files)."""
        print(f"*** Loading Dataset {self.partition_id} Partition ***")
        with open(file_path, "rb") as f:
            self.partition = pickle.load(f)

    def move_dataset(self) -> None:
        """Move raw files into train/val/test directories (preprocessing.py:110-119)."""
        for split, files in self.partition.items():
            for f in files:
                shutil.move(
                    os.path.join(self.raw_path, str(f)),
                    os.path.join(self.main_dir, SUBDIRS[split] + self.partition_id),
                )

    # --- processing (preprocessing.py:121-215) ---

    def preprocess(
        self,
        preprocess_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        resize: bool = False,
        save_filtered: bool = False,
    ) -> None:
        """Split + process every partition in parallel, then save the manifest."""
        print(f"*** Preprocessing partition {self.partition_id} images ***")
        self.split_dataset()
        for split, files in self.partition.items():
            out_dir = os.path.join(self.main_dir, SUBDIRS[split] + self.partition_id)
            os.makedirs(out_dir, exist_ok=True)
            filtered = os.path.join(self.main_dir, "filtered", SUBDIRS[split] + self.partition_id)
            self._run_parallel(files, out_dir, preprocess_fn, resize, save_filtered, filtered)
        self.save_partition(self.main_dir)

    def _run_parallel(self, files, out_dir, preprocess_fn, resize, save_filtered=False,
                      filtered_dir=None) -> None:
        """``_process_one`` over ``files``: in this process for one file or one
        worker, else in a pool of ``NUM_WORKERS`` processes started by spawn."""
        tasks = [
            (self.raw_path, str(f), out_dir, self.DIMENSIONS, self.domain, self.tiff_size,
             self.target_size, resize, preprocess_fn, save_filtered, filtered_dir)
            for f in files
        ]
        if self.NUM_WORKERS <= 1 or len(tasks) <= 1:
            skipped = [_process_one(t) for t in tasks]
        else:
            with ProcessPoolExecutor(max_workers=min(self.NUM_WORKERS, len(tasks)),
                                     mp_context=multiprocessing.get_context("spawn")) as pool:
                skipped = list(pool.map(_process_one, tasks))
        for s in skipped:
            if s is not None:
                print(f"NaN detected, skipped {s} ...")

    def process_new_data(
        self,
        current_path: str,
        new_path: str,
        tiff_size=None,
        target_size=None,
        preprocess_fn=None,
        resize: bool = False,
    ) -> None:
        """Inference-time preprocessing of a directory of TIFFs (preprocessing.py:217-230)."""
        self.raw_path = current_path
        self.main_dir = new_path
        if tiff_size is not None:
            self.tiff_size = tuple(tiff_size)
        if target_size is not None:
            self.target_size = tuple(target_size)
        os.makedirs(new_path, exist_ok=True)
        files = sorted(os.listdir(current_path))
        tasks = [
            (current_path, f, new_path, self.DIMENSIONS, self.domain, self.tiff_size,
             self.target_size, resize, preprocess_fn, False, None)
            for f in files
        ]
        for t in tasks:
            if (skip := _process_one(t)) is not None:
                print(f"NaN detected, skipped {skip} ...")


def write_tiff(path: str, arr: np.ndarray) -> None:
    """Write a ``(pages, rows, cols[, 1])`` array as a multi-page TIFF: uint8
    pages for a uint8 array, float32 pages for any other."""
    from PIL import Image

    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        arr = arr.astype(np.float32)
    if arr.ndim == 4:
        if arr.shape[-1] != 1:
            raise ValueError(f"one channel per voxel expected, got shape {arr.shape}")
        arr = arr[..., 0]
    if arr.ndim != 3:
        raise ValueError(f"expected a (pages, rows, cols[, 1]) array, got shape {arr.shape}")
    pages = [Image.fromarray(np.ascontiguousarray(p)) for p in arr]
    pages[0].save(path, format="TIFF", save_all=True, append_images=pages[1:])


def read_tiff(path: str) -> np.ndarray:
    """Read a multi-page greyscale TIFF (uint8, uint16 or float32 pages) as
    float32 (pages, rows, cols, 1)."""
    from PIL import Image, ImageSequence

    with Image.open(path) as im:
        return np.stack([np.asarray(p, np.float32) for p in ImageSequence.Iterator(im)])[..., None]
