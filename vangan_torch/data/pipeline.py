"""The training data feed: unpaired imaging and segmentation patch streams.

Counterpart of ``vangan_tpu.data.pipeline`` (the reference's ``DatasetGen``,
dataset.py:11-251), a copy rather than an import so that the port runs
without the JAX package. The NumPy sample stream is the same, draw for draw,
for the same seed:

- volumes are opened with ``np.load(mmap_mode='r')`` and only the sampled
  crop is read;
- a segmentation crop is kept when ``max(crop) >= SEG_THRESH``, after at most
  ``REJECTION_MAX_TRIES`` re-crops (dataset.py:229-251);
- flips with probability 0.5 each and rot90 by k = floor(U(-180, 180) / 90)
  act on the (y, z) plane of an ``(x, y, z, c)`` volume (dataset.py:205-219),
  and on the (h, w) plane of an ``(h, w, c)`` image: with ``DIMENSIONS: 2``
  the feed crops ``(h, w, c)`` patches of ``(H, W, C)`` images;
- a background thread assembles batches into a bounded queue, and a worker's
  exception reaches the consumer as :class:`PipelineError`.

What differs is the hand-off: the prefetch thread turns each batch into torch
tensors, in pinned host memory when the dataset's device is a CUDA device
(``VanGan``'s steps copy them with ``non_blocking=True``); PyTorch's caching
host allocator owns the pinned blocks and reuses one only after its copy to
the card has completed.
"""

from __future__ import annotations

import math
import os
import queue
import threading
from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from vangan_torch.device import resolve_device
from vangan_torch.parallel import Group, rows


class PipelineError(RuntimeError):
    """A background sampler or prefetch worker died; raised on the consumer."""


# poison pill: a worker enqueues (_PILL, exc) on failure; data items are
# array tuples, so an identity check on element 0 cannot false-positive
_PILL = object()


def _put_with_stop(q: "queue.Queue", item, stop: threading.Event) -> bool:
    """Timed puts, so a producer blocked on a full queue sees ``stop``."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def _check_pill(item):
    if isinstance(item, tuple) and len(item) == 2 and item[0] is _PILL:
        raise PipelineError(f"data pipeline worker died: {item[1]!r}") from item[1]
    return item


def random_crop(vol: np.ndarray, patch: Sequence[int], rng: np.random.Generator) -> np.ndarray:
    """Uniform random spatial crop of a channels-last volume (tf.image.random_crop)."""
    starts = [rng.integers(0, vol.shape[i] - patch[i] + 1) for i in range(len(patch))]
    sl = tuple(slice(s, s + p) for s, p in zip(starts, patch))
    return np.ascontiguousarray(vol[sl])


def random_spatial_augmentation(
    arr: np.ndarray,
    rng: np.random.Generator,
    preserve_depth_orientation: bool = False,
    max_rotation_angle: float = 180.0,
) -> np.ndarray:
    """Random (y, z)-plane flips and optional rot90 of an ``(x, y, z, c)``
    volume (dataset.py:205-219; tf.image treats dim 0 as the batch)."""
    lr_ax, ud_ax = (2, 1) if arr.ndim == 4 else (1, 0)
    if rng.uniform() > 0.5:
        arr = np.flip(arr, axis=lr_ax)  # 'left_right'
    if rng.uniform() > 0.5:
        arr = np.flip(arr, axis=ud_ax)  # 'up_down'
    if not preserve_depth_orientation:
        angle = rng.uniform(-max_rotation_angle, max_rotation_angle)
        k = int(math.floor(angle / 90.0)) % 4
        if k:
            arr = np.rot90(arr, k=k, axes=(ud_ax, lr_ax))
    return np.ascontiguousarray(arr)


def minmax_to_pm1_np(batch: np.ndarray) -> np.ndarray:
    """Per-sample min-max to [-1, 1], the imaging transform (main.py:169-177)."""
    axes = tuple(range(1, batch.ndim))
    mx = batch.max(axis=axes, keepdims=True)
    mn = batch.min(axis=axes, keepdims=True)
    return 2.0 * (batch - mn) / (mx - mn) - 1.0


class _DomainSampler:
    """Infinite shuffled sampler over one domain's volume files."""

    def __init__(
        self,
        paths: Sequence[str],
        patch: Sequence[int],
        rng: np.random.Generator,
        augment: Callable[[np.ndarray, np.random.Generator], np.ndarray],
        accept: Optional[Callable[[np.ndarray], bool]] = None,
        max_tries: int = 200,
        mmap: bool = True,
        paired_dir: Optional[str] = None,
    ):
        self.paths = [str(p) for p in paths]
        if not self.paths:
            raise ValueError("empty domain file list")
        self.patch = tuple(patch)
        self.rng = rng
        self.augment = augment
        self.accept = accept
        self.max_tries = max_tries
        self.mmap = mmap
        self.paired_dir = paired_dir  # semi-supervised: the paired volume (dataset.py:182-187)
        self._order: list = []

    def _next_path(self) -> str:
        if not self._order:
            self._order = list(self.rng.permutation(len(self.paths)))
        return self.paths[self._order.pop()]

    def _load(self, path: str) -> np.ndarray:
        vol = np.load(path, mmap_mode="r" if self.mmap else None)
        if self.paired_dir is not None:
            # semi-supervised: the paired volume stacked along axis 0 before
            # cropping (dataset.py:182-187)
            paired = os.path.join(self.paired_dir, os.path.basename(path))
            vol = np.concatenate([np.asarray(vol), np.load(paired)], axis=0)
        return vol

    def sample(self) -> np.ndarray:
        vol = self._load(self._next_path())
        crop = random_crop(vol, self.patch, self.rng)
        if self.accept is not None:
            tries = 0
            while tries < self.max_tries and not self.accept(crop):
                crop = random_crop(vol, self.patch, self.rng)
                tries += 1
        return self.augment(np.asarray(crop, dtype=np.float32), self.rng)


class VanGanDataset:
    """Zipped unpaired-domain batches (dataset.py:11-124): ``train_batches``
    and ``val_batches`` yield ``(real_I, real_S)`` float32 tensors of shape
    ``(GLOBAL_BATCH_SIZE, *SUBVOL_PATCH_SIZE, C)`` on the host, pinned for a
    CUDA ``device`` (the default; without CUDA it raises) and pageable for
    ``device="cpu"``. A rank of a data-parallel ``group`` gets its rows of
    each global batch (``parallel.rows``): every rank samples the whole
    stream, so the ranks together see the batches of one process (and of
    the JAX package's data mesh). Steps per epoch count global batches."""

    def __init__(
        self,
        cfg,
        imaging_partition: dict,
        seg_partition: dict,
        otf_imaging: Optional[Callable[[np.ndarray], np.ndarray]] = minmax_to_pm1_np,
        seed: int = 0,
        mmap: bool = True,
        semi_supervised_dir: Optional[str] = None,
        device="cuda",
        group: Optional[Group] = None,
    ):
        self.cfg = cfg
        self.imaging_partition = imaging_partition
        self.seg_partition = seg_partition
        self.otf_imaging = otf_imaging
        self.seed = seed
        self.mmap = mmap
        self.semi_supervised_dir = semi_supervised_dir
        self.device = resolve_device(device)
        self.rows = rows(group, cfg.GLOBAL_BATCH_SIZE)
        self.SEG_THRESH = cfg.SEG_THRESH
        self._queues: list = []
        self._stop = threading.Event()

        # steps per epoch (main.py:189-193)
        self.train_steps = cfg.train_steps or max(1, int(
            max(len(imaging_partition["training"]), len(seg_partition["training"]))
            / cfg.GLOBAL_BATCH_SIZE))
        self.val_steps = cfg.val_steps or max(1, int(
            max(len(imaging_partition["validation"]), len(seg_partition["validation"]))
            / cfg.GLOBAL_BATCH_SIZE))

    def _make_samplers(self, split: str, seed_offset: int) -> Tuple[_DomainSampler, _DomainSampler]:
        cfg = self.cfg
        imaging = _DomainSampler(
            self.imaging_partition[split], cfg.subvol_patch_shape,
            np.random.default_rng(self.seed + seed_offset),
            augment=lambda a, r: random_spatial_augmentation(a, r, preserve_depth_orientation=True),
            mmap=self.mmap,
        )
        segmentation = _DomainSampler(
            self.seg_partition[split], cfg.seg_subvol_patch_shape,
            np.random.default_rng(self.seed + seed_offset + 1),
            augment=lambda a, r: random_spatial_augmentation(a, r),
            accept=lambda c: float(c.max()) >= self.SEG_THRESH,
            max_tries=cfg.REJECTION_MAX_TRIES,
            mmap=self.mmap,
            paired_dir=self.semi_supervised_dir,
        )
        return imaging, segmentation

    def _batch_iter(self, split: str, seed_offset: int, workers: Optional[int] = None
                    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """The NumPy batch stream of ``split``."""
        gb = self.cfg.GLOBAL_BATCH_SIZE
        workers = workers if workers is not None else self.cfg.DATA_WORKERS
        if workers > 1:
            yield from self._parallel_batch_iter(split, seed_offset, workers, gb)
            return
        imaging, segmentation = self._make_samplers(split, seed_offset)
        while True:
            real_I = np.stack([imaging.sample() for _ in range(gb)])
            real_S = np.stack([segmentation.sample() for _ in range(gb)])
            if self.otf_imaging is not None:
                real_I = self.otf_imaging(real_I)
            yield real_I.astype(np.float32), real_S.astype(np.float32)

    def _parallel_batch_iter(self, split: str, seed_offset: int, workers: int, gb: int
                             ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Worker ``w`` owns its own sampler pair (seed offset ``7919 w``) and
        fills batch slots ``w, w + W, ...`` through its own bounded queue, so
        the stream is deterministic for a fixed (seed, W). mmap reads and
        NumPy crops release the GIL, so the threads overlap."""
        workers = min(workers, gb)  # slots i % workers only reach queues 0..gb-1
        stop = self._stop
        per_q = max(2, (2 * gb + workers - 1) // workers)
        qs: list = [queue.Queue(maxsize=per_q) for _ in range(workers)]
        self._queues.extend(qs)

        def work(w: int, q: "queue.Queue") -> None:
            try:
                imaging, segmentation = self._make_samplers(split, seed_offset + 7919 * w)
                while not stop.is_set():
                    if not _put_with_stop(q, (imaging.sample(), segmentation.sample()), stop):
                        return
            except BaseException as e:  # noqa: BLE001 -- forwarded to the consumer
                _put_with_stop(q, (_PILL, e), stop)

        for w, q in enumerate(qs):
            threading.Thread(target=work, args=(w, q), daemon=True).start()

        while True:
            pairs = [_check_pill(qs[i % workers].get()) for i in range(gb)]
            real_I = np.stack([p[0] for p in pairs])
            real_S = np.stack([p[1] for p in pairs])
            if self.otf_imaging is not None:
                real_I = self.otf_imaging(real_I)
            yield real_I.astype(np.float32), real_S.astype(np.float32)

    def _to_host(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(arr)
        return t.pin_memory() if self.device.type == "cuda" else t

    def _prefetched(self, it: Iterator, prefetch: int
                    ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """Run ``it`` in a daemon thread that buffers ``prefetch`` batches as
        host tensors; its exceptions are raised here as :class:`PipelineError`."""
        q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._queues.append(q)
        stop = self._stop

        def worker():
            try:
                for real_I, real_S in it:
                    if not _put_with_stop(q, (self._to_host(real_I[self.rows]),
                                              self._to_host(real_S[self.rows])), stop):
                        return
            except BaseException as e:  # noqa: BLE001 -- forwarded to the consumer
                _put_with_stop(q, (_PILL, e), stop)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            yield _check_pill(q.get())

    def train_batches(self, prefetch: Optional[int] = None):
        return self._prefetched(self._batch_iter("training", 100),
                                prefetch or self.cfg.PREFETCH_SIZE)

    def val_batches(self, prefetch: Optional[int] = None):
        return self._prefetched(self._batch_iter("validation", 200),
                                prefetch or self.cfg.PREFETCH_SIZE)

    # full-volume validation sampling (dataset.py:193-201)
    def imaging_val_full(self, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng(self.seed + 300)
        paths = self.imaging_partition["validation"]
        while True:
            i = int(rng.integers(0, len(paths)))
            yield np.load(str(paths[i])).astype(np.float32), i

    def segmentation_val_full(self, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng(self.seed + 400)
        paths = self.seg_partition["validation"]
        while True:
            i = int(rng.integers(0, len(paths)))
            yield np.load(str(paths[i])).astype(np.float32), i

    def _paired_sample(self) -> Optional[np.ndarray]:
        """A paired-imaging crop at an accepted segmentation location
        (semi-supervised panels); None without a paired volume."""
        if self.semi_supervised_dir is None:
            return None
        path = str(self.seg_partition["training"][0])
        pair_path = os.path.join(self.semi_supervised_dir, os.path.basename(path))
        if not os.path.exists(pair_path):
            return None
        seg = np.load(path)
        pair = np.load(pair_path)
        rng = np.random.default_rng(self.seed + 901)
        patch = self.cfg.seg_subvol_patch_shape
        sl = tuple(slice(0, p) for p in patch)  # the corner when no try accepts
        for _ in range(self.cfg.REJECTION_MAX_TRIES):
            starts = [int(rng.integers(0, seg.shape[i] - patch[i] + 1))
                      for i in range(len(patch))]
            sl = tuple(slice(s, s + p) for s, p in zip(starts, patch))
            if float(seg[sl].max()) >= self.SEG_THRESH:
                break
        return np.ascontiguousarray(pair[sl])

    def plot_sample_dataset(self, out_dir: str = "GANMonitor") -> None:
        """Sanity panels and TIFFs of one training sample pair at the start of
        a run (dataset.py:277-373), drawn with Pillow: ``dataset_sample_XY.png``
        and ``dataset_sample_YZ.png`` (six slices and a histogram a column; a
        third 'Paired Imaging' column in the semi-supervised mode) and
        ``{Imaging,Segmentation}_Test_Input.tiff``. With 2-D images, one
        panel ``dataset_sample_2d.png``: the image over its histogram, a
        column each (dataset.py:293-330)."""
        from vangan_torch.data.preprocess import write_tiff
        from vangan_torch.monitor.panels import grey_tile, histogram_tile, save_grid

        os.makedirs(out_dir, exist_ok=True)
        real_I, real_S = next(self._batch_iter("training", 900))
        dI, dS = real_I[0], real_S[0]
        dIS = self._paired_sample()
        cols = [dI, dS] + ([dIS] if dIS is not None else [])
        titles = ["Imaging Dataset", "Segmentation Dataset", "Paired Imaging Dataset"]

        if dI.ndim == 3:
            columns = [[grey_tile(img[..., 0], title),
                        histogram_tile(img, "Pixel Frequency" if c == 0 else None)]
                       for c, (img, title) in enumerate(zip(cols, titles))]
            save_grid(os.path.join(out_dir, "dataset_sample_2d.png"), columns)
            return

        write_tiff(os.path.join(out_dir, "Imaging_Test_Input.tiff"), np.transpose(dI, (2, 0, 1, 3)))
        write_tiff(os.path.join(out_dir, "Segmentation_Test_Input.tiff"),
                   np.transpose(dS, (2, 0, 1, 3)))
        nfig = 6
        for tag, axis in (("XY", 2), ("YZ", 1)):
            columns = []
            for vol, title in zip(cols, titles):
                tiles = []
                for j in range(nfig):
                    z = j * int(vol.shape[axis] / nfig)
                    img = vol[:, :, z, 0] if axis == 2 else vol[:, z, :, 0]
                    tiles.append(grey_tile(img, f"{title} ({tag})" if j == 0 else None))
                tiles.append(histogram_tile(vol, "Voxel Frequency" if not columns else None))
                columns.append(tiles)
            save_grid(os.path.join(out_dir, f"dataset_sample_{tag}.png"), columns)

    def close(self) -> None:
        self._stop.set()
        for q in self._queues:
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
