"""Seeded inputs, made on the device in bulk and handed over on the host.

- ``train_pool``: ``n`` unpaired (imaging, segmentation) patches. Imaging is
  uniform in [-1, 1]; segmentation is {-1, 1}, 1 where two independent
  blurred Gaussian fields are both near zero (|f| < 0.3 of their standard
  deviation), which gives thin tube-like structures, ~6% of the voxels.
  Both in pinned host memory, as the program's data feed hands batches over.
- ``Feed``: batches of rows of the pool, in an order drawn from the seed
  (a fresh permutation per pass, so the first batches never repeat a row).
- ``volume``: a blurred uniform field, min-maxed to [-1, 1], (n, n, n, 1)
  float32 on the host.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F


def _blur(x: torch.Tensor, k: int, times: int) -> torch.Tensor:
    for _ in range(times):
        x = F.avg_pool3d(x, k, stride=1, padding=k // 2, count_include_pad=False)
    return x


def _unit(x: torch.Tensor) -> torch.Tensor:
    return (x - x.mean()) / x.std()


def train_pool(n: int, patch, seed: int, device):
    """(imaging, segmentation), each (n, X, Y, Z, 1) float32 on the host."""
    g = torch.Generator(device=device).manual_seed(seed)
    img = torch.rand((n, *patch, 1), generator=g, device=device) * 2.0 - 1.0
    seg = torch.empty((n, *patch, 1), device=device)
    for i in range(n):
        f1, f2 = (_unit(_blur(torch.randn((1, 1, *patch), generator=g, device=device), 5, 2))
                  for _ in range(2))
        tube = (f1.abs() < 0.3) & (f2.abs() < 0.3)
        seg[i] = torch.where(tube, 1.0, -1.0)[0, 0, ..., None]
    pin = torch.device(device).type == "cuda"
    return tuple(t.cpu().pin_memory() if pin else t.cpu() for t in (img, seg))


def volume(size: int, seed: int, device) -> np.ndarray:
    g = torch.Generator(device=device).manual_seed(seed)
    v = _blur(torch.rand((1, 1, size, size, size), generator=g, device=device), 5, 1)
    v = 2.0 * (v - v.min()) / (v.max() - v.min()) - 1.0
    return v[0, 0, ..., None].cpu().numpy()


class Feed:
    """An iterator of (imaging, segmentation) batches of ``batch`` rows of the
    pool, each a new host tensor (pinned where the pool is). ``on_batch(i)``
    runs before batch i is handed over, and ``on_end(i)`` once, when the feed
    stops at the deadline after i batches (``deadline`` None: never)."""

    def __init__(self, pool, batch: int, seed: int):
        self.img, self.seg = pool
        self.batch = batch
        self.rng = np.random.default_rng(seed)
        self.order = np.empty(0, dtype=np.int64)
        self.deadline: Optional[float] = None
        self.handed = 0
        self.on_batch: Callable[[int], None] = lambda i: None
        self.on_end: Callable[[int], None] = lambda i: None

    def rows(self) -> torch.Tensor:
        while len(self.order) < self.batch:
            self.order = np.concatenate([self.order, self.rng.permutation(len(self.img))])
        rows, self.order = self.order[:self.batch], self.order[self.batch:]
        return torch.from_numpy(rows)

    def __iter__(self):
        return self

    def __next__(self):
        if self.deadline is not None and time.perf_counter() >= self.deadline:
            self.on_end(self.handed)
            raise StopIteration
        rows = self.rows()
        pin = self.img.is_pinned()
        out = []
        for src in (self.img, self.seg):
            dst = torch.empty((self.batch, *src.shape[1:]), pin_memory=pin)
            torch.index_select(src, 0, rows, out=dst)
            out.append(dst)
        self.on_batch(self.handed)
        self.handed += 1
        return tuple(out)
