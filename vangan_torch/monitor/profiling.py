"""Profiling and numerics-debugging hooks (counterpart of
``vangan_tpu.monitor.profiling``):

- ``trace(profile_dir)``: a ``torch.profiler`` trace of the host and, where
  there is one, the card, written as a Chrome trace into ``profile_dir``;
- ``enable_nan_debugging()``: autograd anomaly detection, which raises at the
  backward op that produced a NaN (vangan.py:290-292).

The JAX package's ``annotate`` and ``StepTimer`` wait for a caller on the
port's path (``torch.profiler.record_function`` and CUDA events are what
they would wrap).
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(profile_dir: Optional[str]) -> Iterator[None]:
    """Profile the block into ``profile_dir/trace_<pid>.json``; nothing
    when ``profile_dir`` is None."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, f"trace_{os.getpid()}.json"))


def enable_nan_debugging() -> None:
    """Fail loudly at the backward op producing a NaN."""
    torch.autograd.set_detect_anomaly(True)
