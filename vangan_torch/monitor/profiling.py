"""Spans, profiling and numerics-debugging hooks (counterpart of
``vangan_tpu.monitor.profiling``):

- ``span(name)``: a context manager around a phase of the program (the train
  step's phases, the conv wrapper, the stitcher). With no recording open and
  no torch profiler running it is one test of two flags and a shared no-op;
  inside ``recording()`` it records a ``Span`` on the clock the torch
  profiler stamps its events with (``time.time_ns``, Unix nanoseconds);
  while a torch profiler runs it also enters the profiler's
  ``record_function(name)`` (its lighter C++ form where torch has it), so the
  name shows in the trace (on the host's timeline where the profiler traces
  the host's operators);
- ``recording(cuda_events=False)``: collects every span opened, on any
  thread (the autograd engine's included), until the block ends, and hands
  them over then (one recording at a time); with ``cuda_events`` each span
  also records a CUDA event on the current stream at its start and end
  (``elapsed_ms``);
- ``trace(profile_dir)``: a ``torch.profiler`` trace of the host and, where
  there is one, the card, written as a Chrome trace into ``profile_dir``;
  the program's spans are in it;
- ``enable_nan_debugging()``: autograd anomaly detection, which raises at the
  backward op that produced a NaN (vangan.py:290-292).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Iterator, List, NamedTuple, Optional, Tuple

import torch
import torch.autograd.profiler as _torch_profiler


class Span(NamedTuple):
    """One recorded span: ``parent`` is the index, in the recording's list,
    of the innermost span the same thread had open at the start (-1: none
    recorded); ``thread`` the OS thread id; times in Unix ns; ``events``
    the CUDA events at the start and end (``recording(cuda_events=True)``),
    else None."""

    name: str
    parent: int
    thread: int
    start_ns: int
    end_ns: int
    events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = None


_recording: Optional[List["_Span"]] = None  # the open recording's spans, in the order opened
_cuda_events = False  # whether it asks for CUDA events
_threads = threading.local()  # each thread's OS id and its open recorded spans, innermost last
# the profiler's lighter record_function (a C++ context manager), where torch has it
_record_function = getattr(torch._C._profiler, "_RecordFunctionFast", None) \
    or torch.profiler.record_function


class _NoSpan:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "rf", "recorded", "parent", "thread", "start_ns", "end_ns", "events")

    def __init__(self, name: str):
        self.name = name
        self.rf = None
        self.recorded = False

    def __enter__(self) -> None:
        if _torch_profiler._is_profiler_enabled:
            self.rf = _record_function(self.name)
            self.rf.__enter__()
        spans = _recording
        if spans is not None:
            stack = getattr(_threads, "open", None)
            if stack is None:
                stack = _threads.open = []
                _threads.id = threading.get_native_id()
            self.parent = stack[-1] if stack else None
            self.thread = _threads.id
            self.end_ns = self.events = None
            if _cuda_events:
                self.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
                self.events[0].record()
            self.start_ns = time.time_ns()
            self.recorded = True
            stack.append(self)
            spans.append(self)
        return None

    def __exit__(self, *exc) -> bool:
        if self.recorded:
            self.end_ns = time.time_ns()
            if self.events is not None:
                self.events[1].record()
            _threads.open.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around a phase named ``name`` (see the module note);
    a shared no-op while nothing records or profiles."""
    if _recording is None and not _torch_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name)


@contextlib.contextmanager
def recording(cuda_events: bool = False) -> Iterator[List[Span]]:
    """Record every span opened in the block, on any thread: the list it
    yields holds them, in the order they were opened, once the block has
    ended (a span still open then is left out). ``cuda_events``: each span
    also records a CUDA event at its start and end (the card only). One
    recording at a time."""
    global _recording, _cuda_events
    if _recording is not None:
        raise RuntimeError("a recording of spans is already open")
    _recording, _cuda_events = [], cuda_events
    spans: List[Span] = []
    try:
        yield spans
    finally:
        opened, _recording = _recording, None
        closed = [s for s in opened if s.end_ns is not None]
        index = {id(s): i for i, s in enumerate(closed)}
        spans.extend(Span(s.name, index.get(id(s.parent), -1), s.thread, s.start_ns,
                          s.end_ns, s.events) for s in closed)


def elapsed_ms(s: Span) -> float:
    """The device's ms from a span's start to its end, by its CUDA events
    (after a synchronize)."""
    return s.events[0].elapsed_time(s.events[1])


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
