"""Device time by the program's spans: each device event of a profiler trace
(a kernel, copy or set) counts under every span of
``vangan_torch.monitor.profiling`` that was open when the host launched it.

The link: a device event and the CUDA runtime call that launched it
(``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...) carry the same CUPTI
correlation id, so the call's start on the host's clock is the event's
launch time. The spans are stamped on that clock too (``time.time_ns``). A
launch counts under the spans open at its time on every thread: the autograd
engine's thread, which opens the conv wrapper's backward spans, launches
while the main thread holds ``step.backward`` open, and both count. A device
event whose runtime call is not in the trace, or that no span covers, counts
under no name.
"""

from __future__ import annotations

import bisect
from typing import Dict, FrozenSet, Iterable, List, NamedTuple, Sequence, Tuple

import torch


class Device(NamedTuple):
    """A device event: its correlation id, start and end (ns) and name."""

    corr: int
    start_ns: int
    end_ns: int
    name: str


class Launch(NamedTuple):
    """A CUDA runtime call: its correlation id, start and end (ns), OS thread
    and name."""

    corr: int
    start_ns: int
    end_ns: int
    thread: int
    name: str


def is_runtime(name: str) -> bool:
    """A CUDA runtime or driver call (not a torch operator or a span)."""
    return name.startswith(("cuda", "cu")) and not name.startswith("cudnn")


def from_events(events: Iterable) -> Tuple[List[Device], List[Launch]]:
    """The device events and the CUDA runtime calls of a profiler's events
    (``prof.profiler.kineto_results.events()``)."""
    device, launches = [], []
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():  # a host span mirrored on the device
                device.append(Device(e.correlation_id(), e.start_ns(), e.end_ns(), e.name()))
        elif is_runtime(e.name()):
            launches.append(Launch(e.correlation_id(), e.start_ns(), e.end_ns(),
                                   e.start_thread_id(), e.name()))
    return device, launches


def open_at(spans: Sequence, times: Sequence[int]) -> List[FrozenSet[str]]:
    """For each time (ns), the names of the spans (``start_ns``, ``end_ns``,
    ``name``) open at it, on any thread."""
    # at one time a start sorts before an end: a span holds both its ends
    edges = sorted([(s.start_ns, 0, s.name) for s in spans] +
                   [(s.end_ns, 1, s.name) for s in spans])
    order = sorted(range(len(times)), key=times.__getitem__)
    out: List[FrozenSet[str]] = [frozenset()] * len(times)
    live: Dict[str, int] = {}
    names: FrozenSet[str] = frozenset()
    j = 0
    for i in order:
        t = times[i]
        changed = False
        while j < len(edges) and (edges[j][0] < t or (edges[j][0] == t and not edges[j][1])):
            _, end, name = edges[j]
            live[name] = live.get(name, 0) + (-1 if end else 1)
            if not live[name]:
                del live[name]
            changed = True
            j += 1
        if changed:
            names = frozenset(live)
        out[i] = names
    return out


def attribute(device: Sequence[Device], launches: Sequence[Launch],
              spans: Sequence) -> List[FrozenSet[str]]:
    """For each device event, the names of the spans open at the start of
    the runtime call that launched it (empty without one)."""
    start = {c.corr: c.start_ns for c in launches}
    known = [i for i, d in enumerate(device) if d.corr in start]
    names = open_at(spans, [start[device[i].corr] for i in known])
    out: List[FrozenSet[str]] = [frozenset()] * len(device)
    for i, n in zip(known, names):
        out[i] = n
    return out


def device_ns(device: Sequence[Device], names: Sequence[FrozenSet[str]]) -> Dict[str, int]:
    """Inclusive device ns by span name: each event counts once under every
    name open at its launch; ``""`` holds the events under no span."""
    out: Dict[str, int] = {}
    for d, n in zip(device, names):
        ns = d.end_ns - d.start_ns
        for name in n or ("",):
            out[name] = out.get(name, 0) + ns
    return out


def inside(calls: Sequence[Launch], spans: Sequence, name: str) -> List[Tuple[int, int]]:
    """For each call that overlaps a span called ``name`` (spans of one name
    do not overlap): (its start - the span's start, the span's end - its
    end), in ns; both are >= 0 where the call lies inside the span as it
    was stamped."""
    ours = sorted((s.start_ns, s.end_ns) for s in spans if s.name == name)
    starts = [a for a, _ in ours]
    out = []
    for c in calls:
        i = bisect.bisect_right(starts, c.end_ns) - 1
        if i >= 0 and ours[i][1] >= c.start_ns:
            out.append((c.start_ns - ours[i][0], ours[i][1] - c.end_ns))
    return out
