"""One ``torch.profiler`` window over a stretch of the timed window, and what
the per-layer readers take from it.

``Window.start`` synchronises the device and starts the profiler;
``Window.stop`` synchronises again and stops it. The host clock between the
two synchronisations is ``window_s``. From the device
events (kernels, copies, sets) of the trace:

- ``busy_s``: the union of their intervals (an interval counted once however
  many streams overlap in it);
- ``family_s``: device seconds by kernel family, the family from the
  kernel's name (``FAMILIES``, first match wins);
- ``breakdown``: the ten device operations with the most time, and the idle
  gaps (between busy intervals and at the window's ends, 20 us and longer)
  summed by what the host was doing at each gap's middle: the innermost host
  event (an operator, a CUDA runtime call or a benchmark span) that covers
  it. The metrics come from a window that traces the device and the CUDA
  runtime only; the gaps' names from a second, shorter window that traces
  the host's operators too, whose cost on the host shows in its gaps.
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional

import torch

FAMILIES = (  # (family, substrings of the device kernel name), first match wins
    ("conv3d_fwd (ours)", ("conv3d_fwd_",)),
    ("conv3d_dgrad (ours)", ("conv3d_dgrad_",)),
    ("conv3d_wgrad (ours)", ("conv3d_wgrad_",)),
    ("instnorm_fwd (ours)", ("in_fwd_kernel",)),
    ("instnorm_bwd (ours)", ("in_bwd_",)),
    ("soft_skel_fwd (ours)", ("skel_round_kernel",)),
    ("soft_skel_bwd (ours)", ("skel_bwd_",)),
    ("pooling", ("max_pool", "pool3d")),
    ("batch norm (library)", ("batch_norm", "bn_fw", "bn_bw")),
    ("library conv (cuDNN)", ("cudnn", "conv", "xmma", "gemm", "implicit", "wgrad", "dgrad",
                              "fprop", "nchwToNhwc", "nhwcToNchw")),
    # the conv wrapper's reflect pad on the library route (index_select), its
    # gradient's fold (index_add_) and the kernels' weight layouts (a gather)
    ("conv pad / layout", ("indexSelect", "indexFunc", "index_elementwise",
                           "_scatter_gather_elementwise")),
    ("upsample", ("upsample",)),
    ("concat / copy", ("cat", "copy", "Memcpy", "Memset")),
    ("elementwise / reduce", ("elementwise", "reduce", "Reduce", "index", "tanh")),
)
CONV_FAMILIES = ("conv3d_fwd (ours)", "conv3d_dgrad (ours)", "conv3d_wgrad (ours)",
                 "library conv (cuDNN)", "conv pad / layout")
NORM_FAMILIES = ("instnorm_fwd (ours)", "instnorm_bwd (ours)", "batch norm (library)")
MIN_GAP_NS = 20_000


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


class Window:
    """A profiler window between two ``synchronize()``s. ``host`` adds the
    host's operators and spans (to name what the host did in each idle gap),
    at a cost on the host that can leave the card waiting; without it only
    device activity and CUDA runtime calls are traced."""

    def __init__(self, host: bool = False):
        self.host = host
        self.prof = None
        self.t0 = self.t1 = None
        self.ns0 = self.ns1 = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if self.host else [])
        self.prof = profile(activities=acts)
        self.prof.start()
        torch.cuda.synchronize()
        self.t0, self.ns0 = time.perf_counter(), time.time_ns()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.t1, self.ns1 = time.perf_counter(), time.time_ns()
        self.prof.stop()

    def summary(self) -> "Summary":
        return Summary(self.prof.profiler.kineto_results.events(), self.t1 - self.t0,
                       (self.ns0, self.ns1))


class Summary:
    """``span_ns``: the window's ends on the host's clock (the profiler's
    timestamps are on it too): the idle time before the first and after the
    last device event counts as a gap at each end."""

    def __init__(self, events, window_s: float, span_ns=None):
        self.window_s = window_s
        dev, host = [], []
        for e in events:
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if e.is_user_annotation():  # a host span mirrored on the device
                    continue
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
            elif e.duration_ns() > 0:
                host.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        dev.sort()
        host.sort()
        self.family_s: Dict[str, float] = {}
        by_op: Dict[str, float] = {}
        for s, e, name in dev:
            sec = (e - s) / 1e9
            fam = family(name)
            self.family_s[fam] = self.family_s.get(fam, 0.0) + sec
            by_op[name] = by_op.get(name, 0.0) + sec
        busy, gaps = 0, []
        if span_ns and dev and not (span_ns[0] - 10**9 <= dev[0][0] and
                                    dev[-1][1] <= span_ns[1] + 10**9):
            span_ns = None  # the profiler's clock is not the host's: no ends
        if span_ns and dev:
            dev = [(max(a, span_ns[0]), min(b, span_ns[1]), n) for a, b, n in dev
                   if b > span_ns[0] and a < span_ns[1]]
            if dev and dev[0][0] - span_ns[0] >= MIN_GAP_NS:
                gaps.append((span_ns[0], dev[0][0]))
        cur_s = cur_e = None
        for s, e, _ in dev:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                    if s - cur_e >= MIN_GAP_NS:
                        gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
            if span_ns and span_ns[1] - cur_e >= MIN_GAP_NS:
                gaps.append((cur_e, span_ns[1]))
        self.busy_s = busy / 1e9
        self.device_ops = sorted(([n[:120], v] for n, v in by_op.items()),
                                 key=lambda kv: -kv[1])[:10]
        self.idle_gaps = _label_gaps(gaps, host)

    def seconds(self, families) -> float:
        return sum(self.family_s.get(f, 0.0) for f in families)

    def breakdown(self, labelled: "Summary" = None) -> dict:
        """The device operations of this window; the idle gaps of
        ``labelled`` (a window with the host traced) where given."""
        return {"device_ops": self.device_ops,
                "idle_gaps": (labelled or self).idle_gaps}


def _label_gaps(gaps: List, host: List) -> List:
    """Idle seconds summed by the innermost host event covering each gap's
    middle (the latest-starting one that still runs), top ten."""
    starts = [h[0] for h in host]
    out: Dict[str, float] = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        label: Optional[str] = None
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(-1, i - 4000), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        label = (label or "no host event")[:120]
        out[label] = out.get(label, 0.0) + (g1 - g0) / 1e9
    return sorted(([k, v] for k, v in out.items()), key=lambda kv: -kv[1])[:10]
