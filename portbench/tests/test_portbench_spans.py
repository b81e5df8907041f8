"""Device time by the program's spans (``portbench/spans.py``) on synthetic
profiler events, and the idle gaps of a stitch profiled on the CPU named by
its spans."""

import time

import numpy as np
import pytest
import torch

from portbench import spans, trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Event:
    """What the readers take of a profiler event."""

    def __init__(self, device, name, start, end, corr=0, thread=1, annotation=False):
        self.args = device, name, start, end, corr, thread, annotation

    def device_type(self):
        return self.args[0]

    def name(self):
        return self.args[1]

    def start_ns(self):
        return self.args[2]

    def end_ns(self):
        return self.args[3]

    def duration_ns(self):
        return self.args[3] - self.args[2]

    def correlation_id(self):
        return self.args[4]

    def start_thread_id(self):
        return self.args[5]

    def is_user_annotation(self):
        return self.args[6]


class S:
    def __init__(self, name, start_ns, end_ns):
        self.name, self.start_ns, self.end_ns = name, start_ns, end_ns


SPANS = [S("step", 0, 100), S("step.forward", 10, 40), S("step.backward", 50, 90),
         S("conv.dgrad", 60, 70),  # opened on the autograd engine's thread
         S("train.drain", 95, 99)]


def test_device_events_count_under_the_spans_open_at_their_launch():
    events = [
        Event(CPU, "cudaLaunchKernel", 20, 22, corr=1),
        Event(CUDA, "k_fwd", 30, 35, corr=1),
        Event(CPU, "cudaLaunchKernel", 65, 66, corr=2, thread=2),  # the autograd thread
        Event(CUDA, "k_dgrad", 70, 77, corr=2),
        Event(CPU, "cudaMemcpyAsync", 96, 98, corr=3),
        Event(CUDA, "Memcpy DtoH", 96, 97, corr=3),
        Event(CPU, "cudaLaunchKernel", 120, 121, corr=4),  # after every span
        Event(CUDA, "k_late", 130, 141, corr=4),
        Event(CUDA, "k_unlaunched", 150, 163, corr=5),  # its runtime call not traced
        Event(CUDA, "step.forward", 30, 35, annotation=True),  # a mirrored span: no work
        Event(CPU, "aten::mm", 20, 23, corr=1),  # an operator, not a runtime call
    ]
    device, launches = spans.from_events(events)
    assert [d.name for d in device] == ["k_fwd", "k_dgrad", "Memcpy DtoH", "k_late",
                                        "k_unlaunched"]
    assert [c.name for c in launches] == ["cudaLaunchKernel"] * 2 + ["cudaMemcpyAsync",
                                                                     "cudaLaunchKernel"]
    names = spans.attribute(device, launches, SPANS)
    assert names == [{"step", "step.forward"}, {"step", "step.backward", "conv.dgrad"},
                     {"step", "train.drain"}, set(), set()]
    assert spans.device_ns(device, names) == {
        "step": 5 + 7 + 1, "step.forward": 5, "step.backward": 7, "conv.dgrad": 7,
        "train.drain": 1, "": 11 + 13}


@pytest.mark.parametrize("t, want", [(0, {"step"}), (40, {"step", "step.forward"}),
                                     (41, {"step"}), (100, {"step"}), (101, set()),
                                     (-1, set())])
def test_a_span_holds_both_its_ends(t, want):
    assert spans.open_at(SPANS, [t]) == [want]


def test_calls_inside_a_span_read_their_margins():
    calls = [spans.Launch(1, 96, 98, 1, "cudaMemcpyAsync"),
             spans.Launch(2, 98, 101, 1, "cudaStreamSynchronize"),  # past the span's end
             spans.Launch(3, 10, 20, 1, "cudaMemcpyAsync")]  # in no drain
    assert spans.inside(calls, SPANS, "train.drain") == [(1, 1), (3, -2)]


def test_a_stitch_profiled_on_the_cpu_names_its_idle_gap_by_the_span(monkeypatch):
    """The spans are host events of a real profile: with the card's work put
    from the stitch's start to the download's and the download slowed, the
    labelled window's one idle gap carries the name ``stitch.download``."""
    from torch.profiler import ProfilerActivity, profile

    from vangan_torch.inference import stitcher
    from vangan_torch.monitor import profiling

    slow = 0.05
    numpy = torch.Tensor.numpy

    def slow_numpy(self, *args, **kwargs):
        time.sleep(slow)
        return numpy(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "numpy", slow_numpy)
    vol = np.random.default_rng(0).uniform(size=(12, 12, 12, 1)).astype(np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.recording() as rec:
            stitcher.stitch_subvolumes(lambda p: p, vol, (2, 8, 8, 8, 1), stride=(4, 4, 4),
                                       complete=True, padFactor=0.25, blend="gaussian",
                                       batch_size=2, save=False, device="cpu")
    by = {s.name: s for s in rec}
    whole, down = by["stitch"], by["stitch.download"]
    assert (down.end_ns - down.start_ns) / 1e9 >= slow
    busy = Event(CUDA, "k", whole.start_ns, down.start_ns)
    window_s = (whole.end_ns - whole.start_ns) / 1e9
    labelled = trace.Summary(list(prof.profiler.kineto_results.events()) + [busy], window_s,
                             (whole.start_ns, whole.end_ns))
    assert [name for name, _ in labelled.idle_gaps] == ["stitch.download"]
    assert labelled.idle_gaps[0][1] == pytest.approx((whole.end_ns - down.start_ns) / 1e9)
