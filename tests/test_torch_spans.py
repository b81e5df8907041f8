"""The port's spans (``vangan_torch.monitor.profiling``): free while nothing
records or profiles; recorded in order, with their parents, by
``recording()``, from any thread; in the torch profiler's trace by name.
CPU, tiny sizes."""

from __future__ import annotations

import json
import math
import os
import threading
from collections import Counter

import numpy as np
import pytest
import torch

from vangan_torch.config import VanGanConfig
from vangan_torch.inference.stitcher import stitch_origins, stitch_subvolumes
from vangan_torch.models import layers
from vangan_torch.monitor import profiling
from vangan_torch.ops.conv3d import conv3d
from vangan_torch.vangan import VanGan

PHASES = ["step.generators", "step.cycle_losses", "step.discriminators",
          "step.adversarial_losses"]


def _batch(rng, b=2, k=16):
    x = rng.uniform(-1, 1, (b, k, k, k, 1)).astype(np.float32)
    y = np.where(rng.uniform(size=x.shape) > 0.7, 1.0, -1.0).astype(np.float32)
    return x, y


def test_with_nothing_on_a_span_is_a_shared_no_op_and_calls_no_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler API was called")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_record_function", refuse)
    monkeypatch.setattr(profiling.time, "time_ns", refuse)
    assert profiling.span("a") is profiling.span("b")
    x = torch.randn(1, 2, 6, 6, 6, requires_grad=True)
    w = torch.randn(3, 2, 3, 3, 3, requires_grad=True)
    conv3d(x, w).sum().backward()
    with profiling.recording() as spans:
        pass
    assert spans == []


def test_a_train_step_records_its_phase_tree_in_order(monkeypatch):
    calls = []
    forward = layers.ConvND.forward

    def counted(self, *args, **kwargs):
        calls.append(self)
        return forward(self, *args, **kwargs)

    monkeypatch.setattr(layers.ConvND, "forward", counted)
    cfg = VanGanConfig(BATCH_SIZE=2, micro_batches=2, SUBVOL_PATCH_SIZE=(16, 16, 16),
                       gen_filters=2, disc_filters=4, cldice_iters=2, compute_dtype="float32")
    gan = VanGan(cfg, device="cpu")
    with profiling.recording() as spans:
        gan.distributed_train_step(*_batch(np.random.default_rng(0)), 0.1, True)
    names = [s.name for s in spans]
    steps = [i for i, s in enumerate(spans) if not s.name.startswith("conv.")]
    slice_ = ["step.forward", *PHASES, "step.backward"]
    assert [names[i] for i in steps] == ["step", *slice_, *slice_, "step.optimizer"]
    top = steps[0]
    for i in steps[1:]:
        want = top if names[i] in ("step.forward", "step.backward", "step.optimizer") else None
        if want is None:  # a phase of compute_losses: under its slice's step.forward
            want = max(j for j in steps if j < i and names[j] == "step.forward")
        assert spans[i].parent == want, names[i]
    assert spans[top].parent == -1
    assert names.count("conv.forward") == len(calls) > 0
    for s in spans:
        assert s.start_ns <= s.end_ns and s.thread == threading.get_native_id()
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    # the forward convs sit in the forward's phases, the backward's in step.backward
    phase = {i: names[i] for i in steps}
    for s in spans:
        if s.name == "conv.forward":
            assert phase[s.parent] in ("step.generators", "step.discriminators")
        elif s.name.startswith("conv."):
            assert phase[s.parent] == "step.backward"
    assert Counter(names)["conv.wgrad"] > 0 and Counter(names)["conv.dgrad"] > 0


def test_backward_spans_on_another_thread_are_recorded():
    x = torch.randn(1, 2, 6, 6, 6, requires_grad=True)
    w = torch.randn(3, 2, 3, 3, 3, requires_grad=True)
    y = conv3d(x, w, torch.zeros(3, requires_grad=True))
    done = []

    def backward():
        y.sum().backward()  # on the CPU autograd runs on the calling thread
        done.append(threading.get_native_id())

    with profiling.recording() as spans:
        with profiling.span("step.backward"):
            t = threading.Thread(target=backward)
            t.start()
            t.join(timeout=60)
        with pytest.raises(RuntimeError, match="already open"):
            with profiling.recording():
                pass
    assert not t.is_alive() and done
    assert [s.name for s in spans] == ["step.backward", "conv.dgrad", "conv.wgrad"]
    assert [s.thread for s in spans[1:]] == done * 2
    assert [s.parent for s in spans] == [-1, -1, -1]  # no span of their own thread held
    assert x.grad is not None and w.grad is not None


def test_a_stitch_records_its_phases_once_and_a_span_per_batch():
    rng = np.random.default_rng(1)
    vol = rng.uniform(0, 1, (20, 18, 17, 1)).astype(np.float32)
    batch, k, stride, pad = 4, 16, (8, 8, 8), 0.25
    with profiling.recording() as spans:
        out = stitch_subvolumes(lambda p: 0.5 * p, vol, (batch, k, k, k, 1), stride=stride,
                                complete=True, padFactor=pad, blend="gaussian",
                                batch_size=batch, save=False, device="cpu")
    padded = [n + 2 * int(pad * n) for n in vol.shape[:3]]
    unique = len(set(stitch_origins(padded, (k, k, k), stride)))
    got = Counter(s.name for s in spans)
    assert got == {"stitch": 1, "stitch.pad": 1, "stitch.upload": 1, "stitch.download": 1,
                   "stitch.normalize": 1, "stitch.batch": math.ceil(unique / batch)}
    assert spans[0].name == "stitch" and all(s.parent == 0 for s in spans[1:])
    assert [s.name for s in spans if s.name != "stitch.batch"][1:] == [
        "stitch.upload", "stitch.pad", "stitch.normalize", "stitch.download"]
    assert out.shape == vol.shape


@pytest.mark.parametrize("what", ["conv", "stitch"])
def test_profile_dir_traces_hold_the_span_names(tmp_path, what):
    rng = np.random.default_rng(2)
    with profiling.trace(str(tmp_path)):
        if what == "conv":
            conv = layers.ConvND(1, 2, 3)
            conv(torch.randn(1, 1, 5, 5, 5)).sum().backward()
            want = {"conv.forward", "conv.wgrad"}  # the input needs no gradient
        else:
            stitch_subvolumes(lambda p: p, rng.uniform(size=(12, 12, 12, 1)), (2, 8, 8, 8, 1),
                              stride=(4, 4, 4), complete=True, padFactor=0.25,
                              blend="uniform", batch_size=2, save=False, device="cpu")
            want = {"stitch", "stitch.pad", "stitch.upload", "stitch.batch",
                    "stitch.download", "stitch.normalize"}
    (trace,) = os.listdir(tmp_path)
    with open(tmp_path / trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert want <= names
    assert profiling.span("a") is profiling.span("b")  # off again after the trace


def test_an_s2i_block_a_deconv_and_a_max_pool_record_their_spans_in_order():
    """The V-Net's library layers: each BatchNorm of a block opens
    ``batchnorm.forward``, the transposed conv ``deconv.forward`` and the
    max-pool ``maxpool.forward``, each under no span of its own."""
    from vangan_torch.models.vnet import VNetConvBlock

    block = VNetConvBlock(1, 2, use_batch_norm=True, dropout=0.0)
    deconv = layers.ConvTranspose(2, 2, 2, 2)
    x = torch.randn(2, 1, 6, 6, 6)
    with profiling.recording() as spans:
        y = layers.max_pool_2x(deconv(block(x, train=True)))
        y.sum().backward()
    names = [s.name for s in spans if not s.name.startswith("conv.")]
    assert names == ["batchnorm.forward", "batchnorm.forward", "deconv.forward",
                     "maxpool.forward"]
    assert all(s.parent == -1 for s in spans)
    assert y.shape == (2, 2, 6, 6, 6)


def test_outside_a_recording_the_v_net_layers_call_no_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler API was called")

    monkeypatch.setattr(profiling, "_record_function", refuse)
    monkeypatch.setattr(profiling.time, "time_ns", refuse)
    assert profiling.span("batchnorm.forward") is profiling.span("deconv.forward")
    bn = layers.BatchNorm(2)
    x = torch.randn(2, 2, 4, 4, 4)
    y = layers.max_pool_2x(layers.ConvTranspose(2, 2, 2, 2)(bn(x, train=True)))
    assert y.shape == (2, 2, 4, 4, 4)
    assert bn.mean.abs().sum() > 0  # the training call moved the running statistics
