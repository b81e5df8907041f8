"""The work counts against hand counts, and shares that cannot pass 100%."""

import math

import pytest
import torch

from portbench import work
from portbench.reference.layers import Ctx, conv, instance_norm, same_pads, uniform
from portbench.trace import Summary


def _record(fn):
    rec = []
    fn(Ctx(record=rec))
    return rec


def test_a_3x3x3_conv_forward_and_both_gradients():
    meta = torch.device("meta")
    x = torch.empty(3, 16, 64, 64, 64, device=meta, requires_grad=True)
    w = torch.empty(32, 16, 3, 3, 3, device=meta, requires_grad=True)
    rec = _record(lambda c: conv(c, x, w, None, 2, uniform(1), "reflect"))
    got = work.tally(rec, act_bytes=2)
    out_vox = 32 ** 3
    flops = 2 * 3 * 32 * out_vox * 16 * 27  # per pass
    assert rec[0][3] == (3, 32, 32, 32, 32)
    assert got.conv_flops == 3 * flops
    xb, wb, yb = 3 * 16 * 64 ** 3 * 2, 32 * 16 * 27 * 2, 3 * 32 * out_vox * 2
    bounds = [max(flops / 989e12, (xb + wb + yb) / 3.35e12),
              max(flops / 989e12, (yb + wb + xb) / 3.35e12),
              max(flops / 989e12, (xb + yb + 32 * 16 * 27 * 4) / 3.35e12)]
    assert got.conv_bound_s == pytest.approx(sum(bounds), rel=1e-12)
    assert got.in_bytes == 0


def test_a_7x7x7_head_forward_only_without_gradients():
    meta = torch.device("meta")
    x = torch.empty(3, 32, 128, 128, 128, device=meta)
    w = torch.empty(1, 32, 7, 7, 7, device=meta)
    got = work.tally(_record(lambda c: conv(c, x, w, None, 1, uniform(3), "reflect")), 2)
    flops = 2 * 3 * 1 * 128 ** 3 * 32 * 343
    assert got.conv_flops == flops  # 138.1 GFLOP
    assert flops == pytest.approx(138.1e9, rel=1e-3)
    nbytes = (3 * 32 * 128 ** 3 + 32 * 343 + 3 * 128 ** 3) * 2
    assert got.conv_bound_s == pytest.approx(max(flops / 989e12, nbytes / 3.35e12))


def test_a_4x4x4_same_conv_weight_gradient_only():
    meta = torch.device("meta")
    x = torch.empty(2, 8, 16, 16, 16, device=meta)  # data: no input gradient
    w = torch.empty(4, 8, 4, 4, 4, device=meta, requires_grad=True)
    rec = _record(lambda c: conv(c, x, w, None, 1, same_pads((16, 16, 16), 4, 1)))
    assert rec[0][3] == (2, 4, 16, 16, 16)
    assert work.tally(rec, 2).conv_flops == 2 * (2 * 2 * 4 * 16 ** 3 * 8 * 64)


def test_an_instance_norm_forward_and_backward():
    meta = torch.device("meta")
    x = torch.empty(3, 32, 64, 64, 64, device=meta, requires_grad=True)
    g, b = torch.empty(32, device=meta), torch.empty(32, device=meta)
    got = work.tally(_record(lambda c: instance_norm(c, x, g, b, "relu")), 2)
    n = 3 * 32 * 64 ** 3
    assert got.in_bytes == (2 + 3) * n * 2
    assert got.in_bound_s == pytest.approx(5 * n * 2 / 3.35e12)
    assert work.tally(_record(lambda c: instance_norm(c, x.detach(), g, b)), 2).in_bytes == 4 * n


def test_the_step_counts_do_not_depend_on_the_route():
    """The counts come from shapes alone: the same for float32 and bfloat16
    compute (FLOPs), and a train step of config 2 is ~16.6 TFLOP."""
    f = dict(gen_filters=16, disc_filters=64, gen_i2s="resUnet", gen_s2i="resUnet",
             lambda_cycle=10.0, lambda_topology=5.0, lambda_reconstruction=5.0,
             cldice_iters=15, cldice_alpha=0.5)
    bf = work.train_step_work(dict(f, compute_dtype="bfloat16"), 3, (128, 128, 128))
    f32 = work.train_step_work(dict(f, compute_dtype="float32"), 3, (128, 128, 128))
    assert bf.conv_flops == f32.conv_flops
    assert bf.conv_flops == pytest.approx(16.61e12, rel=1e-3)
    # 4 generator calls of 299.3 GFLOP a patch forward: forward work of the gens
    gen = work.generator_work(dict(f, compute_dtype="bfloat16"), (128, 128, 128))
    assert gen.conv_flops == pytest.approx(299.3e9, rel=1e-3)


class _Ev:
    def __init__(self, dev, s, d, name):
        self._dev, self._s, self._d, self._n = dev, s, d, name

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._dev else torch.autograd.DeviceType.CPU)

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def name(self):
        return self._n

    def is_user_annotation(self):
        return False


def test_busy_time_is_the_union_and_gaps_are_labelled_by_the_host():
    evs = [_Ev(True, 0, 100_000, "conv3d_fwd_mma_kernel"),
           _Ev(True, 50_000, 100_000, "in_fwd_kernel"),  # overlaps: counted once
           _Ev(True, 400_000, 100_000, "cudnn_conv"),
           _Ev(False, 0, 1_000_000, "portbench.stitch_volume"),
           _Ev(False, 200_000, 100_000, "cudaStreamSynchronize")]
    s = Summary(evs, window_s=1e-3)
    assert s.busy_s == pytest.approx(250e-6)
    assert s.family_s["conv3d_fwd (ours)"] == pytest.approx(100e-6)
    assert s.family_s["library conv (cuDNN)"] == pytest.approx(100e-6)
    assert s.idle_gaps == [["cudaStreamSynchronize", pytest.approx(250e-6)]]
    assert s.device_ops[0][1] == pytest.approx(100e-6)
    assert not math.isnan(s.busy_s)


@pytest.mark.parametrize("name", [
    "void at::native::indexFuncLargeIndex<c10::BFloat16, long, unsigned int, 3, 3, -2, true>",
    "void at::native::_scatter_gather_elementwise_kernel<128, 8, at::native::_cuda_scatter_ga",
    "void at::native::indexSelectLargeIndex<c10::BFloat16, long, unsigned int, 2, 2, -2, true>",
    "void at::native::index_elementwise_kernel<128, 4, at::native::gpu_index_kernel<>>",
])
def test_conv_wrapper_gathers_count_as_conv_time(name):
    """The reflect pad of the library route, its gradient's fold and the
    weight layouts are the conv layer's work: a kernel that takes them
    inside must not read a lower conv roofline."""
    from portbench.trace import CONV_FAMILIES, family

    assert family(name) == "conv pad / layout"
    assert family(name) in CONV_FAMILIES
