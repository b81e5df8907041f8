"""The work counts against hand counts, and shares that cannot pass 100%."""

import json
import math
import os

import pytest
import torch
import torch.nn.functional as F

from conftest import REPO

from portbench import work
from portbench.reference.layers import (Ctx, batch_norm, conv, conv_transpose, instance_norm,
                                        same_pads, uniform)
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
    assert got.norm_bytes == 0


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
    assert got.norm_bytes == (2 + 3) * n * 2
    assert got.norm_bound_s == pytest.approx(5 * n * 2 / 3.35e12)
    assert work.tally(_record(lambda c: instance_norm(c, x.detach(), g, b)), 2).norm_bytes == 4 * n


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


def test_a_transposed_conv_and_a_batch_norm_match_torch():
    """float32: the transposed conv is ``F.conv_transpose3d``; the BatchNorm
    is ``F.batch_norm`` in training (eps 1e-3, normalised by the biased
    variance), forward and backward."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 6, 4, 4, 4, generator=g, requires_grad=True)
    w = torch.randn(6, 3, 2, 2, 2, generator=g, requires_grad=True)
    b = torch.randn(3, generator=g, requires_grad=True)
    got = conv_transpose(Ctx(), x, w, b, 2)
    want = F.conv_transpose3d(x, w, b, stride=2)
    assert got.shape == (2, 3, 8, 8, 8)
    assert torch.equal(got, want)
    gamma = torch.rand(6, generator=g).add_(0.5).requires_grad_()
    beta = torch.randn(6, generator=g, requires_grad=True)
    dy = torch.randn(2, 6, 4, 4, 4, generator=g)
    got = batch_norm(Ctx(), x, gamma, beta)
    grads = torch.autograd.grad(got, (x, gamma, beta), dy)
    want = F.batch_norm(x, None, None, gamma, beta, training=True, eps=1e-3)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    for a, e in zip(grads, torch.autograd.grad(want, (x, gamma, beta), dy)):
        assert torch.allclose(a, e, rtol=1e-4, atol=1e-5)


def test_a_2x2x2_stride_2_transposed_conv_forward_and_both_gradients():
    """2 B Ci Co k^3 FLOPs on the input voxels (not the output's: that would
    be 8x here), each pass's operands once."""
    meta = torch.device("meta")
    x = torch.empty(3, 64, 32, 32, 32, device=meta, requires_grad=True)
    w = torch.empty(64, 32, 2, 2, 2, device=meta, requires_grad=True)
    rec = _record(lambda c: conv_transpose(c, x, w, None, 2))
    assert rec[0][0] == "conv_transpose" and rec[0][3] == (3, 32, 64, 64, 64)
    got = work.tally(rec, act_bytes=2)
    flops = 2 * 3 * 64 * 32 * 8 * 32 ** 3  # per pass
    assert got.conv_flops == 3 * flops
    xb, wb, yb = 3 * 64 * 32 ** 3 * 2, 64 * 32 * 8 * 2, 3 * 32 * 64 ** 3 * 2
    bounds = [max(flops / 989e12, (xb + wb + yb) / 3.35e12),
              max(flops / 989e12, (yb + wb + xb) / 3.35e12),
              max(flops / 989e12, (xb + yb + 64 * 32 * 8 * 4) / 3.35e12)]
    assert got.conv_bound_s == pytest.approx(sum(bounds), rel=1e-12)
    assert got.norm_bytes == 0
    fwd = work.tally(rec, act_bytes=2, backward=False)
    assert fwd.conv_flops == flops
    assert fwd.conv_bound_s == pytest.approx(bounds[0], rel=1e-12)


def test_a_batch_norm_forward_and_backward():
    meta = torch.device("meta")
    x = torch.empty(3, 32, 64, 64, 64, device=meta, requires_grad=True)
    g, b = torch.empty(32, device=meta), torch.empty(32, device=meta)
    rec = _record(lambda c: batch_norm(c, x, g, b))
    assert rec == [("bn", (3, 32, 64, 64, 64), True)]
    got = work.tally(rec, 2)
    n = 3 * 32 * 64 ** 3
    assert got.norm_bytes == (2 + 3) * n * 2
    assert got.norm_bound_s == pytest.approx(5 * n * 2 / 3.35e12)
    assert got.conv_flops == 0 and got.conv_bound_s == 0
    assert work.tally(_record(lambda c: batch_norm(c, x.detach(), g, b)), 2).norm_bytes == 4 * n


def test_an_unknown_record_is_refused():
    with pytest.raises(ValueError):
        work.tally([("pool", (1, 1, 2, 2, 2), True)], 2)


# (train step: conv FLOPs, conv bound s, norm bytes; gen_IS patch: the same)
# as counted before transposed convs and BatchNorm had record kinds
STEP_COUNTS = {
    "vangan_resunet": (16607631900672.0, 0.0252119558568077, 47185920000.0,
                       299305533440.0, 0.000539513536986131, 1428160512.0),
    "vangan_resnet": (51340495552512.0, 0.05304210157770193, 27116175360.0,
                      1278826512384.0, 0.001313850839905709, 759169024.0),
}


@pytest.mark.parametrize("config", sorted(STEP_COUNTS))
def test_the_configurations_step_counts_are_unchanged(config):
    """16.61 and 51.34 TFLOP a 3 x 128^3 step; 299.3 and 1279 GFLOP a patch."""
    with open(os.path.join(REPO, "portbench", "configs", config + ".json")) as f:
        fields = json.load(f)["fields"]
    step = work.train_step_work(fields, 3, (128, 128, 128))
    gen = work.generator_work(fields, (128, 128, 128))
    assert (step.conv_flops, step.conv_bound_s, step.norm_bytes, gen.conv_flops,
            gen.conv_bound_s, gen.norm_bytes) == STEP_COUNTS[config]


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
