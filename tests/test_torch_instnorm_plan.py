"""The InstanceNorm forward kernel's plan (``instnorm.fwd_plan``, pure
Python) at every plane size of the path and at ragged ones, its constants
against the kernel's, and a CPU emulation of what the kernel computes from
it: each block's run of its plane (``_slices``, the geometry of
``csrc/instnorm_fwd.cu``'s ``in_fwd_kernel``), the block's Chan partial
(n, mean, M2), and the rank-order merge of the partials (``_chan_merge``, in
float32 as the kernel rounds it).

The emulation's statistics give ``instance_norm_act_plain``'s output within
f32 rounding (atol 1e-5, as the port's other InstanceNorm tests), including
the large-offset case of ``test_torch_instnorm.py`` (mean 50, std 0.1: atol
5e-5 against float64, where x - mean rounds at |x| ~ 50 before the scale).
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vangan_torch.ops import instnorm as I

BF16, F32 = torch.bfloat16, torch.float32

# plane edge -> (route, cluster, vectors per block, registers per thread,
# shared-memory vectors) for bf16 and f32; 31^3 is not a multiple of 16 bytes
PATH_PLANES = {
    (128, BF16): ("stream", 16, 16384, 2, 7168),
    (64, BF16): ("cluster", 8, 4096, 1, 4096),
    (32, BF16): ("cluster", 1, 4096, 1, 4096),
    (31, BF16): ("cluster", 1, 3725, 1, 3725),
    (16, BF16): ("small", 1, 512, 2, 0),
    (14, BF16): ("small", 1, 343, 2, 0),
    (8, BF16): ("small", 1, 64, 1, 0),
    (128, F32): ("stream", 16, 32768, 2, 7168),
    (64, F32): ("cluster", 16, 4096, 1, 4096),
    (32, F32): ("cluster", 2, 4096, 1, 4096),
    (31, F32): ("cluster", 2, 3725, 1, 3725),
    (16, F32): ("small", 1, 1024, 4, 0),
    (14, F32): ("small", 1, 686, 4, 0),
    (8, F32): ("small", 1, 128, 1, 0),
}
THREADS = {"small": I.FWD_SMALL_THREADS, "cluster": I.FWD_CLUSTER_THREADS,
           "stream": I.FWD_STREAM_THREADS}
KERNEL_SOURCE = Path(I.__file__).resolve().parent / "csrc" / "instnorm_fwd.cu"


def _aligned(n, dtype):
    return n * torch.empty((), dtype=dtype).element_size() % 16 == 0


def _check_plan(plan, n, dtype):
    """What every plan holds: one launch, blocks whose runs cover the plane,
    shared memory then registers, the rest re-read, and the sizes of its
    route's body in the kernel."""
    route, vpb, rpt, smem = plan.route, plan.vecs_per_block, plan.rpt, plan.smem_vecs
    assert plan.launches == 1 and plan.vec == 16 // (2 if dtype == BF16 else 4)
    assert plan.threads == THREADS[route]
    # the blocks' runs cover the plane (an unaligned plane may span one vector more)
    assert plan.elems_per_block == vpb * plan.vec
    slack = 0 if _aligned(n, dtype) else plan.vec - 1
    assert plan.cluster * plan.elems_per_block >= n + slack
    assert (plan.cluster - 1) * plan.elems_per_block < n
    # what a block holds: shared memory, then registers, the rest re-read
    on_chip = min(vpb, plan.threads * rpt + smem)
    assert plan.elems_on_chip == on_chip * plan.vec
    assert plan.reread_share == pytest.approx((vpb - on_chip) / vpb)
    assert plan.reread_share == 0 or route == "stream"
    assert plan.cluster <= I.FWD_CLUSTER_MAX
    if route == "small":
        assert (plan.cluster, smem) == (1, 0) and rpt in (1, 2, I.FWD_SMALL_VECS)
        assert vpb <= plan.threads * rpt
    else:
        # the smallest cluster whose blocks' runs fit a block's shared
        # memory; larger planes stream on the largest cluster
        fits = vpb <= I.FWD_CLUSTER_VECS
        assert fits == (route == "cluster")
        assert plan.cluster == 1 or -(-vpb * plan.cluster // (plan.cluster // 2)) > \
            I.FWD_CLUSTER_VECS
        assert fits or plan.cluster == I.FWD_CLUSTER_MAX
        assert smem == min(vpb, I.FWD_CLUSTER_VECS if fits else I.FWD_STREAM_SMEM)
        assert rpt == (1 if fits else I.FWD_STREAM_RPT)


@pytest.mark.parametrize("edge,dtype", list(PATH_PLANES), ids=lambda v: str(v))
def test_fwd_plan_at_path_planes(edge, dtype):
    n = edge ** 3
    plan = I.fwd_plan(n, dtype, _aligned(n, dtype))
    route, cluster, vpb, rpt, smem = PATH_PLANES[edge, dtype]
    assert (plan.route, plan.cluster, plan.vecs_per_block, plan.rpt, plan.smem_vecs) == \
        (route, cluster, vpb, rpt, smem)
    _check_plan(plan, n, dtype)
    assert (plan.reread_share > 0) == (route == "stream")


@pytest.mark.parametrize("dtype,reread", [(BF16, 0.5), (F32, 0.75)])
def test_fwd_plan_streams_what_no_cluster_holds(dtype, reread):
    """128^3 on a cluster of 16: each block keeps 7168 vectors in shared
    memory and 1024 in registers, and re-reads the rest."""
    plan = I.fwd_plan(128 ** 3, dtype, True)
    assert (plan.route, plan.cluster, plan.reread_share) == ("stream", 16, reread)
    assert plan.cluster * plan.elems_per_block == 128 ** 3
    assert plan.elems_on_chip == \
        (I.FWD_STREAM_SMEM + I.FWD_STREAM_THREADS * I.FWD_STREAM_RPT) * plan.vec


@pytest.mark.parametrize("dims,dtype,route,cluster,reread", [
    ((5, 7, 9), BF16, "small", 1, 0.0),          # unaligned
    ((33, 35, 37), BF16, "cluster", 2, 0.0),     # unaligned, a ragged last run
    ((40, 40, 40), BF16, "cluster", 2, 0.0),
    ((50, 50, 50), BF16, "cluster", 4, 0.0),     # a ragged last run
    ((90, 90, 90), BF16, "stream", 16, 0.0),     # the stream body, its runs held whole
    ((97, 101, 103), F32, "stream", 16, 1 - 8192 / 15768),  # unaligned, ragged
], ids=lambda v: str(v))
def test_fwd_plan_at_other_planes(dims, dtype, route, cluster, reread):
    """Planes off the path: ragged and unaligned ones, and planes between
    what a cluster holds in shared memory and what the stream blocks re-read
    (their runs fit the stream body whole)."""
    n = math.prod(dims)
    plan = I.fwd_plan(n, dtype, _aligned(n, dtype))
    assert (plan.route, plan.cluster) == (route, cluster)
    assert plan.reread_share == pytest.approx(reread)
    _check_plan(plan, n, dtype)


# fwd_plan's constants and the kernel's (csrc/instnorm_fwd.cu), which takes
# only the plans they make
KERNEL_CONSTANTS = {
    "SMALL_THREADS": "FWD_SMALL_THREADS", "SMALL_RPT_MAX": "FWD_SMALL_VECS",
    "CLUSTER_THREADS": "FWD_CLUSTER_THREADS", "CLUSTER_VECS": "FWD_CLUSTER_VECS",
    "STREAM_THREADS": "FWD_STREAM_THREADS", "STREAM_SMEM": "FWD_STREAM_SMEM",
    "STREAM_RPT": "FWD_STREAM_RPT", "MAX_CLUSTER": "FWD_CLUSTER_MAX",
}


@pytest.mark.parametrize("name", list(KERNEL_CONSTANTS))
def test_fwd_plan_constants_match_the_kernel(name):
    m = re.search(rf"constexpr int {name} = (\d+);", KERNEL_SOURCE.read_text())
    assert m, f"{name} not in {KERNEL_SOURCE.name}"
    assert int(m.group(1)) == getattr(I, KERNEL_CONSTANTS[name])


def test_fwd_plan_refuses_what_it_has_no_kernel_for():
    with pytest.raises(TypeError):
        I.fwd_plan(4096, torch.float16, True)
    with pytest.raises(ValueError):
        I.fwd_plan(0, F32, True)


def _slices(plane, n, plan):
    """The element runs ``[lo, hi)`` (within plane ``plane`` of ``n``
    elements) that the kernel's ``plan.cluster`` blocks take, in rank order:
    each block takes ``vecs_per_block`` vectors of the flat tensor from the
    plane's first, clipped to the plane (``lo = vfirst + rank * vpb`` in
    ``in_fwd_kernel``)."""
    e0, e1, v = plane * n, (plane + 1) * n, plan.vec
    vfirst, vend = e0 // v, -(-e1 // v)
    runs = []
    for rank in range(plan.cluster):
        lo = min(vfirst + rank * plan.vecs_per_block, vend)
        hi = min(lo + plan.vecs_per_block, vend)
        runs.append((max(lo * v, e0) - e0, max(min(hi * v, e1), e0) - e0))
    return runs


def _chan_merge(acc, part):
    """Chan's merge of the partial ``part`` (n, mean, M2) into ``acc``, in
    float32 as the kernel's ``chan_merge`` rounds it."""
    f = np.float32
    n, mean, m2 = (f(v) for v in acc)
    nb, mb, m2b = (f(v) for v in part)
    if nb == 0:
        return n, mean, m2
    if n == 0:
        return nb, mb, m2b
    nt = n + nb
    d = mb - mean
    frac = nb / nt
    return nt, mean + d * frac, m2 + (m2b + d * d * n * frac)


def _emulated_forward(x, gamma, beta, eps, act, alpha, plan):
    """What the kernel computes: per plane, each rank's Chan partial over its
    run (float64, rounded to f32), merged in rank order in f32; then the
    f32 affine and activation, rounded once to x's dtype."""
    b, c = x.shape[:2]
    n = math.prod(x.shape[2:])
    flat = x.reshape(b * c, n).double()
    covered = torch.zeros(b * c * n, dtype=torch.int32)
    y = torch.empty(b * c, n)
    for p in range(b * c):
        acc = (0.0, 0.0, 0.0)
        for lo, hi in _slices(p, n, plan):
            covered[p * n + lo:p * n + hi] += 1
            if hi > lo:
                run = flat[p, lo:hi]
                mean = run.mean()
                acc = _chan_merge(acc, (hi - lo, float(mean), float(((run - mean) ** 2).sum())))
        cnt, mean, m2 = acc
        inv = np.float32(1) / np.sqrt(max(m2 / cnt, np.float32(0)) + np.float32(eps),
                                      dtype=np.float32)
        a = np.float32(gamma[p % c]) * inv
        t = (x.reshape(b * c, n)[p].float() - float(mean)) * float(a) + float(beta[p % c])
        y[p] = torch.relu(t) if act == "relu" else (
            torch.where(t >= 0, t, alpha * t) if act == "leaky_relu" else t)
    assert bool((covered == 1).all())  # the runs tile the tensor: each element once
    return y.reshape(x.shape).to(x.dtype)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("shape", [
    (2, 3, 31, 31, 31),     # unaligned planes: runs share their end vectors
    (1, 2, 64, 64, 64),     # a cluster of 8 (bf16) / 16 (f32)
    (1, 2, 128, 128, 128),  # streamed on a cluster of 16
    (1, 1, 97, 101, 103),   # streamed, unaligned, a ragged last run
    (3, 5, 16, 16, 16),     # small
    (2, 3, 5, 7, 9),        # small and unaligned
])
@pytest.mark.parametrize("act", ["none", "leaky_relu"])
def test_emulated_slices_and_merge_match_plain(rng, dtype, shape, act):
    x = torch.from_numpy((rng.normal(size=shape) * 2 + 0.5).astype(np.float32)).to(dtype)
    gamma = torch.from_numpy((rng.normal(size=shape[1]) * 0.5 + 1).astype(np.float32))
    beta = torch.from_numpy((rng.normal(size=shape[1]) * 0.2).astype(np.float32))
    n = math.prod(shape[2:])
    plan = I.fwd_plan(n, dtype, _aligned(n, dtype))
    got = _emulated_forward(x, gamma, beta, 1e-3, act, 0.2, plan)
    want = I.instance_norm_act_plain(x, gamma, beta, 1e-3, act, 0.2)
    if dtype == F32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    else:
        # both round an f32 value to bf16 once; the two f32 values differ in
        # the last bits and may straddle a rounding boundary: one bf16 ulp
        w = want.float()
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=2 ** -100))) - 7)
        assert bool(((got.float() - w).abs() <= ulp).all())


def test_emulated_merge_large_offset(rng):
    """mean 50 >> std 0.1 over 16 ranks' runs: Chan's merge of centred
    partials keeps the variance (E[x^2] - mean^2 in f32 would not)."""
    x = torch.from_numpy((rng.normal(size=(1, 2, 128, 128, 128)) * 0.1 + 50).astype(np.float32))
    ones, zeros = torch.ones(2), torch.zeros(2)
    plan = I.fwd_plan(128 ** 3, F32, True)
    assert plan.cluster == 16
    got = _emulated_forward(x, ones, zeros, 1e-3, "none", 0.2, plan)
    x64 = x.double()
    mean = x64.mean(dim=(2, 3, 4), keepdim=True)
    var = ((x64 - mean) ** 2).mean(dim=(2, 3, 4), keepdim=True)
    np.testing.assert_allclose(got.numpy(), ((x64 - mean) / torch.sqrt(var + 1e-3)).numpy(),
                               atol=5e-5, rtol=0)
