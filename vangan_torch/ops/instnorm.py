"""InstanceNorm + activation: hand-written CUDA kernels (forward and backward)
and their plain versions.

``instance_norm_act`` is the counterpart of
``vangan_tpu.ops.pallas.instnorm.instance_norm_act`` on torch's
``(B, C, X, Y, Z)`` layout: per-(b, c) mean and variance over X, Y, Z in f32,
then ``act((x - mean) * a + beta)`` with ``a = gamma * rsqrt(var + eps)``
and act in {none, relu, leaky_relu}, written in the input dtype. On a CUDA
tensor it launches ``csrc/instnorm_fwd.cu`` (see the note there) once, on
the route ``fwd_plan`` (pure Python) gives the plane size: one block per
small plane, one thread-block cluster per plane that the cluster holds on
chip, or a cluster that streams what it cannot hold; on a CPU tensor it runs
``instance_norm_act_plain``.

Where a gradient is needed the op is a ``torch.autograd.Function``: the
forward keeps (mean, a, beta, inv) per (b, c), and the backward launches
``csrc/instnorm_bwd.cu`` (the TPU kernels ``bwd_reduce_sums`` and ``bwd_dx``)
for dx, with dgamma and dbeta the plain sums over b of its per-(b, c) sums;
on a CPU tensor it runs ``instance_norm_act_bwd_plain``. ``bwd_plan`` (pure
Python) says how the backward runs a shape: one block per small plane, or a
reduce pass and a dx pass over every plane.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from vangan_torch.ops import build

# kernel launches (chip_smoke.py reads and resets them)
launches = 0          # instance_norm_act forward calls
fwd_kernel_launches = 0  # the forward's kernel launches, as its C entry reports them
bwd_launches = 0      # backward calls (bwd_plan(...).launches kernel launches each)

ACTS = {"none": 0, "relu": 1, "leaky_relu": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ELEMS_PER_BLOCK = 16384  # reduce / dx work per block along a (b, c) plane

# the backward's plan (csrc/instnorm_bwd.cu)
BWD_THREADS = 256
BWD_SMALL_VECS = 4             # 16-byte vectors per thread and tensor a small plane's block holds
BWD_MAX_SPLIT = BWD_THREADS    # a dx block adds its plane's partials, one per thread


# the forward's plan (csrc/instnorm_fwd.cu, which holds the same constants);
# sizes in 16-byte vectors, chosen by timing alternatives on the H100
# (PERF.md)
FWD_ROUTES = {"small": 0, "cluster": 1, "stream": 2}
FWD_SMALL_THREADS = 256
FWD_SMALL_VECS = 4         # per thread: a small plane is at most 1024 vectors
FWD_CLUSTER_THREADS = 256  # a cluster's block
FWD_CLUSTER_VECS = 4096    # its run, in shared memory (64 KiB: three blocks an SM)
FWD_STREAM_THREADS = 512   # a streaming cluster's block
FWD_STREAM_SMEM = 7168     # what it keeps in shared memory (112 KiB: two blocks an SM)
FWD_STREAM_RPT = 2         # and in registers, per thread
FWD_CLUSTER_MAX = 16       # the non-portable size


@dataclass(frozen=True)
class FwdPlan:
    """How the forward kernel runs planes of one size (``fwd_plan``).

    ``route``: ``"small"`` (one block of ``threads`` per plane, in
    registers), ``"cluster"`` (a cluster of ``cluster`` blocks per plane,
    the plane on chip) or ``"stream"`` (a cluster of ``FWD_CLUSTER_MAX``
    larger blocks that keeps the head of each block's run on chip and reads
    the rest, if any, twice). A block takes
    ``vecs_per_block`` 16-byte vectors (``vec`` elements each) of its plane:
    ``smem_vecs`` in shared memory, up to ``threads * rpt`` in registers, the
    rest streamed. ``elems_per_block`` and ``elems_on_chip`` count elements;
    ``reread_share`` is the share of a plane that is read twice.
    ``launches`` is the kernel launches of one call.
    """
    route: str
    cluster: int
    threads: int
    vec: int
    vecs_per_block: int
    rpt: int
    smem_vecs: int
    elems_per_block: int
    elems_on_chip: int
    reread_share: float
    launches: int = 1


@functools.lru_cache(maxsize=1024)
def fwd_plan(n: int, dtype: torch.dtype, aligned: bool) -> FwdPlan:
    """The forward's route for planes of ``n`` elements of ``dtype``;
    ``aligned``: every plane starts on a 16-byte boundary (else a plane may
    span one vector more). Planes of up to ``FWD_SMALL_VECS`` vectors per
    thread of a small block take one block, in registers; larger ones the
    smallest cluster (a power of two, up to ``FWD_CLUSTER_MAX``) whose blocks
    hold their runs of up to ``FWD_CLUSTER_VECS`` in shared memory; planes
    larger still (128^3) a cluster of ``FWD_CLUSTER_MAX`` streaming blocks, two
    an SM, that keep ``FWD_STREAM_SMEM`` vectors in shared memory and
    ``FWD_STREAM_RPT`` a thread in registers and read the rest twice: on the
    H100 they took 128^3 bf16 planes in less time than a cluster of 16 that
    holds the whole plane, one block an SM (PERF.md)."""
    if dtype not in _DTYPES:
        raise TypeError(f"fwd_plan: no kernel for {dtype}")
    if n < 1:
        raise ValueError(f"fwd_plan: no plane of {n} elements")
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    vecs = -(-(n + (0 if aligned else vec - 1)) // vec)  # the most a plane spans
    if vecs <= FWD_SMALL_THREADS * FWD_SMALL_VECS:
        route, cs, threads, smem = "small", 1, FWD_SMALL_THREADS, 0
        rpt = 1 << (-(-vecs // threads) - 1).bit_length()
    else:
        cs = 1
        while cs < FWD_CLUSTER_MAX and -(-vecs // cs) > FWD_CLUSTER_VECS:
            cs *= 2
        if -(-vecs // cs) <= FWD_CLUSTER_VECS:
            route, threads, rpt, smem = "cluster", FWD_CLUSTER_THREADS, 1, FWD_CLUSTER_VECS
        else:
            route, threads, rpt, smem = ("stream", FWD_STREAM_THREADS, FWD_STREAM_RPT,
                                         FWD_STREAM_SMEM)
    vpb = -(-vecs // cs)
    smem = min(vpb, smem)
    kept = min(vpb, smem + threads * rpt)
    return FwdPlan(route, cs, threads, vec, vpb, rpt, smem, vpb * vec, kept * vec,
                   (vpb - kept) / vpb)


@dataclass(frozen=True)
class BwdPlan:
    """How the backward kernel runs one shape (``bwd_plan``).

    ``route``: ``"small"``, one block per (b, c) plane holding x and g in
    registers (``vpt`` vectors of ``vec`` elements per thread and tensor),
    one launch; or ``"split"``, a reduce launch and a dx launch of
    ``nsplit`` blocks per plane over every plane. ``vec`` is 1 for planes
    that are not 16-byte aligned. ``launches`` is the kernel launches of one
    call.
    """
    route: str
    vec: int
    vpt: int = 0
    nsplit: int = 0
    launches: int = 1


@functools.lru_cache(maxsize=1024)
def bwd_plan(n: int, dtype: torch.dtype, aligned: bool = True) -> BwdPlan:
    """The backward's route for planes of ``n`` elements: planes of up to
    ``BWD_SMALL_VECS`` vectors per thread (the 16^3 and 8^3 levels in bf16)
    take one block each; larger ones take two passes of ``nsplit`` blocks
    per plane."""
    if dtype not in _DTYPES:
        raise TypeError(f"bwd_plan: no kernel for {dtype}")
    esize = torch.empty((), dtype=dtype).element_size()
    vec = 16 // esize if aligned else 1
    per_thread = -(-n // (vec * BWD_THREADS))
    if per_thread <= BWD_SMALL_VECS:
        return BwdPlan("small", vec, vpt=1 << (per_thread - 1).bit_length())
    return BwdPlan("split", vec, nsplit=_nsplit(n), launches=2)


def instance_norm_act_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                            eps: float = 1e-3, act: str = "none",
                            alpha: float = 0.2) -> torch.Tensor:
    """The plain version: f32 statistics and affine (f64 for a f64 ``x``),
    output in ``x.dtype``."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {sorted(ACTS)}, got {act!r}")
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    var, mean = torch.var_mean(xf, dim=(2, 3, 4), unbiased=False, keepdim=True)
    shape = (1, -1, 1, 1, 1)
    a = gamma.to(acc).reshape(shape) * torch.rsqrt(var + eps)
    y = (xf - mean) * a + beta.to(acc).reshape(shape)
    if act == "relu":
        y = torch.relu(y)
    elif act == "leaky_relu":
        y = torch.where(y >= 0, y, alpha * y)
    return y.to(x.dtype)


def instance_norm_act_bwd_plain(x: torch.Tensor, g: torch.Tensor, gamma: torch.Tensor,
                                beta: torch.Tensor, eps: float = 1e-3, act: str = "none",
                                alpha: float = 0.2):
    """The plain backward: (dx in ``x.dtype``, dgamma, dbeta in f32) for the
    cotangent ``g`` of ``instance_norm_act_plain``, with g' = g * act'(pre),
    xhat = (x - mean) * inv and dx = a * (g' - mean(g') - xhat * mean(xhat g'))."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {sorted(ACTS)}, got {act!r}")
    dims = (2, 3, 4)
    xf, gf = x.float(), g.float()
    var, mean = torch.var_mean(xf, dim=dims, unbiased=False, keepdim=True)
    shape = (1, -1, 1, 1, 1)
    inv = torch.rsqrt(var + eps)
    a = gamma.float().reshape(shape) * inv
    pre = (xf - mean) * a + beta.float().reshape(shape)
    if act == "relu":
        gf = torch.where(pre > 0, gf, 0.0)
    elif act == "leaky_relu":
        gf = torch.where(pre >= 0, gf, alpha * gf)
    xhat = (xf - mean) * inv
    sum_g = gf.sum(dim=dims, keepdim=True)
    sum_xg = (xhat * gf).sum(dim=dims, keepdim=True)
    n = math.prod(x.shape[2:])
    dx = a * (gf - sum_g / n - xhat * (sum_xg / n))
    return dx.to(x.dtype), sum_xg.sum(dim=(0, 2, 3, 4)), sum_g.sum(dim=(0, 2, 3, 4))


def instance_norm_act(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                      eps: float = 1e-3, act: str = "none",
                      alpha: float = 0.2) -> torch.Tensor:
    """Fused InstanceNorm + activation of ``x`` (B, C, X, Y, Z); ``gamma`` and
    ``beta`` are (C,). The kernels on a CUDA tensor, the plain versions on a
    CPU tensor; differentiable in x, gamma and beta."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {sorted(ACTS)}, got {act!r}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, gamma, beta)):
        return _InstanceNormAct.apply(x, gamma, beta, eps, act, alpha)
    return _forward(x, gamma, beta, eps, act, alpha)[0]


class _InstanceNormAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps, act, alpha):
        y, stats = _forward(x, gamma, beta, eps, act, alpha)
        ctx.save_for_backward(x, gamma, beta, stats)
        ctx.conf = (eps, act, alpha)
        return y

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta, stats = ctx.saved_tensors
        eps, act, alpha = ctx.conf
        if x.device.type == "cpu":
            dx, dgamma, dbeta = instance_norm_act_bwd_plain(x, g, gamma, beta, eps, act, alpha)
        else:
            dx, dgamma, dbeta = _instance_norm_act_bwd_cuda(x, g, stats, act, alpha)
        return (dx if ctx.needs_input_grad[0] else None, dgamma.to(gamma.dtype),
                dbeta.to(beta.dtype), None, None, None)


def _forward(x, gamma, beta, eps, act, alpha):
    """(y, per-(b, c) (mean, a, beta, inv) from the kernel, or None on the CPU)."""
    if x.device.type == "cpu":
        return instance_norm_act_plain(x, gamma, beta, eps, act, alpha), None
    return _instance_norm_act_cuda(x, gamma, beta, eps, act, alpha)


def _nsplit(n: int) -> int:
    return min(256, -(-n // _ELEMS_PER_BLOCK))


def _vec(n: int, *tensors) -> int:
    """1 when 16-byte vectors tile every plane of every tensor."""
    return int(n * tensors[0].element_size() % 16 == 0
               and all(t.data_ptr() % 16 == 0 for t in tensors))


def _instance_norm_act_cuda(x, gamma, beta, eps, act, alpha):
    """(y, per-plane (mean, a, beta, inv)) from one launch of the forward
    kernel on ``fwd_plan``'s route."""
    global launches, fwd_kernel_launches
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm_act: no kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"instance_norm_act: kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 5 or gamma.shape != (x.shape[1],) or beta.shape != (x.shape[1],):
        raise ValueError(f"instance_norm_act: shapes x {tuple(x.shape)}, "
                         f"gamma {tuple(gamma.shape)}, beta {tuple(beta.shape)}")
    x = x.contiguous()
    if x.data_ptr() % 16:  # a view at an odd offset: the kernel reads 16-byte vectors
        x = x.clone()
    gamma = gamma.detach().to(device=x.device, dtype=torch.float32).contiguous()
    beta = beta.detach().to(device=x.device, dtype=torch.float32).contiguous()
    b, c = x.shape[:2]
    n = math.prod(x.shape[2:])
    plan = fwd_plan(n, x.dtype, n * x.element_size() % 16 == 0)
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    stats = torch.empty(b * c * 4, dtype=torch.float32, device=x.device)
    launched = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        status = build.library().vg_instnorm_fwd(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), stats.data_ptr(),
            _DTYPES[x.dtype], b * c, c, n, FWD_ROUTES[plan.route], plan.cluster, plan.threads,
            plan.rpt, plan.vecs_per_block, plan.smem_vecs, float(eps), ACTS[act], float(alpha),
            torch.cuda.current_stream(x.device).cuda_stream, ctypes.byref(launched))
    build.check(status, f"instance_norm_act ({plan.route}, cluster {plan.cluster})")
    launches += 1
    fwd_kernel_launches += launched.value
    return y, stats


def _instance_norm_act_bwd_cuda(x, g, stats, act, alpha):
    """(dx, dgamma, dbeta) from the backward kernel on ``bwd_plan``'s route."""
    global bwd_launches
    g = g.to(x.dtype).contiguous()
    b, c = x.shape[:2]
    n = math.prod(x.shape[2:])
    dx = torch.empty_like(x)
    plan = bwd_plan(n, x.dtype, bool(_vec(n, x, g, dx)))
    partial = torch.empty(b * c * plan.nsplit * 2, dtype=torch.float32, device=x.device) \
        if plan.route == "split" else None
    sums = torch.empty((b, c, 2), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        status = build.library().vg_instnorm_bwd(
            x.data_ptr(), g.data_ptr(), stats.data_ptr(),
            None if partial is None else partial.data_ptr(), sums.data_ptr(), dx.data_ptr(),
            _DTYPES[x.dtype], b * c, n, int(plan.route == "split"), int(plan.vec > 1),
            plan.vpt, plan.nsplit, ACTS[act], float(alpha),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "instance_norm_act backward")
    bwd_launches += 1
    per_c = sums.sum(dim=0)  # (C, 2): one reduction for dbeta and dgamma
    return dx, per_c[:, 1], per_c[:, 0]
