"""InstanceNorm + activation: hand-written CUDA kernels (forward and backward)
and their plain versions.

``instance_norm_act`` is the counterpart of
``vangan_tpu.ops.pallas.instnorm.instance_norm_act`` on torch's
``(B, C, X, Y, Z)`` layout: per-(b, c) mean and variance over X, Y, Z in f32,
then ``act((x - mean) * a + beta)`` with ``a = gamma * rsqrt(var + eps)``
and act in {none, relu, leaky_relu}, written in the input dtype. On a CUDA
tensor it launches ``csrc/instnorm_fwd.cu`` (see the note there) for any C;
on a CPU tensor it runs ``instance_norm_act_plain``.

Where a gradient is needed the op is a ``torch.autograd.Function``: the
forward keeps (mean, a, beta, inv) per (b, c), and the backward launches
``csrc/instnorm_bwd.cu`` (the TPU kernels ``bwd_reduce_sums`` and ``bwd_dx``)
for dx, with dgamma and dbeta the plain sums over b of its per-(b, c) sums;
on a CPU tensor it runs ``instance_norm_act_bwd_plain``.
"""

from __future__ import annotations

import math

import torch

from vangan_torch.ops import build

# kernel launches (chip_smoke.py reads and resets them)
launches = 0      # instance_norm_act forward calls
bwd_launches = 0  # backward calls (one reduce, one dx pass each)

ACTS = {"none": 0, "relu": 1, "leaky_relu": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ELEMS_PER_BLOCK = 16384  # pass 1 / pass 3 work per block along a (b, c) plane


def instance_norm_act_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                            eps: float = 1e-3, act: str = "none",
                            alpha: float = 0.2) -> torch.Tensor:
    """The plain version: f32 statistics and affine, output in ``x.dtype``."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {sorted(ACTS)}, got {act!r}")
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=(2, 3, 4), unbiased=False, keepdim=True)
    shape = (1, -1, 1, 1, 1)
    a = gamma.float().reshape(shape) * torch.rsqrt(var + eps)
    y = (xf - mean) * a + beta.float().reshape(shape)
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
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm_act: no kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"instance_norm_act: kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 5 or gamma.shape != (x.shape[1],) or beta.shape != (x.shape[1],):
        raise ValueError(f"instance_norm_act: shapes x {tuple(x.shape)}, "
                         f"gamma {tuple(gamma.shape)}, beta {tuple(beta.shape)}")
    x = x.contiguous()
    gamma = gamma.detach().to(device=x.device, dtype=torch.float32).contiguous()
    beta = beta.detach().to(device=x.device, dtype=torch.float32).contiguous()
    b, c = x.shape[:2]
    n = math.prod(x.shape[2:])
    nsplit = _nsplit(n)
    y = torch.empty_like(x)
    partial = torch.empty(b * c * nsplit * 3, dtype=torch.float32, device=x.device)
    stats = torch.empty(b * c * 4, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        status = build.library().vg_instnorm_fwd(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), partial.data_ptr(),
            stats.data_ptr(), _DTYPES[x.dtype], b * c, c, n, nsplit, float(eps), ACTS[act],
            float(alpha), _vec(n, x, y), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "instance_norm_act")
    launches += 1
    return y, stats


def _instance_norm_act_bwd_cuda(x, g, stats, act, alpha):
    """(dx, dgamma, dbeta) from the backward kernels."""
    global bwd_launches
    g = g.to(x.dtype).contiguous()
    b, c = x.shape[:2]
    n = math.prod(x.shape[2:])
    nsplit = _nsplit(n)
    dx = torch.empty_like(x)
    partial = torch.empty(b * c * nsplit * 2, dtype=torch.float32, device=x.device)
    sums = torch.empty((b, c, 2), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        status = build.library().vg_instnorm_bwd(
            x.data_ptr(), g.data_ptr(), stats.data_ptr(), partial.data_ptr(), sums.data_ptr(),
            dx.data_ptr(), _DTYPES[x.dtype], b * c, n, nsplit, ACTS[act], float(alpha),
            _vec(n, x, g, dx), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "instance_norm_act backward")
    bwd_launches += 1
    return dx, sums[..., 1].sum(dim=0), sums[..., 0].sum(dim=0)
