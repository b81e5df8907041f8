"""InstanceNorm + activation forward: a hand-written CUDA kernel and its plain version.

``instance_norm_act`` is the counterpart of
``vangan_tpu.ops.pallas.instnorm.instance_norm_act`` on torch's
``(B, C, X, Y, Z)`` layout: per-(b, c) mean and variance over X, Y, Z in f32,
then ``act((x - mean) * a + beta)`` with ``a = gamma * rsqrt(var + eps)``
and act in {none, relu, leaky_relu}, written in the input dtype. On a CUDA
tensor it launches ``csrc/instnorm_fwd.cu`` (see the note there) for any C;
on a CPU tensor it runs ``instance_norm_act_plain``.
Forward only: the backward (the TPU kernels ``bwd_reduce_sums`` and
``bwd_dx``) is not ported yet.
"""

from __future__ import annotations

import math

import torch

from vangan_torch.ops import build

launches = 0  # kernel launches made by instance_norm_act (chip_smoke.py reads and resets it)

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


def instance_norm_act(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                      eps: float = 1e-3, act: str = "none",
                      alpha: float = 0.2) -> torch.Tensor:
    """Fused InstanceNorm + activation of ``x`` (B, C, X, Y, Z); ``gamma`` and
    ``beta`` are (C,). The kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    if x.device.type == "cpu":
        return instance_norm_act_plain(x, gamma, beta, eps, act, alpha)
    return _instance_norm_act_cuda(x, gamma, beta, eps, act, alpha)


def _instance_norm_act_cuda(x, gamma, beta, eps, act, alpha):
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm_act: no kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"instance_norm_act: kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 5 or gamma.shape != (x.shape[1],) or beta.shape != (x.shape[1],):
        raise ValueError(f"instance_norm_act: shapes x {tuple(x.shape)}, "
                         f"gamma {tuple(gamma.shape)}, beta {tuple(beta.shape)}")
    if act not in ACTS:
        raise ValueError(f"act must be one of {sorted(ACTS)}, got {act!r}")
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        raise RuntimeError("instance_norm_act: the CUDA kernel is forward only "
                           "(run under torch.inference_mode or no_grad)")
    x = x.contiguous()
    gamma = gamma.to(device=x.device, dtype=torch.float32).contiguous()
    beta = beta.to(device=x.device, dtype=torch.float32).contiguous()
    b, c = x.shape[:2]
    n = math.prod(x.shape[2:])
    nsplit = min(256, -(-n // _ELEMS_PER_BLOCK))
    y = torch.empty_like(x)
    partial = torch.empty(b * c * nsplit * 3, dtype=torch.float32, device=x.device)
    ab = torch.empty(b * c * 3, dtype=torch.float32, device=x.device)
    vec = int(n * x.element_size() % 16 == 0
              and x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        status = build.library().vg_instnorm_fwd(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), partial.data_ptr(),
            ab.data_ptr(), _DTYPES[x.dtype], b * c, c, n, nsplit, float(eps), ACTS[act],
            float(alpha), vec, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "instance_norm_act")
    launches += 1
    return y
