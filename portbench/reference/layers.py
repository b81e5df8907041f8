"""Plain PyTorch building blocks of the reference networks.

Everything here is ordinary ``torch`` arithmetic on ``(B, C, X, Y, Z)``
float32 tensors: explicit padding, ``F.conv3d`` and ``F.conv_transpose3d``,
InstanceNorm and BatchNorm by ``var_mean``, nearest upsampling and spatial
dropout. Nothing of the measured program is imported. A ``Ctx`` carries what
varies between uses:

- ``quant``: a dtype that the control rounds to (the reference one precision
  below the configuration's) wherever the program rounds to its compute
  dtype: every conv's input, weight and output, every norm's output,
  each network's input, residual sum, noise sum and dropout output; with a
  per-tensor scale (the tensor's largest magnitude to the dtype's largest
  value), forward, and the same rounding of the gradient backward;
- ``record``: a list that each conv, transposed conv, InstanceNorm and
  BatchNorm appends its shapes to (the work counts of ``portbench.work``),
  or None.

Random draws come from a ``Segment`` (``portbench.reference.draws``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Pads = Tuple[Tuple[int, int], Tuple[int, int], Tuple[int, int]]


class Ctx:
    def __init__(self, quant: Optional[torch.dtype] = None, record: Optional[List] = None):
        self.quant = quant
        self.record = record


def _scaled_round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    amax = t.detach().abs().amax()
    scale = torch.where(amax > 0, amax / torch.finfo(dtype).max, torch.ones_like(amax))
    return (t / scale).to(dtype).to(t.dtype) * scale


class _Round(torch.autograd.Function):
    """Round to ``dtype`` at a per-tensor scale and back; the gradient too."""

    @staticmethod
    def forward(ctx, t, dtype):
        ctx.dtype = dtype
        return _scaled_round(t, dtype)

    @staticmethod
    def backward(ctx, g):
        return _scaled_round(g, ctx.dtype), None


def rounded(ctx: Ctx, t: torch.Tensor) -> torch.Tensor:
    """``t``, or under the control ``t`` rounded to ``ctx.quant``."""
    return t if ctx.quant is None else _Round.apply(t, ctx.quant)


def same_pads(sizes: Sequence[int], k: int, s: int) -> Pads:
    """TF SAME padding: total (ceil(n / s) - 1) s + k - n, the odd voxel high."""
    pads = []
    for n in sizes:
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def uniform(p: int) -> Pads:
    return ((p, p),) * 3


def _reflect_index(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """numpy's 'reflect' source index of each position of an axis of ``n``
    padded by (lo, hi), for any width (a 1-voxel axis repeats its voxel)."""
    i = torch.arange(-lo, n + hi, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i < n, i, period - i)


def pad(x: torch.Tensor, pads: Pads, mode: str) -> torch.Tensor:
    if not any(lo or hi for lo, hi in pads):
        return x
    if mode == "zeros":
        flat = [p for lo_hi in reversed(pads) for p in lo_hi]
        return F.pad(x, flat)
    for axis, (lo, hi) in enumerate(pads):
        if lo or hi:
            x = x.index_select(2 + axis, _reflect_index(x.shape[2 + axis], lo, hi, x.device))
    return x


def conv(ctx: Ctx, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], stride: int,
         pads: Pads, mode: str = "zeros") -> torch.Tensor:
    y = rounded(ctx, F.conv3d(pad(rounded(ctx, x), pads, mode), rounded(ctx, w), b, stride))
    if ctx.record is not None:
        ctx.record.append(("conv", tuple(x.shape), tuple(w.shape), tuple(y.shape),
                           x.requires_grad, w.requires_grad))
    return y


def conv_transpose(ctx: Ctx, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                   stride: int) -> torch.Tensor:
    """A transposed conv with torch's (Ci, Co, k, k, k) weight, as the
    generators upsample with it (kernel = stride: the windows do not overlap,
    and the output is ``stride`` times the input on each axis)."""
    y = rounded(ctx, F.conv_transpose3d(rounded(ctx, x), rounded(ctx, w), b, stride))
    if ctx.record is not None:
        ctx.record.append(("conv_transpose", tuple(x.shape), tuple(w.shape), tuple(y.shape),
                           x.requires_grad, w.requires_grad))
    return y


def instance_norm(ctx: Ctx, x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  act: str = "none", eps: float = 1e-3, slope: float = 0.2) -> torch.Tensor:
    """Per-sample, per-channel normalisation over X, Y, Z (biased variance),
    affine, then 'relu', 'leaky_relu' (slope 0.2) or 'none'."""
    if ctx.record is not None:
        ctx.record.append(("in", tuple(x.shape), x.requires_grad))
    var, mean = torch.var_mean(x, dim=(2, 3, 4), unbiased=False, keepdim=True)
    shape = (1, -1, 1, 1, 1)
    y = (x - mean) * (gamma.view(shape) * torch.rsqrt(var + eps)) + beta.view(shape)
    if act == "relu":
        y = torch.relu(y)
    elif act == "leaky_relu":
        y = torch.where(y >= 0, y, slope * y)
    return rounded(ctx, y)


def batch_norm(ctx: Ctx, x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-3) -> torch.Tensor:
    """Keras' BatchNormalization in training: per-channel statistics over
    B, X, Y, Z (biased variance), affine. The running statistics are the
    program's state; the reference neither reads nor moves them."""
    if ctx.record is not None:
        ctx.record.append(("bn", tuple(x.shape), x.requires_grad))
    var, mean = torch.var_mean(x, dim=(0, 2, 3, 4), unbiased=False, keepdim=True)
    shape = (1, -1, 1, 1, 1)
    return rounded(ctx, (x - mean) * (gamma.view(shape) * torch.rsqrt(var + eps))
                   + beta.view(shape))


def upsample(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour repeat by 2 on X, Y, Z."""
    return x.repeat_interleave(2, 2).repeat_interleave(2, 3).repeat_interleave(2, 4)


def spatial_dropout(ctx: Ctx, x: torch.Tensor, rate: float, u: torch.Tensor) -> torch.Tensor:
    """Drop whole (b, c) channels where the uniform draw ``u`` (B, C, 1, 1, 1)
    is not below 1 - rate; scale the kept ones by 1 / (1 - rate)."""
    keep = 1.0 - rate
    return rounded(ctx, torch.where(u < keep, x / keep,
                                    torch.zeros((), dtype=x.dtype, device=x.device)))


def to_volume(x: torch.Tensor) -> torch.Tensor:
    """(B, X, Y, Z, 1) as (B, 1, X, Y, Z)."""
    return x.reshape(x.shape[0], 1, *x.shape[1:4])


def from_volume(y: torch.Tensor) -> torch.Tensor:
    """(B, 1, X, Y, Z) as (B, X, Y, Z, 1)."""
    return y.reshape(y.shape[0], *y.shape[2:], 1)


class Spec:
    """The parameters of a network (``leaves``): name -> (shape, init), init
    one of ("he", fan_in) (truncated normal, variance 2 / fan_in), "ones",
    "zeros"; and its state (``state``): the program's buffers, such as
    BatchNorm's running ``mean`` and ``var``, name -> (shape, "zeros" or
    "ones"). The state is loaded into the program beside the parameters and
    is never drawn, trained or compared."""

    def __init__(self):
        self.leaves = {}
        self.state = {}

    def conv(self, name: str, ci: int, co: int, k: int, bias: bool) -> None:
        self.leaves[name + ".weight"] = ((co, ci, k, k, k), ("he", ci * k ** 3))
        if bias:
            self.leaves[name + ".bias"] = ((co,), "zeros")

    def norm(self, name: str, c: int, gamma="ones") -> None:
        self.leaves[name + ".weight"] = ((c,), gamma)
        self.leaves[name + ".bias"] = ((c,), "zeros")

    def conv_transpose(self, name: str, ci: int, co: int, k: int) -> None:
        self.leaves[name + ".weight"] = ((ci, co, k, k, k), ("he", ci * k ** 3))
        self.leaves[name + ".bias"] = ((co,), "zeros")

    def buffer(self, name: str, shape, init: str) -> None:
        self.state[name] = (tuple(shape), init)

    def batch_norm(self, name: str, c: int) -> None:
        """A BatchNorm's gamma and beta, and its running mean and variance."""
        self.norm(name, c)
        self.buffer(name + ".mean", (c,), "zeros")
        self.buffer(name + ".var", (c,), "ones")
