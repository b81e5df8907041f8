"""3-D convolution: hand-written CUDA kernels (forward, input gradient, weight
gradient) and their plain versions.

``conv3d`` is the counterpart of ``vangan_tpu.ops.pallas.conv3d.conv3d_cxyz``
in torch's ``(B, C, X, Y, Z)`` layout with a torch weight
``(Co, Ci, kx, ky, kz)``: strides 1 or 2 (any, in fact) per axis, kernels up to
8 per axis, zero or reflect padding with TF SAME sizes, optional bias, output
in the input dtype with f32 accumulation. On a CUDA tensor the forward
launches ``csrc/conv3d_fwd.cu`` (see the note there); on a CPU tensor it runs
``conv3d_plain``.

Where a gradient is needed the op is a ``torch.autograd.Function`` whose
backward computes only what ``ctx.needs_input_grad`` asks for (the
generators' stem convs read data or detached inputs and need no dx):

- dx, ``conv3d_dgrad`` (the TPU kernel ``_conv_dgrad``): for each stride
  parity p, a stride-1 launch of the forward kernel on the cotangent with the
  flipped parity sub-kernel (taps d = s*e + p), Ci and Co swapped, zero-padded
  by its extent - 1, in g's dtype with f32 accumulation, as the TPU kernel
  runs its forward in g's dtype; the pieces interleave into the gradient of
  the padded input and the pad folds back in plain torch
  (``pad.pad3d_grad``, in f32 for a reflect pad), then dx is rounded to x's
  dtype;
- dW, ``conv3d_wgrad`` (the TPU kernel ``_conv_wgrad``):
  ``csrc/conv3d_wgrad.cu``, accumulated and returned in f32;
- dbias: a plain f32 sum of the cotangent, as in JAX.

On a CPU tensor each of these runs its plain version (``conv3d_dgrad_plain``,
``conv3d_wgrad_plain``).
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from vangan_torch.ops import build
from vangan_torch.ops.pad import Pad3, pad3d, pad3d_grad

# kernel launches (chip_smoke.py reads and resets them)
launches = 0        # conv3d forward
dgrad_launches = 0  # forward-kernel launches made by conv3d_dgrad (one per stride parity)
wgrad_launches = 0  # conv3d_wgrad

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KMAX = 8  # largest kernel extent per axis the kernels take


def norm_stride(stride: Union[int, Sequence[int]]) -> Tuple[int, int, int]:
    return (stride,) * 3 if isinstance(stride, int) else tuple(stride)


def norm_padding(padding, k: Sequence[int], stride: Sequence[int],
                 dims: Sequence[int]) -> Pad3:
    """'same' (TF SAME, size-aware: total = (ceil(n/s)-1)*s + k - n, the
    extra voxel on the high side), 'valid', or explicit ((lo, hi),) * 3 —
    ``vangan_tpu.ops.pallas.conv3d._norm_padding`` with the input sizes."""
    if isinstance(padding, str):
        p = padding.lower()
        if p == "valid":
            return ((0, 0),) * 3
        if p == "same":
            pads = []
            for n, kk, ss in zip(dims, k, stride):
                total = max((-(-n // ss) - 1) * ss + kk - n, 0)
                pads.append((total // 2, total - total // 2))
            return tuple(pads)
        raise ValueError(f"padding {padding!r}")
    return tuple((int(lo), int(hi)) for lo, hi in padding)


def padded_dims(dims: Sequence[int], pads: Pad3) -> Tuple[int, int, int]:
    return tuple(n + lo + hi for n, (lo, hi) in zip(dims, pads))


def conv3d_plain(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                 stride: Sequence[int], pads: Pad3, pad_mode: str) -> torch.Tensor:
    """The plain version: explicit padding, then ``F.conv3d`` (VALID)."""
    return F.conv3d(pad3d(x, pads, pad_mode), w.to(x.dtype),
                    None if bias is None else bias.to(x.dtype), tuple(stride))


def conv3d_dgrad_plain(g: torch.Tensor, w: torch.Tensor, x_shape: Sequence[int],
                       stride: Sequence[int], pads: Pad3, pad_mode: str) -> torch.Tensor:
    """dL/dx of ``conv3d_plain`` for the cotangent ``g``: ``conv3d_input`` on
    the padded shape in f32, the pad folded back, rounded to g's dtype."""
    xp_shape = (*x_shape[:2], *padded_dims(x_shape[2:], pads))
    dxp = torch.nn.grad.conv3d_input(xp_shape, w.float(), g.float(), tuple(stride))
    return pad3d_grad(dxp, pads, pad_mode).to(g.dtype)


def conv3d_wgrad_plain(x: torch.Tensor, g: torch.Tensor, w_shape: Sequence[int],
                       stride: Sequence[int], pads: Pad3, pad_mode: str) -> torch.Tensor:
    """dL/dw of ``conv3d_plain`` in f32: ``conv3d_weight`` on the padded input."""
    return torch.nn.grad.conv3d_weight(pad3d(x.float(), pads, pad_mode), tuple(w_shape),
                                       g.float(), tuple(stride))


def conv3d(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
           stride: Union[int, Sequence[int]] = 1, padding="same",
           pad_mode: str = "zeros") -> torch.Tensor:
    """Conv3d of ``x`` (B, Ci, X, Y, Z) with ``w`` (Co, Ci, kx, ky, kz).

    The kernels on a CUDA tensor, the plain versions on a CPU tensor;
    differentiable in x, w and bias.
    """
    k = tuple(w.shape[2:])
    stride = norm_stride(stride)
    pads = norm_padding(padding, k, stride, x.shape[2:])
    if pad_mode not in ("zeros", "reflect"):
        raise ValueError(f"pad_mode must be 'zeros' or 'reflect', got {pad_mode!r}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, w, bias)):
        return _Conv3d.apply(x, w, bias, stride, pads, pad_mode)
    return _forward(x, w, bias, stride, pads, pad_mode)


def conv3d_dgrad(g: torch.Tensor, w: torch.Tensor, x_shape: Sequence[int],
                 stride: Sequence[int], pads: Pad3, pad_mode: str) -> torch.Tensor:
    """dL/dx (in g's dtype) of the conv of an input of ``x_shape`` for the
    cotangent ``g``: the forward kernel per stride parity on a CUDA tensor,
    ``conv3d_dgrad_plain`` on a CPU tensor."""
    if g.device.type == "cpu":
        return conv3d_dgrad_plain(g, w, x_shape, stride, pads, pad_mode)
    return _conv3d_dgrad_cuda(g, w, x_shape, stride, pads, pad_mode)


def conv3d_wgrad(x: torch.Tensor, g: torch.Tensor, w_shape: Sequence[int],
                 stride: Sequence[int], pads: Pad3, pad_mode: str) -> torch.Tensor:
    """dL/dw (f32, ``w_shape``) for the input ``x`` and cotangent ``g``: the
    kernel on a CUDA tensor, ``conv3d_wgrad_plain`` on a CPU tensor."""
    if x.device.type == "cpu":
        return conv3d_wgrad_plain(x, g, w_shape, stride, pads, pad_mode)
    return _conv3d_wgrad_cuda(x, g, w_shape, stride, pads, pad_mode)


class _Conv3d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, stride, pads, pad_mode):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, pads, pad_mode, bias is not None)
        return _forward(x, w, bias, stride, pads, pad_mode)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, pads, pad_mode, has_bias = ctx.conf
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        g = g.contiguous()
        dx = conv3d_dgrad(g, w, x.shape, stride, pads, pad_mode).to(x.dtype) if need_x else None
        dw = conv3d_wgrad(x, g, w.shape, stride, pads, pad_mode).to(w.dtype) if need_w else None
        db = g.float().sum(dim=(0, 2, 3, 4)) if has_bias and need_b else None
        return dx, dw, db, None, None, None


def _forward(x, w, bias, stride, pads, pad_mode):
    global launches
    if x.device.type == "cpu":
        return conv3d_plain(x, w, bias, stride, pads, pad_mode)
    _check_cuda(x, w.shape, "conv3d")
    dims = [(n + lo + hi - kk) // s + 1
            for n, (lo, hi), kk, s in zip(x.shape[2:], pads, w.shape[2:], stride)]
    y = _launch_fwd(x, w, bias, stride, [lo for lo, _ in pads], pad_mode == "reflect", dims,
                    "conv3d")
    launches += 1
    return y


def _check_cuda(x, w_shape, name):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 5 or len(w_shape) != 5:
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, w {tuple(w_shape)}")
    if max(w_shape[2:]) > KMAX:
        raise ValueError(f"{name}: kernel extents above {KMAX} are not supported: "
                         f"{tuple(w_shape)}")


def _launch_fwd(x, w, bias, stride, lo_pads, reflect, out_dims, name):
    """One launch of the forward kernel: output ``out_dims`` (B, Co, *out_dims)
    in x's dtype; input position o*s + d - lo of each axis, zero (or reflected)
    outside the input."""
    if w.shape[1] != x.shape[1]:
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, w {tuple(w.shape)}")
    x = x.contiguous()
    w = w.detach().to(device=x.device, dtype=x.dtype).contiguous()
    if bias is not None:
        bias = bias.detach().to(device=x.device, dtype=x.dtype).contiguous()
    b, ci, X, Y, Z = x.shape
    co, kx, ky, kz = w.shape[0], *w.shape[2:]
    y = torch.empty((b, co, *out_dims), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        status = build.library().vg_conv3d_fwd(
            x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(), y.data_ptr(),
            _DTYPES[x.dtype], b, ci, co, X, Y, Z, *out_dims, kx, ky, kz, *stride, *lo_pads,
            int(reflect), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, name)
    return y


def _conv3d_dgrad_cuda(g, w, x_shape, stride, pads, pad_mode):
    global dgrad_launches
    _check_cuda(g, w.shape, "conv3d_dgrad")
    g = g.contiguous()
    b, ci = x_shape[:2]
    xp = padded_dims(x_shape[2:], pads)
    # per axis and parity p: (p, taps of the parity sub-kernel, padded
    # positions with that parity)
    parities = [[(p, len(range(p, kk, s)), -(-(n - p) // s)) for p in range(s)]
                for kk, s, n in zip(w.shape[2:], stride, xp)]
    unit = all(s == 1 for s in stride)
    # the pieces interleave in g's dtype; the reflect fold-back adds in f32
    acc = g.dtype if pad_mode == "zeros" else torch.float32
    dxp = None if unit else torch.zeros((b, ci, *xp), dtype=acc, device=g.device)
    for (px, ex, nx), (py, ey, ny), (pz, ez, nz) in itertools.product(*parities):
        if min(ex, ey, ez, nx, ny, nz) <= 0:
            continue  # an empty parity: its positions get no gradient
        sx, sy, sz = stride
        wsub = w[:, :, px::sx, py::sy, pz::sz].flip((2, 3, 4)).transpose(0, 1)
        piece = _launch_fwd(g, wsub, None, (1, 1, 1), (ex - 1, ey - 1, ez - 1), False,
                            (nx, ny, nz), "conv3d_dgrad")
        dgrad_launches += 1
        if unit:
            dxp = piece.to(acc)
        else:
            dxp[:, :, px::sx, py::sy, pz::sz] = piece
    return pad3d_grad(dxp, pads, pad_mode).to(g.dtype)


def _conv3d_wgrad_cuda(x, g, w_shape, stride, pads, pad_mode):
    global wgrad_launches
    _check_cuda(x, w_shape, "conv3d_wgrad")
    co, ci, kx, ky, kz = w_shape
    if ci != x.shape[1] or g.dim() != 5 or co != g.shape[1]:
        raise ValueError(f"conv3d_wgrad: shapes x {tuple(x.shape)}, g {tuple(g.shape)}, "
                         f"w {tuple(w_shape)}")
    x = x.contiguous()
    g = g.to(x.dtype).contiguous()
    dw = torch.zeros(tuple(w_shape), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        status = build.library().vg_conv3d_wgrad(
            x.data_ptr(), g.data_ptr(), dw.data_ptr(), _DTYPES[x.dtype], x.shape[0], ci, co,
            *x.shape[2:], *g.shape[2:], kx, ky, kz, *stride, *[lo for lo, _ in pads],
            int(pad_mode == "reflect"), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "conv3d_wgrad")
    wgrad_launches += 1
    return dw
