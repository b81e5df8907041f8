"""3-D convolution forward: a hand-written CUDA kernel and its plain version.

``conv3d`` is the counterpart of ``vangan_tpu.ops.pallas.conv3d.conv3d_cxyz``
in torch's ``(B, C, X, Y, Z)`` layout with a torch weight
``(Co, Ci, kx, ky, kz)``: strides 1 or 2 (any, in fact) per axis, kernels up to
8 per axis, zero or reflect padding with TF SAME sizes, optional bias, output
in the input dtype with f32 accumulation. On a CUDA tensor it launches
``csrc/conv3d_fwd.cu`` (see the note there); on a CPU tensor it runs
``conv3d_plain``. Forward only: the input and weight gradients (the TPU
kernels ``_conv_dgrad`` and ``_conv_wgrad``) are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from vangan_torch.ops import build
from vangan_torch.ops.pad import Pad3, pad3d

launches = 0  # kernel launches made by conv3d (chip_smoke.py reads and resets it)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def conv3d_plain(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
                 stride: Sequence[int], pads: Pad3, pad_mode: str) -> torch.Tensor:
    """The plain version: explicit padding, then ``F.conv3d`` (VALID)."""
    return F.conv3d(pad3d(x, pads, pad_mode), w.to(x.dtype),
                    None if bias is None else bias.to(x.dtype), tuple(stride))


def conv3d(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
           stride: Union[int, Sequence[int]] = 1, padding="same",
           pad_mode: str = "zeros") -> torch.Tensor:
    """Conv3d of ``x`` (B, Ci, X, Y, Z) with ``w`` (Co, Ci, kx, ky, kz).

    The kernel on a CUDA tensor, ``conv3d_plain`` on a CPU tensor.
    """
    k = tuple(w.shape[2:])
    stride = norm_stride(stride)
    pads = norm_padding(padding, k, stride, x.shape[2:])
    if pad_mode not in ("zeros", "reflect"):
        raise ValueError(f"pad_mode must be 'zeros' or 'reflect', got {pad_mode!r}")
    if x.device.type == "cpu":
        return conv3d_plain(x, w, bias, stride, pads, pad_mode)
    return _conv3d_cuda(x, w, bias, stride, pads, pad_mode)


def _conv3d_cuda(x, w, bias, stride, pads, pad_mode):
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"conv3d: no kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"conv3d: kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 5 or w.dim() != 5 or w.shape[1] != x.shape[1]:
        raise ValueError(f"conv3d: shapes x {tuple(x.shape)}, w {tuple(w.shape)}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("conv3d: the CUDA kernel is forward only "
                           "(run under torch.inference_mode or no_grad)")
    if max(w.shape[2:]) > 8:
        raise ValueError(f"conv3d: kernel extents above 8 are not supported: {tuple(w.shape)}")
    x = x.contiguous()
    w = w.to(device=x.device, dtype=x.dtype).contiguous()
    if bias is not None:
        bias = bias.to(device=x.device, dtype=x.dtype).contiguous()
    b, ci, X, Y, Z = x.shape
    co = w.shape[0]
    kx, ky, kz = w.shape[2:]
    sx, sy, sz = stride
    (lx, hx), (ly, hy), (lz, hz) = pads
    xo, yo, zo = ((n + lo + hi - kk) // s + 1
                  for n, (lo, hi), kk, s in zip((X, Y, Z), pads, (kx, ky, kz), stride))
    y = torch.empty((b, co, xo, yo, zo), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        status = build.library().vg_conv3d_fwd(
            x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(), y.data_ptr(),
            _DTYPES[x.dtype], b, ci, co, X, Y, Z, xo, yo, zo, kx, ky, kz, sx, sy, sz,
            lx, ly, lz, int(pad_mode == "reflect"),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "conv3d")
    launches += 1
    return y
