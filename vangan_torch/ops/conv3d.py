"""3-D convolution: hand-written CUDA kernels (forward, input gradient, weight
gradient) and their plain versions.

``conv3d`` is the counterpart of ``vangan_tpu.ops.pallas.conv3d.conv3d_cxyz``
in torch's ``(B, C, X, Y, Z)`` layout with a torch weight
``(Co, Ci, kx, ky, kz)``: strides 1 or 2 (any, in fact) per axis, kernels up to
8 per axis, zero or reflect padding with TF SAME sizes, optional bias, output
in the input dtype with f32 accumulation. On a CUDA tensor the forward
launches ``csrc/conv3d_fwd.cu`` (see the note there); on a CPU tensor it runs
``conv3d_plain``.

Each kernel has two bodies, and ``conv_plan`` (pure Python) picks one per
shape: bfloat16 takes the tensor-core route (``"mma"``: an implicit GEMM on
``mma.sync`` over input halos staged in shared memory), float32 the
CUDA-core route (``"f32"``, exact f32 FMAs), and the few bfloat16 shapes the
tensor-core route does not take the same CUDA-core body (``"thin"``). The plan
also fixes the tiles (the Co tile, the weight gradient's split over voxels and
its workspace), and the wrapper passes it to the C entry point, which refuses
what it cannot do: a route never falls back.

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
  ``csrc/conv3d_wgrad.cu``, accumulated and returned in f32; on the
  tensor-core route bit-identical from run to run (split-K partial tiles
  summed in a fixed order, no atomics);
- dbias: a plain f32 sum of the cotangent, as in JAX.

On a CPU tensor each of these runs its plain version (``conv3d_dgrad_plain``,
``conv3d_wgrad_plain``).
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
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

# The plan's constants; the tensor-core ones mirror csrc/conv3d_common.cuh and
# the two sources.
ROUTES = {"f32": 0, "thin": 0, "mma": 1}  # route -> the C entry points' body
BRICK = (4, 8, 8)       # output voxels per tensor-core block (x, y, z)
CI_CHUNK = 16           # input channels per MMA k-step
MMA_WARPS = 8
THIN_MAX_CI = 3         # forward: a bf16 conv with Ci <= 3 takes the CUDA-core body
MMA_MAX_TAPS = 64
FWD_MAX_CO_TILE = 64
WGRAD_MAX_CO_TILE = 32
WGRAD_TAPS_PER_WARP = 4
MAX_SMEM = 227 * 1024   # shared memory a block may use (H100)
SMS = 132
WGRAD_TARGET_BLOCKS = 4 * SMS  # two waves of two resident blocks per SM
WORKSPACE_CAP = 64 << 20       # bytes of the weight gradient's split-K workspace


@dataclass(frozen=True)
class ConvPlan:
    """How a conv kernel runs one shape (``conv_plan``).

    ``route``: ``"mma"`` (tensor cores, bfloat16), ``"f32"`` or ``"thin"``
    (the CUDA-core body, float32 or bfloat16). The rest is the tensor-core
    route's tiling: a block owns a ``brick`` of output voxels (and, for the
    weight gradient, a 16-channel ``ci_chunk`` of Ci and a group of taps) and
    a ``co_tile`` of Co (``co_tiles`` of them); the weight gradient splits
    the (sample, brick) pairs over ``split`` blocks and ``tap_warps`` warps
    share out the taps (the other warps split the voxels), writing
    ``workspace_bytes`` of f32 partial tiles. ``pad_share`` is the share of
    the issued MMA work that is padding (ragged bricks, Co tiles, Ci chunks).
    """
    op: str
    route: str
    brick: Tuple[int, int, int] = BRICK
    ci_chunk: int = CI_CHUNK
    co_tile: int = 0
    co_tiles: int = 0
    tap_warps: int = 0
    tap_groups: int = 0
    split: int = 0
    workspace_bytes: int = 0
    smem_bytes: int = 0
    pad_share: float = 0.0

    @property
    def workspace_slices(self) -> int:
        return self.split * (MMA_WARPS // self.tap_warps) if self.route == "mma" and \
            self.op == "wgrad" else 0


def _halo_voxels(k, stride) -> int:
    """Input voxels of a brick's halo (csrc/conv3d_common.cuh make_halo)."""
    return math.prod((b - 1) * (s if kk > 1 else 1) + kk for b, kk, s in zip(BRICK, k, stride))


def _co_tiling(co: int, max_tile: int) -> Tuple[int, int]:
    """(tile, tiles): the fewest Co tiles of at most ``max_tile``, each a
    multiple of 8 (the MMA's n) with the least padding."""
    n = -(-co // max_tile)
    tile = -(-co // (n * 8)) * 8
    return tile, -(-co // tile)


def conv_plan(op: str, ci: int, co: int, k: Sequence[int], stride: Sequence[int],
              out_dims: Sequence[int], dtype: torch.dtype, batch: int = 1,
              thin_max_ci: int = THIN_MAX_CI) -> ConvPlan:
    """The kernel body and tiles for one conv launch.

    ``op`` is ``"fwd"`` (K1, and each stride-parity launch of K2 with its
    sub-kernel and Ci, Co swapped) or ``"wgrad"`` (K3); ``out_dims`` the
    output's (Xo, Yo, Zo). float32 always takes the CUDA-core route. bfloat16
    takes the tensor-core route unless the shape has more than 64 taps, its
    tiles do not fit in shared memory, or (forward) Ci <= ``thin_max_ci``,
    where a 16-channel k-step would be mostly padding: those take the
    CUDA-core body (``"thin"``).
    """
    if op not in ("fwd", "wgrad"):
        raise ValueError(f"conv_plan: op {op!r}")
    if dtype not in _DTYPES:
        raise TypeError(f"conv_plan: no kernel for {dtype}")
    k, stride = tuple(k), tuple(stride)
    taps = math.prod(k)
    if dtype == torch.float32:
        return ConvPlan(op, "f32")
    thin = ConvPlan(op, "thin")
    if taps > MMA_MAX_TAPS or (op == "fwd" and ci <= thin_max_ci):
        return thin
    chunks = -(-ci // CI_CHUNK)
    bricks = batch * math.prod(-(-n // b) for n, b in zip(out_dims, BRICK))
    halo = _halo_voxels(k, stride) * 32
    max_tile = FWD_MAX_CO_TILE if op == "fwd" else WGRAD_MAX_CO_TILE
    while max_tile >= 8:
        co_tile, co_tiles = _co_tiling(co, max_tile)
        smem = halo + (taps * co_tile * 32 if op == "fwd"
                        else co_tile * (math.prod(BRICK) + 8) * 2)
        if smem <= MAX_SMEM:
            break
        max_tile -= 8
    else:
        return thin
    useful = batch * math.prod(out_dims) * co * ci
    issued = bricks * math.prod(BRICK) * co_tiles * co_tile * chunks * CI_CHUNK
    common = dict(co_tile=co_tile, co_tiles=co_tiles, smem_bytes=smem,
                  pad_share=1.0 - useful / issued)
    if op == "fwd":
        return ConvPlan(op, "mma", **common)
    tap_warps = 1 << (min(taps, MMA_WARPS).bit_length() - 1)
    tap_groups = -(-taps // (tap_warps * WGRAD_TAPS_PER_WARP))
    kslices = MMA_WARPS // tap_warps
    per_split = kslices * co * ci * taps * 4
    tiles = tap_groups * chunks * co_tiles
    split = min(-(-WGRAD_TARGET_BLOCKS // tiles), bricks, 65535, WORKSPACE_CAP // per_split)
    if split < 1:
        return thin
    return ConvPlan(op, "mma", tap_warps=tap_warps, tap_groups=tap_groups, split=split,
                    workspace_bytes=split * per_split, **common)


def wgrad_workspace_shape(plan: ConvPlan, w_shape: Sequence[int]) -> Tuple[int, int, int]:
    """(slices, Co, Ci * taps): the f32 partial tiles of a tensor-core K3."""
    co, ci = w_shape[:2]
    return plan.workspace_slices, co, ci * math.prod(w_shape[2:])


def mma_weights(w: torch.Tensor, co_tile: int) -> torch.Tensor:
    """The forward's tensor-core weights: (Co, Ci, kx, ky, kz) rearranged as
    [Ci chunk][Co tile][tap][co_tile][16] bfloat16, zero-padded in Ci and Co,
    so each block stages a chunk with 16-byte copies."""
    co, ci = w.shape[:2]
    taps = math.prod(w.shape[2:])
    chunks, co_tiles = -(-ci // CI_CHUNK), -(-co // co_tile)
    wp = F.pad(w.to(torch.bfloat16).reshape(co, ci, taps),
               (0, 0, 0, chunks * CI_CHUNK - ci, 0, co_tiles * co_tile - co))
    return wp.reshape(co_tiles, co_tile, chunks, CI_CHUNK, taps).permute(2, 0, 4, 1, 3) \
        .contiguous()


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


def _launch_fwd(x, w, bias, stride, lo_pads, reflect, out_dims, name, plan=None):
    """One launch of the forward kernel: output ``out_dims`` (B, Co, *out_dims)
    in x's dtype; input position o*s + d - lo of each axis, zero (or reflected)
    outside the input. ``plan`` defaults to ``conv_plan``'s."""
    if w.shape[1] != x.shape[1]:
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, w {tuple(w.shape)}")
    x = x.contiguous()
    b, ci, X, Y, Z = x.shape
    co, kx, ky, kz = w.shape[0], *w.shape[2:]
    if plan is None:
        plan = conv_plan("fwd", ci, co, w.shape[2:], stride, out_dims, x.dtype, b)
    w = w.detach().to(x.device)
    w = mma_weights(w, plan.co_tile) if plan.route == "mma" else w.to(x.dtype).contiguous()
    if bias is not None:
        bias = bias.detach().to(device=x.device, dtype=x.dtype).contiguous()
    y = torch.empty((b, co, *out_dims), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        status = build.library().vg_conv3d_fwd(
            x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(), y.data_ptr(),
            _DTYPES[x.dtype], b, ci, co, X, Y, Z, *out_dims, kx, ky, kz, *stride, *lo_pads,
            int(reflect), ROUTES[plan.route], plan.co_tile,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, name)
    return y


def _conv3d_dgrad_cuda(g, w, x_shape, stride, pads, pad_mode):
    global dgrad_launches
    _check_cuda(g, w.shape, "conv3d_dgrad")
    g = g.contiguous()
    b, ci = x_shape[:2]
    xp = padded_dims(x_shape[2:], pads)
    unit = all(s == 1 for s in stride)
    # the pieces interleave in g's dtype; the reflect fold-back adds in f32
    acc = g.dtype if pad_mode == "zeros" else torch.float32
    dxp = None if unit else torch.zeros((b, ci, *xp), dtype=acc, device=g.device)
    sx, sy, sz = stride
    for (px, py, pz), extents, out_dims in dgrad_parities(w.shape[2:], stride, xp):
        wsub = w[:, :, px::sx, py::sy, pz::sz].flip((2, 3, 4)).transpose(0, 1)
        piece = _launch_fwd(g, wsub, None, (1, 1, 1), [e - 1 for e in extents], False,
                            out_dims, "conv3d_dgrad")
        dgrad_launches += 1
        if unit:
            dxp = piece.to(acc)
        else:
            dxp[:, :, px::sx, py::sy, pz::sz] = piece
    return pad3d_grad(dxp, pads, pad_mode).to(g.dtype)


def dgrad_parities(k: Sequence[int], stride: Sequence[int], padded: Sequence[int]) -> list:
    """The forward-kernel launches of ``conv3d_dgrad`` on a CUDA tensor, one
    per non-empty stride parity p (per axis, taps d = s*e + p of the kernel):
    ((px, py, pz), sub-kernel extents, output dims = the padded input's
    positions with that parity). An empty parity (a 1^3 stride-2 shortcut's
    odd positions) gets no gradient and no launch."""
    per_axis = [[(p, len(range(p, kk, s)), -(-(n - p) // s)) for p in range(s)]
                for kk, s, n in zip(k, stride, padded)]
    return [(tuple(a[0] for a in par), tuple(a[1] for a in par), tuple(a[2] for a in par))
            for par in itertools.product(*per_axis) if min(min(a[1:]) for a in par) > 0]


def _conv3d_wgrad_cuda(x, g, w_shape, stride, pads, pad_mode):
    global wgrad_launches
    _check_cuda(x, w_shape, "conv3d_wgrad")
    co, ci, kx, ky, kz = w_shape
    if ci != x.shape[1] or g.dim() != 5 or co != g.shape[1]:
        raise ValueError(f"conv3d_wgrad: shapes x {tuple(x.shape)}, g {tuple(g.shape)}, "
                         f"w {tuple(w_shape)}")
    x = x.contiguous()
    g = g.to(x.dtype).contiguous()
    plan = conv_plan("wgrad", ci, co, (kx, ky, kz), stride, g.shape[2:], x.dtype, x.shape[0])
    if plan.route == "mma":  # every element written: by the sum over the workspace
        dw = torch.empty(tuple(w_shape), dtype=torch.float32, device=x.device)
        ws = torch.empty(wgrad_workspace_shape(plan, w_shape), dtype=torch.float32,
                         device=x.device)
    else:  # the CUDA-core body adds into dW with atomics
        dw = torch.zeros(tuple(w_shape), dtype=torch.float32, device=x.device)
        ws = None
    with torch.cuda.device(x.device):
        status = build.library().vg_conv3d_wgrad(
            x.data_ptr(), g.data_ptr(), dw.data_ptr(), None if ws is None else ws.data_ptr(),
            _DTYPES[x.dtype], x.shape[0], ci, co, *x.shape[2:], *g.shape[2:], kx, ky, kz,
            *stride, *[lo for lo, _ in pads], int(pad_mode == "reflect"), ROUTES[plan.route],
            plan.co_tile, plan.tap_warps, plan.split, 0 if ws is None else ws.numel() * 4,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "conv3d_wgrad")
    wgrad_launches += 1
    return dw
