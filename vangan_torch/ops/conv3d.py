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

A kernel with more than ``MMA_MAX_TAPS`` (64) taps, the ResNet generator's
7^3 stem and head, runs on the tensor cores at unit stride on one of two
bodies (``csrc/conv3d_taps.cuh``), which K1 and K2 share, and K3 on the same
two GEMMs:

- route 2, tap chunks, where the fold takes it (Co * kz <= 8; for K3 also Ci
  >= 16): the kz taps go on the GEMM's N (column co * kz + dz), the block
  stages a halo of columns of 16 z positions once per 16-channel chunk and
  walks the kernel one y slice (kx, 1, kz) at a time (``ConvPlan.tap_chunk``,
  ``tap_chunks``); the forward sums the shifted columns of its product in the
  epilogue, the weight gradient reads g shifted by dz (``csrc/conv3d_fwd.cu``,
  ``conv3d_wgrad.cu``). That is the head, 32 -> 1, in K1 and K3;
- route 3, one input channel (Ci = 1): the forward puts the (dx, dy) pairs
  on K (``ConvPlan.k_pairs``, 49 padded to 64 at 7^3), Co on N, a column of
  16 z outputs on M, the dz loop outside, over kz copies of the halo shifted
  along z; the weight gradient is that GEMM transposed, the pairs on M, Co
  on N and a column's 16 z positions on K, one warp per dz, over the same
  halo copies (``csrc/conv3d_wgrad.cu``). That is the stem, 1 -> 32, in K1
  and K3.

K2 above 64 taps at unit stride is the forward of g, zero-padded by k - 1,
with the flipped kernel and Ci and Co swapped, as in the TPU kernel: route 3
where g has one channel (the head, 32 <- 1), route 2 where dx has Ci * kz <=
8 (the stem, 1 <- 32), both inside ``csrc/conv3d_dgrad.cu``'s one launch,
whose epilogue writes dx and the reflect fold's buffer as its other routes
do.

Where a gradient is needed the op is a ``torch.autograd.Function`` whose
backward computes only what ``ctx.needs_input_grad`` asks for (the
generators' stem convs read data or detached inputs and need no dx):

- dx, ``conv3d_dgrad`` (the TPU kernel ``_conv_dgrad``):
  ``csrc/conv3d_dgrad.cu``, one launch per conv for every stride parity p
  (the transposed conv of the cotangent with the flipped parity sub-kernels,
  taps d = s*e + p), f32 accumulation, dx written in place at the strided
  positions s*o + p - lo in g's dtype, rounded once; a reflect pad's fold
  (the pad positions and the interior positions they fold onto) goes
  through a small f32 buffer and one fold launch, summed in
  ``pad.pad3d_grad``'s order. ``conv_plan("dgrad", ...)`` fixes the body,
  the Ci tile, the parity order and the fold, and the kernel runs the plan's
  order and fold tables (``dgrad_tables``); ``dgrad_weights`` arranges
  every parity's weights in one gather;
- dW, ``conv3d_wgrad`` (the TPU kernel ``_conv_wgrad``):
  ``csrc/conv3d_wgrad.cu``, accumulated and returned in f32; bit-identical
  from run to run on every route (split-K partial tiles summed in a fixed
  order, no atomics);
- dbias: a plain f32 sum of the cotangent, as in JAX.

On a CPU tensor each of these runs its plain version (``conv3d_dgrad_plain``,
``conv3d_wgrad_plain``).

The input and weight gradients are Functions too (``_Conv3dDgrad``,
``_Conv3dWgrad``), so the conv is differentiable to any order on both
devices: every backward calls only the three Functions' ``apply`` at the
conv's stride, pads and pad mode (the gradient penalty of WGAN-GP
differentiates the discriminator's input gradient). With D the input
gradient and W the weight gradient, D(g, w) is linear in g and w and W(x, g)
in x and g, and their adjoints are the conv and the other gradient:

- conv: dx = D(g, w), dw = W(x, g);
- D(g, w) with cotangent ddx: dg = conv(ddx, w), dw = W(ddx, g);
- W(x, g) with cotangent ddw: dg = conv(x, ddw), dx = D(g, ddw).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from vangan_torch.ops import build
from vangan_torch.ops.pad import Pad3, fold_positions, pad3d, pad3d_grad

# kernel launches (chip_smoke.py reads and resets them)
launches = 0             # conv3d forward
dgrad_launches = 0       # conv3d_dgrad (one per conv)
dgrad_fold_launches = 0  # its reflect-pad fold (one per reflect conv)
wgrad_launches = 0       # conv3d_wgrad
tap_chunk_launches = 0        # of the forward's, those on the tap chunks (route 2)
pair_launches = 0             # of the forward's, those on one input channel (route 3)
wgrad_tap_chunk_launches = 0  # of the weight gradient's, those on the tap chunks
wgrad_pair_launches = 0       # of the weight gradient's, those on one input channel (route 3)
dgrad_tap_launches = 0        # of the input gradient's, those on routes 2 and 3

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KMAX = 8  # largest kernel extent per axis the kernels take

# The plan's constants; the tensor-core ones mirror csrc/conv3d_common.cuh and
# the two sources.
ROUTES = {"f32": 0, "thin": 0, "mma": 1}  # route -> the C entry points' body
BRICK = (4, 8, 8)       # output voxels per tensor-core block (x, y, z)
CI_CHUNK = 16           # input channels per MMA k-step
MMA_WARPS = 8
THIN_MAX_CI = 3         # forward: a bf16 conv with Ci <= 3 takes the CUDA-core body
MMA_MAX_TAPS = 64       # the largest tap chunk a tensor-core block walks at once
FOLD_COLUMNS = (4, 8)   # route 2 (tap chunks): a block's columns in x and y
FOLD_ROWS = 16          # z positions of a column: one MMA row tile / k-step
FOLD_N = 8              # its N: the Co * kz columns (co * kz + dz), one n tile
FOLD_G_ROW = 24         # its weight gradient's staged g per column and channel
PAIR_MAX_CO_TILE = 32   # route 3 (one input channel, FOLD_COLUMNS of FOLD_ROWS z
                        # outputs): its N tile, four n tiles of accumulators a column
PAIR_OUT_PAD = 4        # floats between its staged output rows of two channels
FWD_MAX_CO_TILE = 64
DGRAD_MAX_CI_TILE = 64
DGRAD_MULTI_MAX_CI_TILE = 32  # a strided conv's parity loop spills registers above it
MAX_PARITIES = 64       # stride parities (sx * sy * sz) the input gradient's launch takes
MAX_FOLD_PAD = KMAX - 1  # widest reflect pad per side its fold takes
WGRAD_MAX_CO_TILE = 32
WGRAD_TAPS_PER_WARP = 4
MAX_SMEM = 227 * 1024   # shared memory a block may use (H100)
DGRAD_STATIC_SMEM = 656  # the input gradient's static shared memory (its Geo struct)
SMS = 132
WGRAD_TARGET_BLOCKS = 4 * SMS  # two waves of two resident blocks per SM
WGRAD_CORE_TARGET_BLOCKS = 10 * SMS  # the CUDA-core body's blocks (one 4x4 tile a thread)
WGRAD_CORE_TILES = ((16, 256), (32, 128), (64, 64))  # its (Co, columns) tiles, as the source
WGRAD_CORE_CHUNK = 32  # voxels per chunk of the CUDA-core body
WORKSPACE_CAP = 64 << 20       # bytes of the weight gradient's split-K workspace


@dataclass(frozen=True)
class ConvPlan:
    """How a conv kernel runs one shape (``conv_plan``).

    ``route``: ``"mma"`` (tensor cores, bfloat16), ``"f32"`` or ``"thin"``
    (the CUDA-core body, float32 or bfloat16). The rest is the tensor-core
    route's tiling: a block owns a ``brick`` of output voxels (and, for the
    weight gradient, a 16-channel ``ci_chunk`` of Ci and a group of taps) and
    a ``co_tile`` of the GEMM's N, its output channels (Co; Ci for the input
    gradient), ``co_tiles`` of them; the weight gradient splits
    the (sample, brick) pairs over ``split`` blocks and ``tap_warps`` warps
    share out the taps (the other warps split the voxels), writing
    ``workspace_bytes`` of f32 partial tiles. On the CUDA-core route the
    weight gradient's ``split`` blocks along the voxels write one slice of
    the workspace each. ``pad_share`` is the share of the issued MMA work
    that is padding (ragged bricks, Co tiles, Ci chunks).

    The input gradient's plan also holds, on every route: ``parities``, each
    stride parity as (p, sub-kernel extents, positions of the padded input
    with that parity), in the order its one launch runs them (most taps
    first; a parity with no taps writes zeros); ``fold``, per axis the
    padded positions a reflect pad's fold reads (the pad positions and the
    interior positions they fold onto; empty for a zero pad), whose f32
    values go through a ``fold_bytes`` buffer; ``launches``, 1 plus 1
    for the fold launch; and, on the tensor-core route, ``shared_halo``: a
    block stages g's halo once for all its parities. ``smem_bytes`` is the
    dynamic shared memory of a tensor-core launch (the input gradient's also
    holds ``DGRAD_STATIC_SMEM`` of static).

    A forward or weight gradient with more than ``MMA_MAX_TAPS`` taps on the
    tensor-core route runs in tap chunks: ``tap_chunks`` y slices of
    ``tap_chunk`` = (kx, 1, kz) taps over one staged halo, the kz taps on the
    GEMM's N (``co_tile`` ``FOLD_N``); its ``brick`` is the outputs of
    ``FOLD_COLUMNS`` columns of ``FOLD_ROWS`` z positions, ``FOLD_ROWS - kz +
    1`` each. Its weight gradient writes one workspace slice per block along
    the voxels (``split``), as the CUDA-core body. A forward or weight
    gradient with one input channel and more than ``MMA_MAX_TAPS`` taps puts
    the (dx, dy) pairs on the GEMM's K (forward) or M (weight gradient):
    ``k_pairs`` of them (kx * ky padded to a multiple of 16), a ``brick`` of
    ``FOLD_COLUMNS`` columns of ``FOLD_ROWS`` z outputs, Co tiles of at most
    ``PAIR_MAX_CO_TILE``; its weight gradient writes one workspace slice per
    block along the voxels (``split``). The input gradient above 64 taps at
    unit stride runs either forward body on g (``body`` 2 or 3).
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
    parities: tuple = ()
    fold: tuple = ((), (), ())
    fold_bytes: int = 0
    launches: int = 1
    shared_halo: bool = False
    tap_chunk: Tuple[int, ...] = ()
    tap_chunks: int = 0
    k_pairs: int = 0

    @property
    def workspace_slices(self) -> int:
        if self.op != "wgrad":
            return 0
        if self.route == "mma" and not (self.tap_chunks or self.k_pairs):
            return self.split * (MMA_WARPS // self.tap_warps)
        return self.split

    @property
    def body(self) -> int:
        """The C entry's route: 0 CUDA cores, 1 tensor cores, 2 tensor cores
        in tap chunks, 3 tensor cores for one input channel."""
        if self.k_pairs:
            return 3
        return 2 if self.tap_chunks else ROUTES[self.route]


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
              thin_max_ci: int = THIN_MAX_CI,
              in_dims: Optional[Sequence[int]] = None, pads: Optional[Pad3] = None,
              pad_mode: str = "zeros") -> ConvPlan:
    """The kernel body and tiles for one conv launch.

    ``op`` is ``"fwd"`` (K1), ``"dgrad"`` (K2; it also needs the input's
    ``in_dims``, ``pads`` and ``pad_mode``) or ``"wgrad"`` (K3); ``ci``, ``co``
    are the conv's channels and ``out_dims`` the output's (Xo, Yo, Zo).
    float32 always takes the CUDA-core route. bfloat16 takes the tensor-core
    route unless the shape has more than 64 taps (for K2: a parity
    sub-kernel) outside the tap chunks (``_fold_plan``) and the one-channel
    body (``_pair_plan``: a forward or weight gradient with Ci = 1, or K2
    whose g has one channel), its tiles do not fit in shared memory, or the
    GEMM's 16-channel k-step would be mostly padding (the forward's Ci, the
    input gradient's Co <= ``thin_max_ci``, at 64 taps or fewer): those take
    the CUDA-core body (``"thin"``). The N tile is at most 64 for the
    forward and a unit-stride input gradient, 32 for a strided input
    gradient (its parity loop spills registers above it) and the weight
    gradient. What no body takes raises ValueError.
    """
    return _conv_plan(op, int(ci), int(co), tuple(k), tuple(stride), tuple(out_dims), dtype,
                      int(batch), thin_max_ci,
                      None if in_dims is None else tuple(in_dims),
                      None if pads is None else tuple(tuple(p) for p in pads), pad_mode)


@functools.lru_cache(maxsize=1024)
def _conv_plan(op, ci, co, k, stride, out_dims, dtype, batch, thin_max_ci, in_dims, pads,
               pad_mode) -> ConvPlan:
    """``conv_plan`` on hashable arguments, cached: a wrapper asks for the
    same few plans every step."""
    if op not in ("fwd", "dgrad", "wgrad"):
        raise ValueError(f"conv_plan: op {op!r}")
    if dtype not in _DTYPES:
        raise TypeError(f"conv_plan: no kernel for {dtype}")
    if op == "dgrad":
        return _dgrad_plan(ci, co, k, stride, out_dims, dtype, batch, thin_max_ci, in_dims,
                           pads, pad_mode)
    taps = math.prod(k)
    if dtype == torch.float32:
        return _core_plan(op, "f32", ci, co, taps, out_dims, batch)
    thin = _core_plan(op, "thin", ci, co, taps, out_dims, batch)
    if ci == 1 and taps > MMA_MAX_TAPS:
        return _pair_plan(op, co, k, stride, out_dims, batch) or thin
    if op == "fwd" and ci <= thin_max_ci:
        return thin
    if taps > MMA_MAX_TAPS:
        return _fold_plan(op, ci, co, k, stride, out_dims, batch) or thin
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


def _fold_plan(op, ci, co, k, stride, out_dims, batch) -> Optional[ConvPlan]:
    """The tensor-core route in tap chunks for a kernel of more than
    ``MMA_MAX_TAPS`` taps (route 2 of the forward and the weight gradient),
    or None where it does not take the shape: a stride other than 1, more
    than ``FOLD_N`` columns Co * kz, or, for the weight gradient, Ci < 16
    (its M is a 16-channel chunk). Its issued work counts every column of 16
    z positions, ``FOLD_N`` N columns and the chunks' padding channels."""
    kx, ky, kz = k
    if stride != (1, 1, 1) or co * kz > FOLD_N or (op == "wgrad" and ci < CI_CHUNK):
        return None
    brick = (*FOLD_COLUMNS, FOLD_ROWS - kz + 1)
    chunks = -(-ci // CI_CHUNK)
    bricks = batch * math.prod(-(-n // b) for n, b in zip(out_dims, brick))
    halo = (FOLD_COLUMNS[0] + kx - 1) * (FOLD_COLUMNS[1] + ky - 1) * FOLD_ROWS * 32
    useful = batch * math.prod(out_dims) * co * ci * kx * ky * kz
    issued = bricks * math.prod(FOLD_COLUMNS) * FOLD_ROWS * chunks * CI_CHUNK * kx * ky * FOLD_N
    common = dict(brick=brick, co_tile=FOLD_N, co_tiles=1, tap_chunk=(kx, 1, kz),
                  tap_chunks=ky, pad_share=1.0 - useful / issued)
    if op == "fwd":
        smem = halo + 2 * kx * ky * FOLD_N * 32  # the halo, two chunks' weights
        return ConvPlan(op, "mma", smem_bytes=smem, **common) if smem <= MAX_SMEM else None
    smem = halo + co * math.prod(FOLD_COLUMNS) * FOLD_G_ROW * 2  # the halo, g's columns
    per_split = co * ci * kx * ky * kz * 4
    split = min(-(-WGRAD_TARGET_BLOCKS // chunks), bricks, 65535, WORKSPACE_CAP // per_split)
    if split < 1 or smem > MAX_SMEM:
        return None
    return ConvPlan(op, "mma", split=split, workspace_bytes=split * per_split, smem_bytes=smem,
                    **common)


def _pair_plan(op, co, k, stride, out_dims, batch) -> Optional[ConvPlan]:
    """The tensor-core body for one input channel (route 3) of a forward
    (for ``op`` "dgrad": the forward of g that computes the input gradient)
    or of a weight gradient, or None where it does not take the shape (a
    stride other than 1). Both count as issued work every column of
    ``FOLD_ROWS`` z outputs, the Co tiles' padding and the ``k_pairs``
    pairs of each of the kz taps: the forward's K is the weight gradient's
    M. The weight gradient splits the (sample, brick) pairs over ``split``
    blocks for each Co tile, each writing one slice of the workspace (as
    route 2), and stages the kz halo copies beside the Co tile's g columns
    (``FOLD_COLUMNS`` of ``FOLD_ROWS`` z each)."""
    kx, ky, kz = k
    if stride != (1, 1, 1):
        return None
    k_pairs = -(-kx * ky // 16) * 16
    co_tile, co_tiles = _co_tiling(co, PAIR_MAX_CO_TILE)
    brick = (*FOLD_COLUMNS, FOLD_ROWS)
    bricks = batch * math.prod(-(-n // b) for n, b in zip(out_dims, brick))
    rows = (FOLD_COLUMNS[0] + kx - 1) * (FOLD_COLUMNS[1] + ky - 1)
    useful = batch * math.prod(out_dims) * co * kx * ky * kz
    issued = bricks * math.prod(brick) * co_tiles * co_tile * k_pairs * kz
    common = dict(brick=brick, co_tile=co_tile, co_tiles=co_tiles, pad_share=1.0 - useful / issued,
                  k_pairs=k_pairs)
    if op == "wgrad":
        smem = kz * rows * 32 + math.prod(FOLD_COLUMNS) * co_tile * 32  # the halo's copies, g
        per_split = co * kx * ky * kz * 4
        split = min(-(-WGRAD_TARGET_BLOCKS // co_tiles), bricks, 65535,
                    WORKSPACE_CAP // per_split)
        if split < 1 or smem > MAX_SMEM:
            return None
        return ConvPlan(op, "mma", split=split, workspace_bytes=split * per_split,
                        smem_bytes=smem, **common)
    staged = kz * rows * 32 + kz * k_pairs * co_tile * 2  # the halo's copies, the weights
    out = co_tile * (math.prod(FOLD_COLUMNS) * FOLD_ROWS + PAIR_OUT_PAD) * 4
    smem = max(staged, out)
    if smem > MAX_SMEM:
        return None
    return ConvPlan(op, "mma", smem_bytes=smem, **common)


def _core_plan(op, route, ci, co, taps, out_dims, batch) -> ConvPlan:
    """The CUDA-core body's plan. For the weight gradient: its blocks' split
    over the voxels, each block one slice of the workspace (``split``, Co,
    Ci * taps) that a second launch sums in slice order; the tile is the
    source's least padded one."""
    if op != "wgrad":
        return ConvPlan(op, route)
    ncols = ci * taps
    mt, nt = min(WGRAD_CORE_TILES, key=lambda t: -(-co // t[0]) * t[0] * -(-ncols // t[1]) * t[1])
    tiles = -(-co // mt) * -(-ncols // nt)
    chunks = -(-batch * math.prod(out_dims) // WGRAD_CORE_CHUNK)
    per_split = co * ncols * 4
    split = max(1, min(-(-WGRAD_CORE_TARGET_BLOCKS // tiles), chunks, 65535,
                       WORKSPACE_CAP // per_split))
    return ConvPlan(op, route, split=split, workspace_bytes=split * per_split)


def _dgrad_plan(ci, co, k, stride, g_dims, dtype, batch, thin_max_ci, in_dims, pads,
                pad_mode) -> ConvPlan:
    """``conv_plan("dgrad", ...)``: the input gradient's one launch (plus its
    fold) for x (batch, ci, *in_dims) padded by ``pads`` and g (batch, co,
    *g_dims). The kernel takes its parity order and fold tables
    (``dgrad_tables``) and refuses a ``smem_bytes`` other than its own. Above
    64 taps at unit stride it runs a forward body over the padded positions:
    route 3 for g of one channel, route 2 (tap chunks) for Ci * kz <=
    ``FOLD_N``, else the CUDA-core body."""
    if in_dims is None or pads is None:
        raise ValueError("conv_plan('dgrad') needs in_dims and pads")
    if pad_mode not in ("zeros", "reflect"):
        raise ValueError(f"conv_plan('dgrad'): pad_mode {pad_mode!r}")
    xp = padded_dims(in_dims, pads)
    if any(n != (xx - kk) // s + 1 for n, xx, kk, s in zip(g_dims, xp, k, stride)):
        raise ValueError(f"conv_plan('dgrad'): g dims {tuple(g_dims)} do not match the padded "
                         f"input {xp}")
    order = tuple(dgrad_launch_order(k, stride, xp))
    if len(order) > MAX_PARITIES:
        raise ValueError(f"conv_plan('dgrad'): {len(order)} stride parities, the kernel takes "
                         f"{MAX_PARITIES}")
    fold, fold_bytes = ((), (), ()), 0
    if pad_mode == "reflect" and any(lo or hi for lo, hi in pads):
        if max(max(p) for p in pads) > MAX_FOLD_PAD:
            raise ValueError(f"conv_plan('dgrad'): reflect pads {pads} wider than "
                             f"{MAX_FOLD_PAD}")
        fold = tuple(fold_positions(n, lo, hi) for n, (lo, hi) in zip(in_dims, pads))
        (X, Y, Z), (nx, ny, nz) = xp, (len(f) for f in fold)
        fold_bytes = batch * ci * (nx * Y * Z + X * ny * Z + X * Y * nz) * 4
    common = dict(parities=order, fold=fold, fold_bytes=fold_bytes,
                  launches=1 + bool(fold_bytes))
    live = [(e, n) for _, e, n in order if math.prod(e) > 0]
    order_by_p = {p: e for p, e, _ in order}
    order_by_p_dims = next(n for p, _, n in order if p == (0, 0, 0))  # the brick grid
    taps_max = max(math.prod(e) for e, _ in live)
    if dtype == torch.float32:
        return ConvPlan("dgrad", "f32", **common)
    if taps_max > MMA_MAX_TAPS and stride == (1, 1, 1):
        # the forward of g zero-padded by k - 1 over the padded positions,
        # the flipped kernel with Ci and Co swapped: g's Co channels in, Ci out
        fwd = (_pair_plan("dgrad", ci, k, stride, xp, batch) if co == 1 else
               _fold_plan("fwd", co, ci, k, stride, xp, batch))
        if fwd is None:
            return ConvPlan("dgrad", "thin", **common)
        return dataclasses.replace(fwd, op="dgrad", **common)
    if taps_max > MMA_MAX_TAPS or co <= thin_max_ci:
        return ConvPlan("dgrad", "thin", **common)
    # shared memory: one parity's weights of a chunk, and g's halo: every
    # chunk's for parity 0 (the largest sub-kernel on every axis), staged once
    # per block for all the parities, where that fits two blocks on an SM;
    # else one chunk's, staged per parity
    halo0 = _halo_voxels(order_by_p[(0, 0, 0)], (1, 1, 1)) * 32
    chunks = -(-co // CI_CHUNK)
    tile_cap = DGRAD_MAX_CI_TILE if len(order) == 1 else DGRAD_MULTI_MAX_CI_TILE
    while tile_cap >= 8:
        ci_tile, ci_tiles = _co_tiling(ci, tile_cap)
        w_bytes = taps_max * ci_tile * 32
        shared = len(live) > 1 and \
            w_bytes + chunks * halo0 + DGRAD_STATIC_SMEM <= MAX_SMEM // 2
        smem = w_bytes + (chunks if shared else 1) * halo0
        if smem + DGRAD_STATIC_SMEM <= MAX_SMEM:
            break
        tile_cap -= 8
    else:
        return ConvPlan("dgrad", "thin", **common)
    bricks = batch * math.prod(-(-n // b) for n, b in zip(order_by_p_dims, BRICK))
    useful = sum(batch * math.prod(n) * math.prod(e) for e, n in live) * ci * co
    issued = bricks * math.prod(BRICK) * sum(math.prod(e) for e, _ in live) \
        * ci_tiles * ci_tile * chunks * CI_CHUNK
    return ConvPlan("dgrad", "mma", co_tile=ci_tile, co_tiles=ci_tiles, smem_bytes=smem,
                    pad_share=1.0 - useful / issued, shared_halo=shared, **common)


def dgrad_launch_order(k: Sequence[int], stride: Sequence[int], padded: Sequence[int]) -> list:
    """Every stride parity of the input gradient, empty ones included, as
    (p, sub-kernel extents, positions of the padded input with that parity),
    most taps first (ties in product order): the order of the kernel's grid,
    so the longest blocks start first."""
    per_axis = [[(p, len(range(p, kk, s)), -(-(n - p) // s)) for p in range(s)]
                for kk, s, n in zip(k, stride, padded)]
    every = [(tuple(a[0] for a in par), tuple(a[1] for a in par), tuple(a[2] for a in par))
             for par in itertools.product(*per_axis)]
    return sorted(every, key=lambda t: -math.prod(t[1]))


@functools.lru_cache(maxsize=256)
def dgrad_tables(plan: ConvPlan, stride: Tuple[int, int, int]) -> Tuple[ctypes.Array,
                                                                        ctypes.Array]:
    """The input gradient plan's geometry as the C entry takes it: the parity
    order (each parity's product index (px * sy + py) * sz + pz, in launch
    order) and the fold table (per axis the number of fold positions, then
    the positions of x, y and z)."""
    sx, sy, sz = stride
    order = [(px * sy + py) * sz + pz for (px, py, pz), _, _ in plan.parities]
    fold = [len(f) for f in plan.fold] + [p for f in plan.fold for p in f]
    return (ctypes.c_int * len(order))(*order), (ctypes.c_int * len(fold))(*fold)


def _mma_layout(w: torch.Tensor, n_tile: int, fill=0) -> torch.Tensor:
    """(N, K channels, kx, ky, kz) as [K chunk][N tile][tap][n_tile][16],
    padded with ``fill`` in K and N: the tensor-core weight layout."""
    n, kch = w.shape[:2]
    taps = math.prod(w.shape[2:])
    chunks, tiles = -(-kch // CI_CHUNK), -(-n // n_tile)
    wp = F.pad(w.reshape(n, kch, taps), (0, 0, 0, chunks * CI_CHUNK - kch, 0, tiles * n_tile - n),
               value=fill)
    return wp.reshape(tiles, n_tile, chunks, CI_CHUNK, taps).permute(2, 0, 4, 1, 3).contiguous()


@functools.lru_cache(maxsize=256)
def _dgrad_weight_index(w_shape, stride, ci_tile, device) -> torch.Tensor:
    """Where each element of ``dgrad_weights``' buffer comes from in the flat
    weight (its size for a padding zero)."""
    n = math.prod(w_shape)
    ids = torch.arange(n, dtype=torch.int64).reshape(w_shape)
    sx, sy, sz = stride
    parts = []
    for px, py, pz in itertools.product(range(sx), range(sy), range(sz)):
        sub = ids[:, :, px::sx, py::sy, pz::sz]
        if sub.numel():
            parts.append(_mma_layout(sub.flip((2, 3, 4)).transpose(0, 1), ci_tile, n).reshape(-1))
    return torch.cat(parts).to(device)


def dgrad_weights(w: torch.Tensor, stride: Sequence[int], ci_tile: int,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The tensor-core input gradient's weights, every parity's in one flat
    buffer (bfloat16 for the kernel): for each stride parity p with taps, in
    product order, the flipped sub-kernel
    ``w[:, :, px::sx, py::sy, pz::sz].flip(2, 3, 4)`` with Ci and Co
    swapped, in ``mma_weights``' layout ([Co chunk][Ci tile][tap][ci_tile]
    [16], zero-padded), one after the other. One gather per call (its index
    cached per shape); runs on any device."""
    idx = _dgrad_weight_index(tuple(w.shape), tuple(stride), ci_tile, w.device)
    return F.pad(w.detach().reshape(-1).to(dtype), (0, 1))[idx]


def wgrad_workspace_shape(plan: ConvPlan, w_shape: Sequence[int]) -> Tuple[int, int, int]:
    """(slices, Co, Ci * taps): the f32 partial tiles of K3, which its sum
    launch adds in slice order."""
    co, ci = w_shape[:2]
    return plan.workspace_slices, co, ci * math.prod(w_shape[2:])


def mma_weights(w: torch.Tensor, co_tile: int) -> torch.Tensor:
    """The forward's tensor-core weights: (Co, Ci, kx, ky, kz) rearranged as
    [Ci chunk][Co tile][tap][co_tile][16] bfloat16, zero-padded in Ci and Co,
    so each block stages a chunk with 16-byte copies."""
    return _mma_layout(w.to(torch.bfloat16), co_tile)


def fold_weights(w: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The forward's weights in tap chunks (Co * kz <= ``FOLD_N``): (Co, Ci,
    kx, ky, kz) rearranged as [Ci chunk][dx][dy][n][16] with n = co * kz +
    dz, zero-padded in Ci and n (bfloat16 for the kernel): a chunk's (dx, dy)
    pairs, each the B tile of one MMA k-step."""
    co, ci, kx, ky, kz = w.shape
    if co * kz > FOLD_N:
        raise ValueError(f"fold_weights: Co * kz = {co * kz} > {FOLD_N}")
    chunks = -(-ci // CI_CHUNK)
    wf = w.to(dtype).permute(1, 2, 3, 0, 4).reshape(ci, kx, ky, co * kz)
    wf = F.pad(wf, (0, FOLD_N - co * kz, 0, 0, 0, 0, 0, chunks * CI_CHUNK - ci))
    return wf.reshape(chunks, CI_CHUNK, kx, ky, FOLD_N).permute(0, 2, 3, 4, 1).contiguous()


def pair_weights(w: torch.Tensor, co_tile: int, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The forward's weights for one input channel (route 3): (Co, 1, kx,
    ky, kz) rearranged as [Co tile][dz][k-step][co_tile][16] with pair
    dx * ky + dy = 16 * k-step + column, zero-padded in the pairs and Co
    (bfloat16 for the kernel): the B tile of each (dz, k-step) MMA."""
    co, ci, kx, ky, kz = w.shape
    if ci != 1:
        raise ValueError(f"pair_weights: Ci = {ci}, the body takes one input channel")
    steps, tiles = -(-kx * ky // 16), -(-co // co_tile)
    wp = F.pad(w.to(dtype).reshape(co, kx * ky, kz),
               (0, 0, 0, steps * 16 - kx * ky, 0, tiles * co_tile - co))
    return wp.reshape(tiles, co_tile, steps, 16, kz).permute(0, 4, 2, 1, 3).contiguous()


def dgrad_forward_weights(w: torch.Tensor) -> torch.Tensor:
    """The forward kernel whose conv of g, zero-padded by k - 1, is the
    unit-stride input gradient: ``w`` flipped on every axis, Ci and Co
    swapped."""
    return w.flip((2, 3, 4)).transpose(0, 1)


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
    the padded shape in f32 (f64 for a f64 ``g``), the pad folded back,
    rounded to g's dtype."""
    acc = torch.promote_types(g.dtype, torch.float32)
    xp_shape = (*x_shape[:2], *padded_dims(x_shape[2:], pads))
    dxp = torch.nn.grad.conv3d_input(xp_shape, w.to(acc), g.to(acc), tuple(stride))
    return pad3d_grad(dxp, pads, pad_mode).to(g.dtype)


def conv3d_wgrad_plain(x: torch.Tensor, g: torch.Tensor, w_shape: Sequence[int],
                       stride: Sequence[int], pads: Pad3, pad_mode: str) -> torch.Tensor:
    """dL/dw of ``conv3d_plain`` in f32 (f64 for a f64 ``x``): ``conv3d_weight``
    on the padded input."""
    acc = torch.promote_types(x.dtype, torch.float32)
    return torch.nn.grad.conv3d_weight(pad3d(x.to(acc), pads, pad_mode), tuple(w_shape),
                                       g.to(acc), tuple(stride))


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
    cotangent ``g``: ``csrc/conv3d_dgrad.cu`` on a CUDA tensor (one launch,
    and one fold launch for a reflect pad), ``conv3d_dgrad_plain`` on a CPU
    tensor."""
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
        ctx.conf = (stride, pads, pad_mode)
        ctx.has_bias = bias is not None
        ctx.set_materialize_grads(False)
        return _forward(x, w, bias, stride, pads, pad_mode)

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return None, None, None, None, None, None
        x, w = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        g = g.contiguous()
        dx = _Conv3dDgrad.apply(g, w, tuple(x.shape), *ctx.conf).to(x.dtype) if need_x else None
        dw = _Conv3dWgrad.apply(x, g, tuple(w.shape), *ctx.conf).to(w.dtype) if need_w else None
        db = g.to(torch.promote_types(g.dtype, torch.float32)).sum(dim=(0, 2, 3, 4)) \
            if ctx.has_bias and need_b else None
        return dx, dw, db, None, None, None


class _Conv3dDgrad(torch.autograd.Function):
    """dx = D(g, w) (K2, ``conv3d_dgrad``), differentiable in g and w."""

    @staticmethod
    def forward(ctx, g, w, x_shape, stride, pads, pad_mode):
        ctx.save_for_backward(g, w)
        ctx.conf = (stride, pads, pad_mode)
        ctx.set_materialize_grads(False)
        return conv3d_dgrad(g, w, x_shape, stride, pads, pad_mode)

    @staticmethod
    def backward(ctx, ddx):
        if ddx is None:
            return None, None, None, None, None, None
        g, w = ctx.saved_tensors
        need_g, need_w = ctx.needs_input_grad[:2]
        ddx = ddx.to(g.dtype).contiguous()
        dg = _Conv3d.apply(ddx, w, None, *ctx.conf) if need_g else None
        dw = _Conv3dWgrad.apply(ddx, g, tuple(w.shape), *ctx.conf).to(w.dtype) \
            if need_w else None
        return dg, dw, None, None, None, None


class _Conv3dWgrad(torch.autograd.Function):
    """dw = W(x, g) (K3, ``conv3d_wgrad``, f32), differentiable in x and g."""

    @staticmethod
    def forward(ctx, x, g, w_shape, stride, pads, pad_mode):
        ctx.save_for_backward(x, g)
        ctx.conf = (stride, pads, pad_mode)
        ctx.set_materialize_grads(False)
        return conv3d_wgrad(x, g, w_shape, stride, pads, pad_mode)

    @staticmethod
    def backward(ctx, ddw):
        if ddw is None:
            return None, None, None, None, None, None
        x, g = ctx.saved_tensors
        need_x, need_g = ctx.needs_input_grad[:2]
        dx = _Conv3dDgrad.apply(g.to(x.dtype).contiguous(), ddw, tuple(x.shape),
                                *ctx.conf).to(x.dtype) if need_x else None
        dg = _Conv3d.apply(x, ddw, None, *ctx.conf).to(g.dtype) if need_g else None
        return dx, dg, None, None, None, None


def _forward(x, w, bias, stride, pads, pad_mode):
    global launches, tap_chunk_launches, pair_launches
    if x.device.type == "cpu":
        return conv3d_plain(x, w, bias, stride, pads, pad_mode)
    _check_cuda(x, w.shape, "conv3d")
    dims = [(n + lo + hi - kk) // s + 1
            for n, (lo, hi), kk, s in zip(x.shape[2:], pads, w.shape[2:], stride)]
    plan = conv_plan("fwd", x.shape[1], w.shape[0], w.shape[2:], stride, dims, x.dtype,
                     x.shape[0])
    y = _launch_fwd(x, w, bias, stride, [lo for lo, _ in pads], pad_mode == "reflect", dims,
                    "conv3d", plan)
    launches += 1
    tap_chunk_launches += bool(plan.tap_chunks)
    pair_launches += bool(plan.k_pairs)
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
    if plan.k_pairs:
        w = pair_weights(w, plan.co_tile)
    elif plan.tap_chunks:
        w = fold_weights(w)
    elif plan.route == "mma":
        w = mma_weights(w, plan.co_tile)
    else:
        w = w.to(x.dtype).contiguous()
    if bias is not None:
        bias = bias.detach().to(device=x.device, dtype=x.dtype).contiguous()
    y = torch.empty((b, co, *out_dims), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        status = build.library().vg_conv3d_fwd(
            x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(), y.data_ptr(),
            _DTYPES[x.dtype], b, ci, co, X, Y, Z, *out_dims, kx, ky, kz, *stride, *lo_pads,
            int(reflect), plan.body, plan.co_tile,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, name)
    return y


def _conv3d_dgrad_cuda(g, w, x_shape, stride, pads, pad_mode, plan=None):
    """One launch of K2 (and its fold launch); ``plan`` defaults to
    ``conv_plan``'s."""
    global dgrad_launches, dgrad_fold_launches, dgrad_tap_launches
    _check_cuda(g, w.shape, "conv3d_dgrad")
    b, ci = x_shape[:2]
    co, k = w.shape[0], tuple(w.shape[2:])
    if tuple(g.shape[:2]) != (b, co) or w.shape[1] != ci or len(x_shape) != 5:
        raise ValueError(f"conv3d_dgrad: shapes g {tuple(g.shape)}, w {tuple(w.shape)}, "
                         f"x {tuple(x_shape)}")
    g = g.contiguous()
    if plan is None:
        plan = conv_plan("dgrad", ci, co, k, stride, g.shape[2:], g.dtype, b,
                         in_dims=x_shape[2:], pads=pads, pad_mode=pad_mode)
    order, fold = dgrad_tables(plan, tuple(stride))
    w = w.detach().to(g.device)
    if plan.body == 1:
        w = dgrad_weights(w, stride, plan.co_tile)
    elif plan.body == 2:
        w = fold_weights(dgrad_forward_weights(w))
    elif plan.body == 3:
        w = pair_weights(dgrad_forward_weights(w), plan.co_tile)
    else:
        w = w.to(g.dtype).contiguous()
    dx = torch.empty(tuple(x_shape), dtype=g.dtype, device=g.device)
    buf = torch.empty(plan.fold_bytes // 4, dtype=torch.float32, device=g.device) \
        if plan.fold_bytes else None
    with torch.cuda.device(g.device):
        status = build.library().vg_conv3d_dgrad(
            g.data_ptr(), w.data_ptr(), dx.data_ptr(), None if buf is None else buf.data_ptr(),
            _DTYPES[g.dtype], b, ci, co, *x_shape[2:], *g.shape[2:], *k, *stride,
            *[lo for lo, _ in pads], *[hi for _, hi in pads], int(pad_mode == "reflect"), order,
            fold, plan.body, plan.co_tile, int(plan.shared_halo), plan.smem_bytes,
            plan.fold_bytes, torch.cuda.current_stream(g.device).cuda_stream)
    build.check(status, "conv3d_dgrad")
    dgrad_launches += 1
    dgrad_fold_launches += plan.launches - 1
    dgrad_tap_launches += plan.body in (2, 3)
    return dx


def _conv3d_wgrad_cuda(x, g, w_shape, stride, pads, pad_mode, plan=None):
    """One launch of K3 (and its sum launch); ``plan`` defaults to
    ``conv_plan``'s."""
    global wgrad_launches, wgrad_tap_chunk_launches, wgrad_pair_launches
    _check_cuda(x, w_shape, "conv3d_wgrad")
    co, ci, kx, ky, kz = w_shape
    if ci != x.shape[1] or g.dim() != 5 or co != g.shape[1]:
        raise ValueError(f"conv3d_wgrad: shapes x {tuple(x.shape)}, g {tuple(g.shape)}, "
                         f"w {tuple(w_shape)}")
    x = x.contiguous()
    g = g.to(x.dtype).contiguous()
    if plan is None:
        plan = conv_plan("wgrad", ci, co, (kx, ky, kz), stride, g.shape[2:], x.dtype,
                         x.shape[0])
    # every element of dW is written, by the sum over the workspace's slices
    dw = torch.empty(tuple(w_shape), dtype=torch.float32, device=x.device)
    ws = torch.empty(wgrad_workspace_shape(plan, w_shape), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        status = build.library().vg_conv3d_wgrad(
            x.data_ptr(), g.data_ptr(), dw.data_ptr(), ws.data_ptr(), _DTYPES[x.dtype],
            x.shape[0], ci, co, *x.shape[2:], *g.shape[2:], kx, ky, kz, *stride,
            *[lo for lo, _ in pads], int(pad_mode == "reflect"), plan.body,
            plan.co_tile, plan.tap_warps, plan.split, ws.numel() * 4,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "conv3d_wgrad")
    wgrad_launches += 1
    wgrad_tap_chunk_launches += bool(plan.tap_chunks)
    wgrad_pair_launches += bool(plan.k_pairs)
    return dw
