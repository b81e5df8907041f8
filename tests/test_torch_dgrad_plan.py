"""The input gradient's (K2, ``csrc/conv3d_dgrad.cu``) and the InstanceNorm
backward's (K5, ``csrc/instnorm_bwd.cu``) plans and index contracts, on the
CPU.

- ``conv_plan("dgrad", ...)`` at every kernel conv shape of the path: the
  body, the Ci tile, one launch (plus the fold's), the parity order and the
  planes a reflect pad folds, and the tables the kernel takes for them
  (``dgrad_tables``); the static shared memory the plan counts.
- ``dgrad_weights``: each parity's block of the arranged buffer is the
  flipped sub-kernel with Ci and Co swapped.
- An emulation of the kernel's index contract in plain torch (the arranged
  weights, the parity grid in the order the plan's table gives the kernel,
  the strided epilogue positions, the fold buffer's layout from the plan's
  fold table and the fold's order) reproduces
  ``conv3d_dgrad_plain`` in float32 within 1e-6 of its max |dx| (f32 sums
  in another order: a parity's sub-conv against ``conv3d_input``).
- ``bwd_plan`` at every InstanceNorm shape of the path.

The kernels' own results are checked on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_conv3d_plan import BATCH, PATH_CONVS, _geometry

from vangan_torch.ops import conv3d as C
from vangan_torch.ops import instnorm as I
from vangan_torch.ops.pad import _reflect, fold_positions, fold_targets

BF16 = torch.bfloat16


def _dgrad_plan(name, dtype=BF16):
    ci, co, k, s, pads, out = _geometry(name)
    n = PATH_CONVS[name][6]
    return C.conv_plan("dgrad", ci, co, k, s, out, dtype, BATCH, in_dims=(n,) * 3, pads=pads,
                       pad_mode=PATH_CONVS[name][5])


@pytest.mark.parametrize("name", sorted(PATH_CONVS))
def test_dgrad_plan_at_path_shapes(name):
    ci, co, k, s, pads, out = _geometry(name)
    n, pad_mode = PATH_CONVS[name][6], PATH_CONVS[name][5]
    plan = _dgrad_plan(name)
    # the head (Co = 1) takes the CUDA-core body, as its forward's Ci would
    assert plan.route == ("thin" if co <= C.THIN_MAX_CI else "mma")
    if plan.route == "mma":
        cap = C.DGRAD_MAX_CI_TILE if s == (1, 1, 1) else C.DGRAD_MULTI_MAX_CI_TILE
        assert plan.co_tile % 8 == 0 and 8 <= plan.co_tile <= cap
        assert plan.co_tiles * plan.co_tile >= ci > (plan.co_tiles - 1) * plan.co_tile
        assert 0 < plan.smem_bytes and plan.smem_bytes + C.DGRAD_STATIC_SMEM <= C.MAX_SMEM
        # a block stages g's halo once for all its parities where more than
        # one has taps (the 3^3 and 4^3 stride-2 convs), in room for two blocks
        assert plan.shared_halo == (s == (2, 2, 2) and k != (1, 1, 1))
        if plan.shared_halo:
            assert plan.smem_bytes + C.DGRAD_STATIC_SMEM <= C.MAX_SMEM // 2
    # every stride parity, empty ones included, most taps first
    assert len(plan.parities) == math.prod(s)
    taps = [math.prod(e) for _, e, _ in plan.parities]
    assert taps == sorted(taps, reverse=True)
    xp = C.padded_dims((n,) * 3, pads)
    for p, e, nq in plan.parities:
        assert all(ee == len(range(pp, kk, ss)) and nn == len(range(pp, x, ss))
                   for pp, ee, nn, kk, ss, x in zip(p, e, nq, k, s, xp))
    # the tables the kernel runs: the order as product indices, the fold
    # positions per axis
    order, fold = C.dgrad_tables(plan, s)
    assert [_parity(pid, s) for pid in order] == [p for p, _, _ in plan.parities]
    assert _fold_of(fold) == plan.fold
    # one launch, plus the fold for a reflect pad (every reflect conv of the
    # path pads 1: the planes 0, 2 and n - 1, n + 1 of the padded axis)
    if pad_mode == "reflect":
        assert plan.launches == 2
        assert plan.fold == ((0, 2, n - 1, n + 1),) * 3
        nf = 4
        assert plan.fold_bytes == BATCH * ci * 3 * nf * (n + 2) ** 2 * 4
    else:
        assert plan.launches == 1 and plan.fold_bytes == 0 and plan.fold == ((), (), ())


def _parity(pid, stride):
    """csrc/conv3d_dgrad.cu::parity_of: the parity of a product index."""
    _, sy, sz = stride
    return pid // (sy * sz), pid // sz % sy, pid % sz


def _fold_of(table):
    """The per-axis fold positions of a ``dgrad_tables`` fold table."""
    ns, pos, out = table[:3], list(table[3:]), []
    for n in ns:
        out.append(tuple(pos[:n]))
        pos = pos[n:]
    assert not pos
    return tuple(out)


def test_dgrad_static_smem_is_the_kernels():
    """The plan counts the kernel's static shared memory: the size its source
    asserts for the Geo struct, 17 ints, the fold tables of MAX_FOLD_PAD
    and an 8-byte slab size."""
    src = (Path(C.__file__).parent / "csrc" / "conv3d_dgrad.cu").read_text()
    assert int(re.search(r"static_assert\(sizeof\(Geo\) == (\d+),", src).group(1)) == \
        C.DGRAD_STATIC_SMEM
    ints = 17 + 3 * ((4 * C.MAX_FOLD_PAD + 4) + (2 * C.MAX_FOLD_PAD + 2))
    assert C.DGRAD_STATIC_SMEM == -(-ints * 4 // 8) * 8 + 8


def test_dgrad_plan_f32_and_refusals():
    args = (16, 32, (3, 3, 3), (2, 2, 2), (64,) * 3)
    kw = dict(in_dims=(128,) * 3, pads=((1, 1),) * 3, pad_mode="reflect")
    assert C.conv_plan("dgrad", *args, torch.float32, BATCH, **kw).route == "f32"
    # a 5^3 unit-stride sub-kernel has 125 taps: the CUDA-core body
    five = C.conv_plan("dgrad", 16, 16, (5, 5, 5), (1, 1, 1), (8,) * 3, BF16,
                       in_dims=(8,) * 3, pads=((2, 2),) * 3, pad_mode="zeros")
    assert five.route == "thin"
    with pytest.raises(ValueError):  # no input geometry
        C.conv_plan("dgrad", *args, BF16)
    with pytest.raises(ValueError):  # g does not match the padded input
        C.conv_plan("dgrad", 16, 32, (3, 3, 3), (2, 2, 2), (63,) * 3, BF16, **kw)
    with pytest.raises(ValueError):  # reflect pads wider than the fold takes
        C.conv_plan("dgrad", 4, 4, (3, 3, 3), (1, 1, 1), (22,) * 3, BF16, in_dims=(6,) * 3,
                    pads=((8, 8),) * 3, pad_mode="reflect")
    with pytest.raises(ValueError):  # more stride parities than the launch takes
        C.conv_plan("dgrad", 4, 4, (1, 1, 1), (5, 5, 5), (2,) * 3, BF16, in_dims=(6,) * 3,
                    pads=((0, 0),) * 3)


def _parity_blocks(buf, w_shape, stride, ci_tile):
    """Split ``dgrad_weights``' buffer into each parity's (Ci, Co, *e) sub-kernel."""
    co, ci, *k = w_shape
    chunks, tiles = -(-co // 16), -(-ci // ci_tile)
    out, at = {}, 0
    for p, e, _ in sorted(C.dgrad_launch_order(k, stride, k), key=lambda t: t[0]):
        taps = math.prod(e)
        if not taps:
            continue
        size = chunks * tiles * taps * ci_tile * 16
        blk = buf[at:at + size].reshape(chunks, tiles, taps, ci_tile, 16)
        at += size
        full = blk.permute(1, 3, 0, 4, 2).reshape(tiles * ci_tile, chunks * 16, taps)
        assert not full[ci:].any() and not full[:, co:].any()  # zero padding
        out[p] = full[:ci, :co].reshape(ci, co, *e)
    assert at == buf.numel()
    return out


@pytest.mark.parametrize("w_shape,stride,ci_tile", [
    ((32, 16, 3, 3, 3), (2, 2, 2), 16),    # enc1.block1
    ((64, 1, 4, 4, 4), (2, 2, 2), 8),      # disc.conv0
    ((16, 48, 3, 3, 3), (1, 1, 1), 48),    # dec0.block1
    ((32, 16, 1, 1, 1), (2, 2, 2), 16),    # enc1.shortcut: one parity with a tap
    ((18, 20, 3, 1, 2), (1, 2, 1), 24),    # mixed extents and strides
])
def test_dgrad_weights_is_each_parity_flipped(rng, w_shape, stride, ci_tile):
    w = torch.from_numpy(rng.normal(size=w_shape).astype(np.float32))
    buf = C.dgrad_weights(w, stride, ci_tile)
    assert buf.dtype == BF16 and buf.dim() == 1 and buf.numel() % 8 == 0
    blocks = _parity_blocks(buf, w_shape, stride, ci_tile)
    sx, sy, sz = stride
    for (px, py, pz), got in blocks.items():
        want = w[:, :, px::sx, py::sy, pz::sz].flip(2, 3, 4).transpose(0, 1)
        assert torch.equal(got, want.to(BF16))
    assert len(blocks) == sum(1 for t in C.dgrad_launch_order(w_shape[2:], stride, w_shape[2:])
                              if math.prod(t[1]))


def fold_sources(n, lo, hi, i):
    """The padded positions whose cotangent ``pad3d_grad`` (reflect) adds
    into position ``i`` of an axis of length ``n`` padded by ``(lo, hi)``, in
    its order: (the lo slab's, summed first, in position order), the
    interior position ``i + lo`` (added to them), (the hi slab's, added
    after, in position order)."""
    return (tuple(p for p in range(lo) if _reflect(p - lo, n) == i), i + lo,
            tuple(p for p in range(lo + n, lo + n + hi) if _reflect(p - lo, n) == i))


def _buf_offset(P, sp, xp, ns):
    """csrc/conv3d_dgrad.cu::buf_offset."""
    X, Y, Z = xp
    if sp[0] >= 0:
        return (sp[0] * Y + P[1]) * Z + P[2]
    base = ns[0] * Y * Z
    if sp[1] >= 0:
        return base + (P[0] * ns[1] + sp[1]) * Z + P[2]
    return base + X * ns[1] * Z + (P[0] * Y + P[1]) * ns[2] + sp[2]


def _fold_axis(t, axis, n, lo, hi):
    """One axis of the fold kernel's sum on a padded f32 tensor: each target
    i gets (its lo sources, summed) + interior, then + each hi source."""
    out = t.narrow(axis, lo, n).clone()
    for i in fold_targets(n, lo, hi):
        los, mid, his = fold_sources(n, lo, hi, i)
        pick = lambda p: t.narrow(axis, p, 1)  # noqa: E731
        acc = pick(mid)
        if los:
            lsum = pick(los[0])
            for p in los[1:]:
                lsum = lsum + pick(p)
            acc = lsum + acc
        for p in his:
            acc = acc + pick(p)
        out.narrow(axis, i, 1).copy_(acc)
    return out


def emulate_dgrad(g, w, x_shape, stride, pads, pad_mode, ci_tile=16):
    """The kernel's index contract in plain f32 torch, from what the kernel
    is given (the plan's ``dgrad_tables`` and ``dgrad_weights``): per parity
    in the table's order, its sub-kernel extents and positions as the kernel
    derives them, the sub-conv of g with the arranged weights, then
    ``store_and_fold``."""
    b, ci = x_shape[:2]
    co, k = w.shape[0], tuple(w.shape[2:])
    dims = tuple(x_shape[2:])
    plan = C.conv_plan("dgrad", ci, co, k, stride, g.shape[2:], torch.float32, b,
                       in_dims=dims, pads=pads, pad_mode=pad_mode)
    xp = C.padded_dims(dims, pads)
    blocks = _parity_blocks(C.dgrad_weights(w, stride, ci_tile, torch.float32), w.shape, stride,
                            ci_tile)
    order, _ = C.dgrad_tables(plan, stride)
    pieces = []
    for pid in order:
        p = _parity(pid, stride)
        e = [len(range(pp, kk, ss)) for pp, kk, ss in zip(p, k, stride)]
        nq = [len(range(pp, x, ss)) for pp, x, ss in zip(p, xp, stride)]
        if math.prod(e):
            pad = [(ee - 1, nn - oo) for ee, nn, oo in zip(e, nq, g.shape[2:])]
            gp = F.pad(g, [v for lo_hi in reversed(pad) for v in lo_hi])
            piece = F.conv3d(gp, blocks[p])  # (b, ci, *nq): flipped taps over the halo
        else:
            piece = torch.zeros(b, ci, *nq)  # a parity with no taps writes zeros
        assert tuple(piece.shape[2:]) == tuple(nq)
        pieces.append((p, piece))
    return store_and_fold(pieces, plan, stride, x_shape, pads, pad_mode)


def store_and_fold(pieces, plan, stride, x_shape, pads, pad_mode):
    """The kernel's epilogue and fold launch in plain f32 torch: each
    parity's ``piece`` (its values at the padded positions s*q + p, in the
    order given) stored at its position (dx directly, nothing for a zero pad,
    the fold buffer for a fold position, in the layout of the plan's fold
    table), then the fold, x then y then z, into the targets' voxels."""
    b, ci = x_shape[:2]
    dims = tuple(x_shape[2:])
    xp = C.padded_dims(dims, pads)
    _, table = C.dgrad_tables(plan, stride)
    fold = _fold_of(table) if pad_mode == "reflect" else ((), (), ())
    los = [lo for lo, _ in pads]
    ns = [len(f) for f in fold]
    slab = plan.fold_bytes // 4 // (b * ci) if plan.fold_bytes else 0
    buf = torch.full((b, ci, slab), float("nan"))
    dx = torch.full((b, ci, *dims), float("nan"))
    direct = torch.zeros(dims, dtype=torch.bool)
    seen = set()
    for p, piece in pieces:
        for q in np.ndindex(*piece.shape[2:]):
            P = [s * qq + pp for s, qq, pp in zip(stride, q, p)]
            assert tuple(P) not in seen  # every padded position once
            seen.add(tuple(P))
            i = [pp - lo for pp, lo in zip(P, los)]
            sp = [fold[d].index(P[d]) if P[d] in fold[d] else -1 for d in range(3)]
            if max(sp) >= 0:
                off = _buf_offset(P, sp, xp, ns)
                assert 0 <= off < slab
                assert torch.isnan(buf[:, :, off]).all()  # no two positions share a slot
                buf[:, :, off] = piece[(slice(None), slice(None), *q)]
            elif all(0 <= ii < n for ii, n in zip(i, dims)):
                dx[(slice(None), slice(None), *i)] = piece[(slice(None), slice(None), *q)]
                direct[tuple(i)] = True
    assert len(seen) == math.prod(xp)
    if not plan.fold_bytes:
        assert bool(direct.all())
        return dx
    # the fold launch: read the buffer back into a padded tensor (fold
    # positions only), fold x, then y, then z, and write the targets' voxels
    dxp = torch.full((b, ci, *xp), float("nan"))
    for P in np.ndindex(*xp):
        sp = [fold[d].index(P[d]) if P[d] in fold[d] else -1 for d in range(3)]
        if max(sp) >= 0:
            dxp[(slice(None), slice(None), *P)] = buf[:, :, _buf_offset(P, sp, xp, ns)]
    t = dxp
    for axis, n, (lo, hi) in zip((2, 3, 4), dims, pads):
        t = _fold_axis(t, axis, n, lo, hi)
    assert not (direct & ~torch.isnan(t[0, 0])).any()  # the two launches' voxels are disjoint
    assert bool((direct | ~torch.isnan(t[0, 0])).all())  # and cover dx
    return torch.where(direct, dx, t)


EMU_CASES = [  # (k, stride, padding, pad_mode, ci, co, dims)
    ((3, 3, 3), 1, ((1, 1),) * 3, "reflect", 5, 7, (6, 7, 5)),
    ((3, 3, 3), 2, ((1, 1),) * 3, "reflect", 16, 32, (8, 7, 9)),
    ((4, 4, 4), 2, ((1, 1),) * 3, "reflect", 1, 20, (8, 10, 6)),
    ((1, 1, 1), 2, "same", "zeros", 16, 32, (7, 6, 5)),    # empty parities: zeros
    ((3, 3, 3), 2, "same", "zeros", 6, 5, (7, 5, 8)),
    ((4, 4, 4), 1, "same", "zeros", 3, 4, (5, 6, 7)),      # TF SAME pads (1, 2)
    ((3, 1, 2), (1, 2, 1), "same", "zeros", 3, 18, (5, 6, 7)),
    ((3, 3, 3), 1, ((2, 2),) * 3, "reflect", 4, 4, (3, 2, 4)),  # reflect wider than the axis
    ((3, 3, 3), 2, ((3, 3), (2, 2), (1, 1)), "reflect", 3, 5, (5, 3, 7)),
    ((1, 1, 1), 1, "same", "zeros", 16, 1, (4, 5, 6)),
]


@pytest.mark.parametrize("k,stride,padding,pad_mode,ci,co,dims", EMU_CASES)
def test_kernel_index_contract_reproduces_plain(rng, k, stride, padding, pad_mode, ci, co, dims):
    s = C.norm_stride(stride)
    pads = C.norm_padding(padding, k, s, dims)
    out = [(n + lo + hi - kk) // ss + 1 for n, (lo, hi), kk, ss in zip(dims, pads, k, s)]
    g = torch.from_numpy(rng.normal(size=(2, co, *out)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(co, ci, *k)).astype(np.float32))
    x_shape = (2, ci, *dims)
    want = C.conv3d_dgrad_plain(g, w, x_shape, s, pads, pad_mode)
    for tile in (8, 16):
        got = emulate_dgrad(g, w, x_shape, s, pads, pad_mode, tile)
        assert got.shape == want.shape and not torch.isnan(got).any()
        assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    if s == (2, 2, 2) and k == (1, 1, 1):  # the odd positions get no taps: exact zeros
        assert not got[:, :, 1::2].any() and not want[:, :, 1::2].any()


def test_fold_positions_and_sources():
    # width 1: the pad planes fold onto planes 1 and n - 2, two padded positions away
    assert fold_positions(128, 1, 1) == (0, 2, 127, 129)
    assert fold_sources(128, 1, 1, 1) == ((0,), 2, ())
    assert fold_sources(128, 1, 1, 126) == ((), 127, (129,))
    assert fold_sources(128, 1, 1, 5) == ((), 6, ())
    # a 3-long axis padded by 1: both pads fold onto the middle
    assert fold_sources(3, 1, 1, 1) == ((0,), 2, (4,))
    # a pad wider than the axis folds several planes onto one, in order
    assert fold_sources(2, 2, 2, 0) == ((0,), 2, (4,))
    assert fold_sources(2, 2, 2, 1) == ((1,), 3, (5,))


# (C, edge) of every InstanceNorm of one gen_IS (f=16) and one disc_I call at
# 128^3, each at batch 3
PATH_NORMS = sorted({(16, 128), (32, 64), (64, 32), (128, 16), (256, 8), (384, 16), (192, 32),
                     (96, 64), (48, 128), (64, 64), (512, 16)})


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("c,edge", PATH_NORMS)
def test_bwd_plan_at_path_norms(c, edge, dtype):
    bc, n = BATCH * c, edge ** 3
    plan = I.bwd_plan(n, dtype)
    esize = 2 if dtype == BF16 else 4
    assert plan.vec == 16 // esize
    assert (plan.route == "small") == (n <= I.BWD_SMALL_VECS * I.BWD_THREADS * plan.vec)
    if plan.route == "small":
        # one launch, the plane in registers: vpt vectors per thread hold it
        assert plan.launches == 1 and plan.vpt in (1, 2, 4)
        assert plan.vpt * I.BWD_THREADS * plan.vec >= n
        assert plan.vpt == 1 or (plan.vpt // 2) * I.BWD_THREADS * plan.vec < n
    else:  # a reduce launch and a dx launch over every plane
        assert plan.route == "split" and plan.launches == 2
        assert 1 <= plan.nsplit <= I.BWD_MAX_SPLIT
        assert bc * plan.nsplit < 2 ** 31  # the kernels' 1-D grids
    if dtype == BF16:  # the 16^3 and 8^3 levels take one block per plane
        assert (plan.route == "small") == (edge <= 16)


def test_bwd_plan_unaligned_and_split():
    # a plane whose size is not a multiple of 16 bytes: one element at a time
    assert I.bwd_plan(5 * 7 * 9, BF16, aligned=False) == I.BwdPlan("small", 1, vpt=2)
    # a 128^3 plane: two passes of 128 blocks of 16384 elements each
    assert I.bwd_plan(128 ** 3, BF16) == I.BwdPlan("split", 8, nsplit=128, launches=2)
    # past the small threshold by one vector, and at most 256 blocks a plane
    assert I.bwd_plan(8200, BF16) == I.BwdPlan("split", 8, nsplit=1, launches=2)
    assert I.bwd_plan(1 << 30, torch.float32).nsplit == I.BWD_MAX_SPLIT
