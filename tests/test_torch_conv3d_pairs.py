"""The algebra of the conv kernels' route for one input channel (K1's route
3, ``csrc/conv3d_taps.cuh::pair_body``, and K3's, ``csrc/conv3d_wgrad.cu``)
and of the input gradient above 64 taps on K1's bodies (K2's routes 2 and
3, ``csrc/conv3d_dgrad.cu``), emulated in torch on the CPU, against the
plain versions and JAX's XLA reference and its VJP.

Route 3 is emulated brick by brick as the kernel indexes it: columns of
``FOLD_ROWS`` z outputs, ``FOLD_COLUMNS`` of them a block (route 2's); the halo read
through the padding's index map and staged kz times, copy dz shifted by dz
along z; for each dz the GEMM with K = the (dx, dy) pairs, padded to
``k_pairs`` with zero weights (whose A rows read pair 0's), N = a Co tile
of the package's weight layout (``conv3d.pair_weights``), M = the 16 z
rows of a column; the Co tiles' padding channels dropped in the epilogue.

K3's route 3 is that GEMM transposed, emulated as the kernel indexes it:
for each Co tile, block s walks the (sample, brick) pairs s, s + split, ...
on the same bricks and halo copies; g staged as [column][co][16 z], zero
outside the output; warp dz's GEMM with M = the ``k_pairs`` pairs (the
padding pairs read pair 0's halo rows and are dropped), N = the Co tile and
K = a column's 16 z positions; each block's partial tile written to its
workspace slice (every element of its Co tile), the slices summed in slice
order.

K2 is emulated as its launch runs it at unit stride: the forward of g,
zero-padded by k - 1, with ``conv3d.dgrad_forward_weights`` (the flipped
kernel, Ci and Co swapped) on the body its plan names (route 3 above,
route 2 as ``test_torch_conv3d_fold.fold_forward``), over the padded
positions of x; then the epilogue's stores and the reflect fold through the
f32 buffer in ``pad3d_grad``'s order, from the plan's own tables
(``test_torch_dgrad_plan.store_and_fold``).

Inputs are seeded numpy, float32, scaled so that outputs and input
gradients have standard deviation 0.5, and weight gradients are of order 1
(``test_torch_conv3d_fold``'s inputs); tolerance atol 1e-5 (float32 sums of
up to 343 x 32 products, or of the voxels, in another order; a wrong index
or layout moves the values by their own order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_conv3d_fold import _halo, _jax_conv, fold_forward
from test_torch_conv3d_fold import _inputs as _wgrad_inputs
from test_torch_dgrad_plan import store_and_fold

from vangan_torch.ops import conv3d as C

ATOL = 1e-5
BF16 = torch.bfloat16


def _bricks(out_dims, brick):
    """The output origin of every brick, in the kernels' grid order (z fastest)."""
    return [(i * brick[0], j * brick[1], l * brick[2])
            for i in range(-(-out_dims[0] // brick[0])) for j in range(-(-out_dims[1] // brick[1]))
            for l in range(-(-out_dims[2] // brick[2]))]


def pair_forward(x, w, bias, pads, pad_mode):
    """K1's route 3 in torch: y (B, Co, *out) for x (B, 1, X, Y, Z), unit
    stride, on the plan's brick, Co tiles and k_pairs."""
    b = x.shape[0]
    co, ci, kx, ky, kz = w.shape
    out_dims = [n + lo + hi - k + 1 for n, (lo, hi), k in zip(x.shape[2:], pads, w.shape[2:])]
    plan = C.conv_plan("fwd", ci, co, (kx, ky, kz), (1, 1, 1), out_dims, BF16, b)
    assert plan.body == 3 and plan.brick == (*C.FOLD_COLUMNS, C.FOLD_ROWS), plan
    bx, by = C.FOLD_COLUMNS
    rows, tile, steps = C.FOLD_ROWS, plan.co_tile, plan.k_pairs // 16
    wt = C.pair_weights(w, tile, torch.float32)  # [Co tile][dz][k-step][co][16 pairs]
    assert wt.shape == (plan.co_tiles, kz, steps, tile, 16)
    # the pair of each of K's columns; a padding pair reads pair 0's halo rows
    pair = [divmod(k, ky) if k < kx * ky else (0, 0) for k in range(plan.k_pairs)]
    y = torch.full((b, co, *out_dims), float("nan"))
    for s in range(b):
        for ox0, oy0, oz0 in _bricks(out_dims, plan.brick):
            origin = (ox0 - pads[0][0], oy0 - pads[1][0], oz0 - pads[2][0])
            h = _halo(x[s], 1, origin, (bx + kx - 1, by + ky - 1, rows + kz - 1),
                      pad_mode == "reflect")[0]
            copies = [h[:, :, dz:dz + rows] for dz in range(kz)]  # copy dz: z + dz
            for t in range(plan.co_tiles):
                acc = torch.zeros(bx, by, rows, tile)
                for dz in range(kz):
                    # A[k, column x, column y, z] and B[k, n] of this dz
                    a = torch.stack([copies[dz][dx:dx + bx, dy:dy + by] for dx, dy in pair])
                    bmat = wt[t, dz].permute(0, 2, 1).reshape(plan.k_pairs, tile)
                    acc += torch.einsum("kxyz,kn->xyzn", a, bmat)
                ex, ey, ez = (min(bb, n - o) for bb, n, o in zip(plan.brick, out_dims,
                                                                  (ox0, oy0, oz0)))
                cn = min(tile, co - t * tile)
                yb = acc[:ex, :ey, :ez, :cn].permute(3, 0, 1, 2)
                if bias is not None:
                    yb = bias[t * tile:t * tile + cn, None, None, None] + yb
                y[s, t * tile:t * tile + cn, ox0:ox0 + ex, oy0:oy0 + ey, oz0:oz0 + ez] = yb
    return y


def pair_wgrad(x, g, w_shape, pads, pad_mode, split=None):
    """K3's route 3 in torch: dW (Co, 1, kx, ky, kz) for x (B, 1, X, Y, Z)
    and g (B, Co, *out), unit stride, on the plan's brick, Co tiles,
    k_pairs and ``split`` (default: the plan's)."""
    co, ci, kx, ky, kz = w_shape
    b = x.shape[0]
    out_dims = tuple(g.shape[2:])
    plan = C.conv_plan("wgrad", ci, co, (kx, ky, kz), (1, 1, 1), out_dims, BF16, b)
    assert plan.body == 3 and plan.brick == (*C.FOLD_COLUMNS, C.FOLD_ROWS), plan
    assert plan.workspace_slices == plan.split
    split = plan.split if split is None else split
    bx, by = C.FOLD_COLUMNS
    rows, tile, taps = C.FOLD_ROWS, plan.co_tile, kx * ky * kz
    # the pair of each of M's rows; a padding pair reads pair 0's halo rows
    pair = [divmod(k, ky) if k < kx * ky else (0, 0) for k in range(plan.k_pairs)]
    work = [(s, o) for s in range(b) for o in _bricks(out_dims, plan.brick)]
    ws = torch.full((split, co, taps), float("nan"))
    for blk in range(split):
        for t in range(plan.co_tiles):
            cn = min(tile, co - t * tile)
            acc = torch.zeros(kz, plan.k_pairs, tile)  # warp dz's M x N accumulator
            for s, (ox0, oy0, oz0) in work[blk::split]:
                origin = (ox0 - pads[0][0], oy0 - pads[1][0], oz0 - pads[2][0])
                h = _halo(x[s], 1, origin, (bx + kx - 1, by + ky - 1, rows + kz - 1),
                          pad_mode == "reflect")[0]
                # g_s[column x, column y, co, z]: the Co tile's g, 0 outside the output
                gs = torch.zeros(bx, by, tile, rows)
                ex, ey, ez = (min(bb, n - o) for bb, n, o in zip(plan.brick, out_dims,
                                                                  (ox0, oy0, oz0)))
                gs[:ex, :ey, :cn, :ez] = g[s, t * tile:t * tile + cn, ox0:ox0 + ex,
                                           oy0:oy0 + ey, oz0:oz0 + ez].permute(1, 2, 0, 3)
                for dz in range(kz):
                    copy = h[:, :, dz:dz + rows]  # copy dz: z + dz
                    # A[k, column x, column y, z] of this dz, B[column, z, n]
                    a = torch.stack([copy[dx:dx + bx, dy:dy + by] for dx, dy in pair])
                    acc[dz] += torch.einsum("kxyz,xynz->kn", a, gs)
            # epilogue: every (co, pair, dz) of the tile, padding pairs and channels dropped
            ws[blk, t * tile:t * tile + cn] = \
                acc[:, :kx * ky, :cn].permute(2, 1, 0).reshape(cn, taps)
    assert not torch.isnan(ws).any()  # every element of every slice is written
    dw = ws[0].clone()
    for blk in range(1, split):
        dw += ws[blk]
    return dw.reshape(w_shape)


def dgrad_on_forward_bodies(g, w, x_shape, pads, pad_mode):
    """K2's routes 2 and 3 in torch: dx (x_shape) from g at unit stride, on
    the body the bf16 plan names, through the epilogue and fold contract."""
    b, ci = x_shape[:2]
    co, k = w.shape[0], tuple(w.shape[2:])
    dims = tuple(x_shape[2:])
    plan = C.conv_plan("dgrad", ci, co, k, (1, 1, 1), g.shape[2:], BF16, b, in_dims=dims,
                       pads=pads, pad_mode=pad_mode)
    assert plan.body in (2, 3) and plan.launches == 1 + (pad_mode == "reflect"), plan
    body = pair_forward if plan.body == 3 else fold_forward
    dxp = body(g, C.dgrad_forward_weights(w), None, tuple((kk - 1, kk - 1) for kk in k), "zeros")
    assert tuple(dxp.shape) == (b, ci, *C.padded_dims(dims, pads))
    assert not torch.isnan(dxp).any()
    return store_and_fold([((0, 0, 0), dxp)], plan, (1, 1, 1), x_shape, pads, pad_mode)


def _inputs(seed, batch, ci, co, k, dims):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, ci, *dims)).astype(np.float32)
    w = (rng.normal(size=(co, ci, *k)) * 0.5 / np.sqrt(ci * np.prod(k))).astype(np.float32)
    bias = (rng.normal(size=(co,)) * 0.1).astype(np.float32)
    pads = tuple((kk // 2, kk - 1 - kk // 2) for kk in k)
    # y and dx of standard deviation 0.5 (dx sums co x taps products of w)
    g = (rng.normal(size=(batch, co, *dims)) * np.sqrt(ci / co)).astype(np.float32)
    return x, w, bias, g, pads


FWD_CASES = [
    # (co, k, dims, batch, pad_mode): the ResNet's stem (1 -> 32, one Co
    # tile, 49 pairs in four k-steps) with ragged bricks on every axis (Z = 21
    # against columns of 16), 5^3 (25 pairs: two k-steps) at Co = 8 (one n
    # tile) and Co = 40 (two tiles of 24, padding channels), 6^3 (TF SAME
    # pads (3, 2), 36 pairs: three k-steps) at Co = 20
    (32, (7, 7, 7), (9, 10, 21), 2, "reflect"),
    (32, (7, 7, 7), (6, 9, 17), 1, "zeros"),
    (8, (5, 5, 5), (9, 10, 11), 2, "zeros"),
    (40, (5, 5, 5), (7, 9, 18), 1, "reflect"),
    (20, (6, 6, 6), (8, 9, 13), 1, "reflect"),
]


@pytest.mark.parametrize("co,k,dims,batch,pad_mode", FWD_CASES)
def test_pair_forward_matches_plain_and_jax(co, k, dims, batch, pad_mode):
    x, w, bias, _, pads = _inputs(0, batch, 1, co, k, dims)
    got = pair_forward(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias), pads,
                       pad_mode)
    assert not torch.isnan(got).any()
    plain = C.conv3d_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
                           (1, 1, 1), pads, pad_mode)
    run, _, _ = _jax_conv(x, w, bias, pads, pad_mode)
    want = np.asarray(run()).transpose(0, 2, 1, 3, 4)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


WGRAD_CASES = [
    # (co, k, dims, batch, pad_mode, split): FWD_CASES, each block one brick
    # (the plan's split at these sizes) or several (split 3 or 2)
    (32, (7, 7, 7), (9, 10, 21), 2, "reflect", None),
    (32, (7, 7, 7), (6, 9, 17), 1, "zeros", 3),
    (8, (5, 5, 5), (9, 10, 11), 2, "zeros", None),
    (40, (5, 5, 5), (7, 9, 18), 1, "reflect", 2),
    (20, (6, 6, 6), (8, 9, 13), 1, "reflect", 3),
]


@pytest.mark.parametrize("co,k,dims,batch,pad_mode,split", WGRAD_CASES)
def test_pair_wgrad_matches_plain_and_jax(co, k, dims, batch, pad_mode, split):
    x, w, _, g, pads = _wgrad_inputs(4, batch, 1, co, k, dims, pad_mode)
    got = pair_wgrad(torch.from_numpy(x), torch.from_numpy(g), w.shape, pads, pad_mode, split)
    plain = C.conv3d_wgrad_plain(torch.from_numpy(x), torch.from_numpy(g), w.shape, (1, 1, 1),
                                 pads, pad_mode)
    run, jx, jw = _jax_conv(x, w, None, pads, pad_mode)
    _, vjp = jax.vjp(lambda ww: run(jx, ww), jw)
    want = np.asarray(vjp(jnp.asarray(g.transpose(0, 2, 1, 3, 4)))[0]).transpose(4, 3, 0, 1, 2)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


DGRAD_CASES = [
    # (ci, co, k, dims, batch, pad_mode, body): the ResNet's head (dx 32 <- g
    # 1: route 3) and stem (dx 1 <- g 32: route 2, two 16-channel chunks of
    # g), each with a reflect fold and with a zero pad, Z not a multiple of 16
    # or 10; a reflect pad of 3 on an axis of 5 (folds that are not simple);
    # 5^3 on both routes (g of 16 channels: one chunk)
    (32, 1, (7, 7, 7), (9, 10, 11), 2, "reflect", 3),
    (32, 1, (7, 7, 7), (8, 9, 17), 1, "zeros", 3),
    (32, 1, (7, 7, 7), (5, 9, 6), 1, "reflect", 3),
    (1, 32, (7, 7, 7), (9, 10, 11), 2, "reflect", 2),
    (1, 32, (7, 7, 7), (10, 9, 19), 1, "zeros", 2),
    (16, 1, (5, 5, 5), (7, 9, 13), 2, "reflect", 3),
    (1, 16, (5, 5, 5), (9, 7, 12), 1, "reflect", 2),
]


@pytest.mark.parametrize("ci,co,k,dims,batch,pad_mode,body", DGRAD_CASES)
def test_dgrad_on_forward_bodies_matches_plain_and_jax(ci, co, k, dims, batch, pad_mode, body):
    x, w, _, g, pads = _inputs(1, batch, ci, co, k, dims)
    plan = C.conv_plan("dgrad", ci, co, k, (1, 1, 1), dims, BF16, batch, in_dims=dims,
                       pads=pads, pad_mode=pad_mode)
    assert plan.body == body
    got = dgrad_on_forward_bodies(torch.from_numpy(g), torch.from_numpy(w), x.shape, pads,
                                  pad_mode)
    assert not torch.isnan(got).any()
    plain = C.conv3d_dgrad_plain(torch.from_numpy(g), torch.from_numpy(w), x.shape, (1, 1, 1),
                                 pads, pad_mode)
    run, jx, jw = _jax_conv(x, w, None, pads, pad_mode)
    _, vjp = jax.vjp(lambda xx: run(xx, jw), jx)
    want = np.asarray(vjp(jnp.asarray(g.transpose(0, 2, 1, 3, 4)))[0]).transpose(0, 2, 1, 3, 4)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("co,k,co_tile", [(32, (7, 7, 7), 32), (20, (6, 5, 4), 24),
                                          (40, (5, 5, 5), 24)])
def test_pair_weights_layout(co, k, co_tile):
    """[Co tile][dz][k-step][co][16] with pair dx * ky + dy = 16 * k-step +
    column, zero-padded in the pairs and Co: the B tile of each (dz, k-step)
    MMA, which route 3 stages once per block with 16-byte copies."""
    w = torch.from_numpy(np.random.default_rng(3).normal(size=(co, 1, *k)).astype(np.float32))
    wt = C.pair_weights(w, co_tile)
    kx, ky, kz = k
    steps, tiles = -(-kx * ky // 16), -(-co // co_tile)
    assert wt.shape == (tiles, kz, steps, co_tile, 16) and wt.dtype == BF16
    assert wt.is_contiguous()
    full = wt.permute(0, 3, 2, 4, 1).reshape(tiles * co_tile, steps * 16, kz)
    want = torch.zeros(tiles * co_tile, steps * 16, kz, dtype=BF16)
    want[:co, :kx * ky] = w.to(BF16).reshape(co, kx * ky, kz)
    assert torch.equal(full, want)
    with pytest.raises(ValueError):  # the body takes one input channel
        C.pair_weights(torch.zeros(8, 2, 7, 7, 7), 8)


def test_dgrad_forward_weights_is_the_flipped_swapped_kernel():
    w = torch.arange(2 * 3 * 4 * 5 * 6, dtype=torch.float32).reshape(2, 3, 4, 5, 6)
    wf = C.dgrad_forward_weights(w)
    assert wf.shape == (3, 2, 4, 5, 6)
    assert float(wf[1, 0, 0, 0, 0]) == float(w[0, 1, 3, 4, 5])
    assert float(wf[2, 1, 3, 1, 2]) == float(w[1, 2, 0, 3, 3])
