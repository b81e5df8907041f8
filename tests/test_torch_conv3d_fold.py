"""The algebra of the conv kernels' route in tap chunks (K1 and K3 above 64
taps, ``csrc/conv3d_fwd.cu`` and ``conv3d_wgrad.cu`` route 2), emulated in
torch on the CPU, against the plain versions and JAX's XLA reference.

The emulation follows the kernels' index contract, brick by brick: the
halo of ``FOLD_COLUMNS`` columns of ``FOLD_ROWS`` z positions read through
the padding's index map, the kz taps on the GEMM's N (column co * kz + dz),
for the forward the product P over K = Ci x kx x ky and then the shifted sum
y[o, co] = sum over dz of P[o + dz e_z, co * kz + dz], for the weight
gradient g staged per column at z - 7 .. z + 16 and read shifted by dz, each
split block's partial tile written to its own workspace slice (every element
of it) and the slices summed in order. It lives here, not in the package:
the kernels are its only counterpart. Where the plan takes the shape (Co *
kz <= 8), the emulation runs on the package's weight layout
(``conv3d.fold_weights``) and the plan's split; Co = 3 at 7^3 (21 columns,
three n tiles) holds the algebra where the plan keeps the CUDA-core body.

Inputs are seeded numpy, float32, scaled so that outputs (standard
deviation 0.5) and weight gradients are of order 1; tolerance atol 1e-5
(float32 sums of up to Ci x 343 products, or of the voxels, in another
order; a wrong index or layout moves them by the order of the values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vangan_tpu.ops.pallas.conv3d import conv3d_cxyz_reference
from vangan_torch.ops import conv3d as C

ATOL = 1e-5
BF16 = torch.bfloat16


def _map_index(i, n, reflect):
    """The kernels' padding index map (conv3d_common.cuh ``map_index``)."""
    if 0 <= i < n:
        return i
    if not reflect:
        return -1
    if n == 1:
        return 0
    period = 2 * (n - 1)
    i %= period
    return i if i < n else period - i


def _halo(xb, chunks, origin, extent, reflect):
    """The staged halo of one sample: (chunks * 16, *extent) channels,
    zero-padded; position h of an axis reads input position origin + h."""
    ci = xb.shape[0]
    out = torch.zeros(chunks * C.CI_CHUNK, *extent, dtype=xb.dtype)
    idx = [[_map_index(o + h, n, reflect) for h in range(e)]
           for o, e, n in zip(origin, extent, xb.shape[1:])]
    keep = [torch.tensor([i >= 0 for i in ax]) for ax in idx]
    src = [torch.tensor([max(i, 0) for i in ax]) for ax in idx]
    vals = xb[:, src[0]][:, :, src[1]][:, :, :, src[2]]
    mask = keep[0][:, None, None] & keep[1][None, :, None] & keep[2][None, None, :]
    out[:ci] = vals * mask
    return out


def _n_cols(co, kz):
    """N of the fold: the Co * kz columns, padded to n tiles of FOLD_N."""
    return -(-co * kz // C.FOLD_N) * C.FOLD_N


def _weight_matrix(w):
    """(Ci chunks * 16, kx, ky, N): B of each (dx, dy) pair, column co * kz +
    dz; the package's layout where one n tile holds the columns."""
    co, ci, kx, ky, kz = w.shape
    chunks = -(-ci // C.CI_CHUNK)
    if co * kz <= C.FOLD_N:
        wt = C.fold_weights(w, torch.float32)
        assert wt.shape == (chunks, kx, ky, C.FOLD_N, C.CI_CHUNK)
        return wt.permute(0, 4, 1, 2, 3).reshape(chunks * C.CI_CHUNK, kx, ky, C.FOLD_N)
    wf = w.permute(1, 2, 3, 0, 4).reshape(ci, kx, ky, co * kz)
    return F.pad(wf, (0, _n_cols(co, kz) - co * kz, 0, 0, 0, 0, 0, chunks * C.CI_CHUNK - ci))


def _bricks(out_dims, kz):
    """The output origin of every brick, in the kernels' grid order (z fastest)."""
    bx, by, bz = (*C.FOLD_COLUMNS, C.FOLD_ROWS - kz + 1)
    xo, yo, zo = out_dims
    return [(i * bx, j * by, l * bz) for i in range(-(-xo // bx)) for j in range(-(-yo // by))
            for l in range(-(-zo // bz))]


def fold_forward(x, w, bias, pads, pad_mode):
    """K1's route 2 in torch: y (B, Co, *out) for x (B, Ci, X, Y, Z), unit stride."""
    b, ci = x.shape[:2]
    co, _, kx, ky, kz = w.shape
    out_dims = [n + lo + hi - k + 1 for n, (lo, hi), k in zip(x.shape[2:], pads, w.shape[2:])]
    bx, by = C.FOLD_COLUMNS
    bz = C.FOLD_ROWS - kz + 1
    wm = _weight_matrix(w)
    chunks = wm.shape[0] // C.CI_CHUNK
    y = torch.full((b, co, *out_dims), float("nan"))
    for s in range(b):
        for ox0, oy0, oz0 in _bricks(out_dims, kz):
            origin = (ox0 - pads[0][0], oy0 - pads[1][0], oz0 - pads[2][0])
            h = _halo(x[s], chunks, origin, (bx + kx - 1, by + ky - 1, C.FOLD_ROWS),
                      pad_mode == "reflect")
            # P[column x, column y, z, n] over K = Ci x kx x ky
            p = sum(torch.einsum("cxyz,cn->xyzn", h[:, dx:dx + bx, dy:dy + by], wm[:, dx, dy])
                    for dx in range(kx) for dy in range(ky))
            for c in range(co):
                yb = sum(p[:, :, dz:dz + bz, c * kz + dz] for dz in range(kz))
                if bias is not None:
                    yb = yb + bias[c]
                ex, ey, ez = (min(bb, n - o) for bb, n, o in zip((bx, by, bz), out_dims,
                                                                  (ox0, oy0, oz0)))
                y[s, c, ox0:ox0 + ex, oy0:oy0 + ey, oz0:oz0 + ez] = yb[:ex, :ey, :ez]
    return y


def fold_wgrad(x, g, w_shape, pads, pad_mode, split):
    """K3's route 2 in torch: dW (Co, Ci, kx, ky, kz) from ``split`` blocks a
    chunk, block s walking bricks s, s + split, ... of the (sample, brick)
    pairs, each writing its partial tile to workspace slice s; the slices
    summed in slice order."""
    co, ci, kx, ky, kz = w_shape
    b = x.shape[0]
    out_dims = g.shape[2:]
    bx, by = C.FOLD_COLUMNS
    bz = C.FOLD_ROWS - kz + 1
    chunks = -(-ci // C.CI_CHUNK)
    n_cols = _n_cols(co, kz)
    pairs = [(s, o) for s in range(b) for o in _bricks(out_dims, kz)]
    ws = torch.full((split, co, ci, kx, ky, kz), float("nan"))
    gz_off = C.KMAX - 1
    for blk in range(split):
        for c in range(chunks):
            acc = torch.zeros(C.CI_CHUNK, kx, ky, n_cols)
            for s, (ox0, oy0, oz0) in pairs[blk::split]:
                origin = (ox0 - pads[0][0], oy0 - pads[1][0], oz0 - pads[2][0])
                h = _halo(x[s], chunks, origin, (bx + kx - 1, by + ky - 1, C.FOLD_ROWS),
                          pad_mode == "reflect")[c * C.CI_CHUNK:(c + 1) * C.CI_CHUNK]
                # g_s[co, column x, column y, j]: g at output z oz0 + j - 7
                gs = torch.zeros(co, bx, by, C.FOLD_G_ROW)
                ex, ey, ez = (min(bb, n - o) for bb, n, o in zip((bx, by, bz), out_dims,
                                                                  (ox0, oy0, oz0)))
                gs[:, :ex, :ey, gz_off:gz_off + ez] = \
                    g[s, :, ox0:ox0 + ex, oy0:oy0 + ey, oz0:oz0 + ez]
                # B[column, z, n = (co, dz)] = g_s[co, column, z - dz + 7]
                bmat = torch.zeros(bx, by, C.FOLD_ROWS, n_cols)
                for n in range(co * kz):
                    cc, dz = divmod(n, kz)
                    bmat[..., n] = gs[cc, :, :, gz_off - dz:gz_off - dz + C.FOLD_ROWS]
                for dx in range(kx):
                    for dy in range(ky):
                        acc[:, dx, dy] += torch.einsum("cxyz,xyzn->cn",
                                                       h[:, dx:dx + bx, dy:dy + by], bmat)
            cn = min(C.CI_CHUNK, ci - c * C.CI_CHUNK)
            for n in range(co * kz):
                cc, dz = divmod(n, kz)
                ws[blk, cc, c * C.CI_CHUNK:c * C.CI_CHUNK + cn, :, :, dz] = acc[:cn, :, :, n]
    assert not torch.isnan(ws).any()  # every element of every slice is written
    dw = ws[0].clone()
    for blk in range(1, split):
        dw += ws[blk]
    return dw


def _inputs(seed, batch, ci, co, k, dims, pad_mode):
    rng = np.random.default_rng(seed)
    fan_in = ci * int(np.prod(k))
    x = rng.normal(size=(batch, ci, *dims)).astype(np.float32)
    w = (rng.normal(size=(co, ci, *k)) * 0.5 / np.sqrt(fan_in)).astype(np.float32)
    bias = (rng.normal(size=(co,)) * 0.1).astype(np.float32)
    pads = tuple((kk // 2, kk - 1 - kk // 2) for kk in k)
    out = [n + lo + hi - kk + 1 for n, (lo, hi), kk in zip(dims, pads, k)]
    g = (rng.normal(size=(batch, co, *out)) / np.sqrt(batch * np.prod(out))).astype(np.float32)
    return x, w, bias, g, pads


def _jax_conv(x, w, bias, pads, pad_mode):
    """JAX's XLA reference on the (B, X, C, Y, Z) layout, flax weights."""
    jx = jnp.asarray(x.transpose(0, 2, 1, 3, 4))
    jw = jnp.asarray(w.transpose(2, 3, 4, 1, 0))
    jb = None if bias is None else jnp.asarray(bias)
    return lambda xx=jx, ww=jw: conv3d_cxyz_reference(xx, ww, jb, 1, pads, pad_mode), jx, jw


CASES = [
    # (ci, co, k, dims, batch, pad_mode): the ResNet head (32 -> 1), chunks of
    # 16 with padding channels (20), Co = 3 (three n tiles: the algebra),
    # Co = 3 at (7, 7, 2) (6 columns: the plan takes it), a 5^3 kernel
    (32, 1, (7, 7, 7), (9, 10, 11), 2, "reflect"),
    (32, 1, (7, 7, 7), (20, 18, 22), 1, "zeros"),
    (20, 1, (7, 7, 7), (9, 10, 11), 1, "zeros"),
    (16, 3, (7, 7, 7), (9, 10, 11), 1, "reflect"),
    (16, 3, (7, 7, 2), (11, 9, 13), 2, "zeros"),
    (48, 1, (5, 5, 5), (9, 10, 11), 1, "reflect"),
]


@pytest.mark.parametrize("ci,co,k,dims,batch,pad_mode", CASES)
def test_fold_forward_matches_plain_and_jax(ci, co, k, dims, batch, pad_mode):
    x, w, bias, _, pads = _inputs(0, batch, ci, co, k, dims, pad_mode)
    got = fold_forward(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias), pads,
                       pad_mode)
    assert not torch.isnan(got).any()
    plain = C.conv3d_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
                           (1, 1, 1), pads, pad_mode)
    run, _, _ = _jax_conv(x, w, bias, pads, pad_mode)
    want = np.asarray(run()).transpose(0, 2, 1, 3, 4)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("ci,co,k,dims,batch,pad_mode", CASES)
def test_fold_wgrad_matches_plain_and_jax(ci, co, k, dims, batch, pad_mode):
    x, w, bias, g, pads = _inputs(1, batch, ci, co, k, dims, pad_mode)
    plan = C.conv_plan("wgrad", ci, co, k, (1, 1, 1), g.shape[2:], BF16, batch)
    # the plan's split where it takes the shape (few bricks: one per block),
    # else a split of 3 that leaves blocks with several bricks
    split = plan.split if plan.tap_chunks else 3
    got = fold_wgrad(torch.from_numpy(x), torch.from_numpy(g), w.shape, pads, pad_mode, split)
    plain = C.conv3d_wgrad_plain(torch.from_numpy(x), torch.from_numpy(g), w.shape, (1, 1, 1),
                                 pads, pad_mode)
    run, jx, jw = _jax_conv(x, w, None, pads, pad_mode)
    _, vjp = jax.vjp(lambda ww: run(jx, ww), jw)
    want = np.asarray(vjp(jnp.asarray(g.transpose(0, 2, 1, 3, 4)))[0]).transpose(4, 3, 0, 1, 2)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_fold_wgrad_split_sums_the_same_products():
    """Another split only regroups the bricks: within float32 rounding of the
    one-block result (the kernel's bit-identity is run to run at one split)."""
    x, w, _, g, pads = _inputs(2, 2, 16, 1, (7, 7, 7), (9, 10, 11), "reflect")
    a = fold_wgrad(torch.from_numpy(x), torch.from_numpy(g), w.shape, pads, "reflect", 1)
    b = fold_wgrad(torch.from_numpy(x), torch.from_numpy(g), w.shape, pads, "reflect", 5)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("co,k", [(1, (7, 7, 7)), (3, (7, 7, 2)), (2, (5, 5, 4))])
def test_fold_weights_layout(co, k):
    """[Ci chunk][dx][dy][co * kz + dz][16], zero-padded: the B tile of each
    (dx, dy) pair, as the forward's route 2 stages it with 16-byte copies."""
    ci = 20
    w = torch.from_numpy(np.random.default_rng(3).normal(size=(co, ci, *k)).astype(np.float32))
    wt = C.fold_weights(w)
    kx, ky, kz = k
    assert wt.shape == (2, kx, ky, C.FOLD_N, 16) and wt.dtype == BF16 and wt.is_contiguous()
    for c, dx, dy, n, j in [(0, 0, 0, 0, 0), (1, kx - 1, ky - 1, co * kz - 1, 3),
                            (0, 1, 2, kz, 15), (1, 0, 1, 1, 2)]:
        cc, dz = divmod(n, kz)
        want = w[cc, c * 16 + j, dx, dy, dz] if c * 16 + j < ci and n < co * kz else 0.0
        assert float(wt[c, dx, dy, n, j]) == float(torch.as_tensor(want).to(BF16))
    assert not wt[:, :, :, co * kz:].any() and not wt[1, ..., ci - 16:].any()
    with pytest.raises(ValueError):
        C.fold_weights(torch.zeros(2, 4, 7, 7, 7))
