"""Soft skeleton: hand-written CUDA kernels (forward and backward rounds) and
their plain version.

``soft_skel`` is the counterpart of
``vangan_tpu.ops.pallas.skeleton.soft_skel_pallas`` on a channels-last
``(B, X, Y, Z, C)`` float32 volume. On a CUDA tensor it runs the
``iters + 1`` uniform rounds of ``morphology.soft_skel`` as one launch each
of ``csrc/skeleton_fwd.cu`` (see the note there), bit-identical to the plain
version; on a CPU tensor it runs ``morphology.soft_skel`` (whose autograd is
the plain backward).

Where a gradient is needed (the skeleton of a prediction) the op is a
``torch.autograd.Function``: the forward keeps every round's input image and
the skel before it, in f32 (2 * (iters + 1) + 1 volumes, about 0.8 GB at
3 x 128^3 with 15 iterations), and the backward runs the rounds in reverse,
one launch of ``csrc/skeleton_bwd.cu`` each (the TPU kernel ``_round_bwd``);
it has no second derivative, and differentiating it again raises.
Without a gradient (the ground truth's skeleton) the forward keeps nothing:
it updates skel in place and ping-pongs two eroded images.

``round_fwd_plain`` is one forward round by the forward kernel's separable
passes and boundary fills, and ``round_bwd_plain`` the backward kernel's
gather, tile by tile with its halos, both in torch, for the CPU tests.
"""

from __future__ import annotations

import ctypes
import itertools

import torch
import torch.nn.functional as F

from vangan_torch.ops import build, morphology
from vangan_torch.ops.autograd import once_differentiable

# kernel launches (chip_smoke.py reads and resets them)
launches = 0             # forward rounds
bwd_launches = 0         # backward rounds
bwd_kernel_launches = 0  # the backward's kernel launches, as its C entry reports them

# the backward kernel's tile (csrc/skeleton_bwd.cu)
BWD_TILE = (16, 16, 16)
_TAPS = list(itertools.product(range(3), repeat=3))  # (dx, dy, dz) in scan order
_ERODE_TAPS = [d for d in _TAPS if 1 in d]           # the 19-voxel erosion window


def soft_skel(img: torch.Tensor, iters: int) -> torch.Tensor:
    """Soft skeleton of ``img`` (B, X, Y, Z, C). The kernels on a CUDA tensor,
    ``morphology.soft_skel`` on a CPU tensor; differentiable in ``img``.
    Anything but a 5-D volume raises, on either device: a 2-D image's
    skeleton erodes otherwise (``morphology``), and no kernel computes it."""
    if img.dim() != 5:
        raise ValueError(f"soft_skel: the skeleton kernels take (B, X, Y, Z, C) volumes, got "
                         f"shape {tuple(img.shape)}; a 2-D image's skeleton is "
                         "morphology.soft_skel")
    if img.device.type == "cpu":
        return morphology.soft_skel(img, iters)
    if torch.is_grad_enabled() and img.requires_grad:
        return _SoftSkel.apply(img, iters)
    return _soft_skel_cuda(img, iters, keep=False)[0]


class _SoftSkel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, iters):
        skel, ctx.imgs, ctx.skels = _soft_skel_cuda(img, iters, keep=True)
        ctx.save_for_backward(img)  # what a derivative of the backward would depend on
        ctx.shape = img.shape
        return skel

    @staticmethod
    @once_differentiable  # no second derivative: taking one raises
    def backward(ctx, g):
        d_img = _soft_skel_bwd_cuda(ctx.imgs, ctx.skels, g, ctx.shape)
        ctx.imgs = ctx.skels = None
        return d_img, None


def _soft_skel_bwd_cuda(imgs, skels, g: torch.Tensor, shape) -> torch.Tensor:
    """dL/d img (``shape``, channels-last) from the cotangent ``g`` of the
    skeleton and the forward's kept volumes: the rounds in reverse, one
    launch each."""
    global bwd_launches, bwd_kernel_launches
    b, X, Y, Z, c = shape
    v = imgs[0]
    # the cotangent of the last skel; a copy, since the rounds overwrite their
    # d_skel buffers in turn
    d_skel = _volumes(g.float()).clone()
    d_skel_prev = torch.empty_like(v)
    # d_img ping-pongs: a round reads the next round's d_img (its d_e_next)
    # around each tile while it writes its own
    d_imgs = [torch.empty_like(v) for _ in range(min(len(skels), 2))]
    lib = build.library()
    launched = ctypes.c_int(0)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        for k, t in enumerate(reversed(range(len(skels)))):
            first = t == 0
            d_img, d_e_next = d_imgs[k % 2], None if k == 0 else d_imgs[(k - 1) % 2]
            status = lib.vg_skeleton_round_bwd(
                imgs[t].data_ptr(), imgs[t + 1].data_ptr(),
                None if first else skels[t - 1].data_ptr(),
                None if d_e_next is None else d_e_next.data_ptr(), d_skel.data_ptr(),
                d_img.data_ptr(), None if first else d_skel_prev.data_ptr(), v.shape[0], X, Y,
                Z, int(first), stream, ctypes.byref(launched))
            build.check(status, "soft_skel backward")
            bwd_launches += 1
            d_skel, d_skel_prev = d_skel_prev, d_skel
    bwd_kernel_launches += launched.value
    return d_img.reshape(b, c, X, Y, Z).movedim(1, -1)


def _window3(v, dim, op, fill):
    """``op`` (torch.minimum or torch.maximum) of the 3-window along ``dim``,
    with ``fill`` outside the volume."""
    pad = [0, 0] * (v.dim() - 1 - dim) + [1, 1]
    w = F.pad(v, pad, value=fill)
    n = v.shape[dim]
    return op(op(w.narrow(dim, 0, n), w.narrow(dim, 1, n)), w.narrow(dim, 2, n))


def round_fwd_plain(img, skel_prev):
    """One forward round on (B, X, Y, Z) float32 volumes, ``(img, skel_prev)
    -> (skel, e)``, by ``csrc/skeleton_fwd.cu``'s separable passes and
    boundary fills, on whole volumes (min and max are exact, so the kernel's
    tiling changes no value): e = min(my(mx v), mz(min(mx v, my v))) with
    +inf outside the volume, the dilation Mx(My(Mz e)) with -inf outside it,
    then the update rounded op by op. ``skel_prev`` is None in round 0."""
    inf = float("inf")

    def mn(v, dim):
        return _window3(v, dim, torch.minimum, inf)

    def mx(v, dim):
        return _window3(v, dim, torch.maximum, -inf)

    a = mn(img, 1)
    e = torch.minimum(mn(a, 2), mn(torch.minimum(a, mn(img, 2)), 3))
    opened = mx(mx(mx(e, 3), 2), 1)
    delta = torch.clamp(img - opened, min=0.0)
    skel = delta if skel_prev is None else skel_prev + torch.clamp(
        delta - skel_prev * delta, min=0.0)
    return skel, e


def round_bwd_plain(img, e, skel_prev, d_e_next, d_skel, tile=BWD_TILE):
    """The backward of one round on (B, X, Y, Z) float32 volumes,
    ``(img, e, skel_prev, d_e_next, d_skel) -> (d_img, d_skel_prev)``, as
    ``csrc/skeleton_bwd.cu`` computes it, in the same order: for each
    ``tile`` (TX, TY, TZ) (all tiles at once, as windows of the padded
    volumes), the dilation's argmax and d_v on the tile and a halo of 2 (e
    staged with a halo of 3), d_e and the erosion's argmin on a halo of 1,
    d_img on the tile; ties to the first extremum in scan order.
    ``skel_prev`` is None in round 0 (then d_skel_prev is None),
    ``d_e_next`` None after the last."""
    B, X, Y, Z = img.shape
    nt = [-(-n // t) for n, t in zip((X, Y, Z), tile)]
    inf = float("inf")

    def windows(v, halo, fill):
        """(B, nx, ny, nz, TX + 2 halo, ...): each tile with its halo, from
        ``v`` padded with ``fill`` around the volume and up to the last tile."""
        hi = [t * k - n + halo for t, k, n in zip(tile, nt, (X, Y, Z))]
        v = F.pad(v, (halo, hi[2], halo, hi[1], halo, hi[0]), value=fill)
        for dim, t in enumerate(tile, start=1):
            v = v.unfold(dim, t + 2 * halo, t)
        return v

    def box(v, at, size):
        """The ``size`` box of each tile's window ``v`` from local ``at``."""
        return v[..., at[0]:at[0] + size[0], at[1]:at[1] + size[1], at[2]:at[2] + size[2]]

    A = tuple(t + 4 for t in tile)   # the halo-2 box
    Bh = tuple(t + 2 for t in tile)  # the halo-1 box
    we, wimg = windows(e, 3, -inf), windows(img, 2, inf)
    inA = windows(torch.ones_like(img, dtype=torch.bool), 2, False)
    # A: argmax of e over the 3^3 window of each voxel of the halo-2 box
    opened = torch.full(inA.shape, -inf, device=img.device)
    amax = torch.zeros(inA.shape, dtype=torch.long, device=img.device)
    for tap, d in enumerate(_TAPS):
        v = box(we, d, A)
        up = v > opened
        opened, amax = torch.where(up, v, opened), torch.where(up, tap, amax)
    diff = wimg - opened
    delta = torch.clamp(diff, min=0.0)
    gs = windows(d_skel, 2, 0.0)
    d_sp = None
    if skel_prev is None:
        d_delta = gs
    else:
        s = windows(skel_prev, 2, 0.0)
        up = (delta - s * delta) > 0
        d_delta = torch.where(up, gs * (1.0 - s), 0.0)
        d_sp = box(torch.where(up, gs * (1.0 - delta), gs), (2, 2, 2), tile)
    dv = torch.where(inA & (diff > 0), d_delta, 0.0)
    amax = torch.where(inA, amax, 0)
    # B: d_e on the halo-1 box (r = q - (d - 1) at halo-2 index l + 2 - d)
    inB = box(inA, (1, 1, 1), Bh)
    acc = torch.zeros(inB.shape, device=img.device)
    for tap, (dx, dy, dz) in enumerate(_TAPS):
        at = (2 - dx, 2 - dy, 2 - dz)
        acc = acc + torch.where(box(amax, at, Bh) == tap, box(dv, at, Bh), 0.0)
    den = 0.0 if d_e_next is None else box(windows(d_e_next, 2, 0.0), (1, 1, 1), Bh)
    de = torch.where(inB, den - acc, 0.0)
    # and the erosion's argmin over img's 19-voxel window
    lo = torch.full(inB.shape, inf, device=img.device)
    amin = torch.full(inB.shape, 255, dtype=torch.long, device=img.device)
    for dx, dy, dz in _ERODE_TAPS:
        v = box(wimg, (dx, dy, dz), Bh)
        up = v < lo
        lo, amin = torch.where(up, v, lo), torch.where(up, (dx * 3 + dy) * 3 + dz, amin)
    amin = torch.where(inB, amin, 255)
    # C: d_img on the tile (q = p - (d - 1) at halo-1 index l + 2 - d)
    acc = box(dv, (2, 2, 2), tile)
    for dx, dy, dz in _ERODE_TAPS:
        at = (2 - dx, 2 - dy, 2 - dz)
        acc = acc + torch.where(box(amin, at, tile) == (dx * 3 + dy) * 3 + dz,
                                box(de, at, tile), 0.0)

    def volume(t):
        """(B, nx, ny, nz, TX, TY, TZ) tiles -> (B, X, Y, Z)."""
        t = t.permute(0, 1, 4, 2, 5, 3, 6).reshape(B, *(k * n for k, n in zip(nt, tile)))
        return t[:, :X, :Y, :Z].contiguous()

    return volume(acc), None if d_sp is None else volume(d_sp)


def _volumes(img: torch.Tensor) -> torch.Tensor:
    """(B, X, Y, Z, C) -> contiguous (B*C, X, Y, Z): a reshape for C = 1."""
    b, X, Y, Z, c = img.shape
    return img.movedim(-1, 1).reshape(b * c, X, Y, Z).contiguous()


def _soft_skel_cuda(img: torch.Tensor, iters: int, keep: bool):
    """(skel (B, X, Y, Z, C); with ``keep`` also the iters + 2 round inputs
    img_0..img_{iters+1} and the iters + 1 skels skel_0..skel_iters as
    (B*C, X, Y, Z) volumes, else None, None)."""
    global launches
    if img.device.type != "cuda":
        raise ValueError(f"soft_skel: no kernel for device {img.device}")
    if img.dtype != torch.float32:
        raise TypeError(f"soft_skel: the kernel takes float32, got {img.dtype}")
    if img.dim() != 5 or iters < 0:
        raise ValueError(f"soft_skel: shape {tuple(img.shape)}, iters {iters}")
    b, X, Y, Z, c = img.shape
    v = _volumes(img.detach())
    if keep:
        imgs = [v] + [torch.empty_like(v) for _ in range(iters + 1)]
        skels = [torch.empty_like(v) for _ in range(iters + 1)]
    else:
        bufs = [torch.empty_like(v) for _ in range(min(iters, 2))]  # eroded images, ping-pong
        imgs = [v] + [bufs[t % 2] for t in range(iters)] + [None]
        skels = [torch.empty_like(v)] * (iters + 1)  # one buffer, updated in place
    lib = build.library()
    launched = ctypes.c_int(0)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        for t in range(iters + 1):
            nxt = imgs[t + 1]
            status = lib.vg_skeleton_round_fwd(
                imgs[t].data_ptr(), None if t == 0 else skels[t - 1].data_ptr(),
                skels[t].data_ptr(), None if nxt is None else nxt.data_ptr(),
                b * c, X, Y, Z, int(t == 0), stream)
            build.check(status, "soft_skel")
            launches += 1
    skel = skels[-1].reshape(b, c, X, Y, Z).movedim(1, -1)
    return (skel, imgs, skels) if keep else (skel, None, None)
