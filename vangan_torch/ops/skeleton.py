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
one call of ``csrc/skeleton_bwd.cu`` each (the TPU kernel ``_round_bwd``).
Without a gradient (the ground truth's skeleton) the forward keeps nothing:
it updates skel in place and ping-pongs two eroded images.
"""

from __future__ import annotations

import torch

from vangan_torch.ops import build, morphology

# kernel launches (chip_smoke.py reads and resets them)
launches = 0      # forward rounds
bwd_launches = 0  # backward rounds


def soft_skel(img: torch.Tensor, iters: int) -> torch.Tensor:
    """Soft skeleton of ``img`` (B, X, Y, Z, C). The kernels on a CUDA tensor,
    ``morphology.soft_skel`` on a CPU tensor; differentiable in ``img``."""
    if img.device.type == "cpu":
        return morphology.soft_skel(img, iters)
    if torch.is_grad_enabled() and img.requires_grad:
        return _SoftSkel.apply(img, iters)
    return _soft_skel_cuda(img, iters, keep=False)[0]


class _SoftSkel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, iters):
        skel, ctx.imgs, ctx.skels = _soft_skel_cuda(img, iters, keep=True)
        ctx.shape = img.shape
        return skel

    @staticmethod
    def backward(ctx, g):
        d_img = _soft_skel_bwd_cuda(ctx.imgs, ctx.skels, g, ctx.shape)
        ctx.imgs = ctx.skels = None
        return d_img, None


def _soft_skel_bwd_cuda(imgs, skels, g: torch.Tensor, shape) -> torch.Tensor:
    """dL/d img (``shape``, channels-last) from the cotangent ``g`` of the
    skeleton and the forward's kept volumes: the rounds in reverse."""
    global bwd_launches
    b, X, Y, Z, c = shape
    v = imgs[0]
    # the cotangent of the last skel; a copy, since the rounds overwrite their
    # d_skel buffers in turn
    d_skel = _volumes(g.float()).clone()
    d_skel_prev, d_img, d_e, d_v = (torch.empty_like(v) for _ in range(4))
    lib = build.library()
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        for t in reversed(range(len(skels))):
            first = t == 0
            status = lib.vg_skeleton_round_bwd(
                imgs[t].data_ptr(), imgs[t + 1].data_ptr(),
                None if first else skels[t - 1].data_ptr(),
                None if t == len(skels) - 1 else d_img.data_ptr(), d_skel.data_ptr(),
                d_img.data_ptr(), None if first else d_skel_prev.data_ptr(),
                d_e.data_ptr(), d_v.data_ptr(), v.shape[0], X, Y, Z, int(first), stream)
            build.check(status, "soft_skel backward")
            bwd_launches += 1
            d_skel, d_skel_prev = d_skel_prev, d_skel
    return d_img.reshape(b, c, X, Y, Z).movedim(1, -1)


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
