"""Soft skeleton forward: a hand-written CUDA kernel and its plain version.

``soft_skel`` is the counterpart of
``vangan_tpu.ops.pallas.skeleton.soft_skel_pallas`` (forward) on a
channels-last ``(B, X, Y, Z, C)`` float32 volume. On a CUDA tensor it runs the
``iters + 1`` uniform rounds of ``morphology.soft_skel`` as one launch each
of ``csrc/skeleton_fwd.cu`` (see the note there), bit-identical to the plain
version; on a CPU tensor it runs ``morphology.soft_skel``. Forward only: the
backward (the TPU kernel ``_round_bwd``) is not ported yet, so the kernel
refuses an input that needs a gradient.
"""

from __future__ import annotations

import torch

from vangan_torch.ops import build, morphology

launches = 0  # kernel launches made by soft_skel (chip_smoke.py reads and resets it)


def soft_skel(img: torch.Tensor, iters: int) -> torch.Tensor:
    """Soft skeleton of ``img`` (B, X, Y, Z, C). The kernel on a CUDA tensor,
    ``morphology.soft_skel`` on a CPU tensor."""
    if img.device.type == "cpu":
        return morphology.soft_skel(img, iters)
    return _soft_skel_cuda(img, iters)


def _soft_skel_cuda(img: torch.Tensor, iters: int) -> torch.Tensor:
    global launches
    if img.device.type != "cuda":
        raise ValueError(f"soft_skel: no kernel for device {img.device}")
    if img.dtype != torch.float32:
        raise TypeError(f"soft_skel: the kernel takes float32, got {img.dtype}")
    if img.dim() != 5 or iters < 0:
        raise ValueError(f"soft_skel: shape {tuple(img.shape)}, iters {iters}")
    if torch.is_grad_enabled() and img.requires_grad:
        raise RuntimeError("soft_skel: the CUDA kernel is forward only "
                           "(run under torch.inference_mode or no_grad)")
    b, X, Y, Z, c = img.shape
    # channels fold into the batch: a reshape for C = 1
    v = img.movedim(-1, 1).reshape(b * c, X, Y, Z).contiguous()
    skel = torch.empty_like(v)
    bufs = [torch.empty_like(v) for _ in range(min(iters, 2))]  # eroded images, ping-pong
    lib = build.library()
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        for t in range(iters + 1):
            nxt = bufs[t % 2] if t < iters else None
            status = lib.vg_skeleton_round_fwd(
                v.data_ptr(), skel.data_ptr(), None if nxt is None else nxt.data_ptr(),
                b * c, X, Y, Z, int(t == 0), stream)
            build.check(status, "soft_skel")
            launches += 1
            v = nxt
    return skel.reshape(b, c, X, Y, Z).movedim(1, -1)
