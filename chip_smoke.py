#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vangan_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

0. the card (nvidia-smi name and power limit); CUDA must be available;
1. build the CUDA kernels from vangan_torch/ops/csrc with nvcc (sm_90a);
2. the conv3d kernels against their plain versions at every conv shape the
   full-width gen_IS (17 kernel convs) and disc_I (1: conv0) give them at
   128^3, at the step's batch of 3: the forward (K1) against F.conv3d, the input gradient (K2,
   the forward kernel per stride parity) against torch.nn.grad.conv3d_input
   and the weight gradient (K3) against torch.nn.grad.conv3d_weight, in
   float32 (TF32 off; y and dx within 1e-4 * max |ref|, dW within 1e-3, its
   sums run over up to 2 M voxels in another order) and bfloat16 (2e-2),
   with CUDA event times (median of 5) of the kernel, the plain version and
   the library call; each row names the bf16 plan (``conv_plan``: the
   route, tensor-core or thin CUDA-core body, and the Co tile, split and
   workspace) of K1, each K2 parity and K3, and the achieved TFLOP/s (FLOPs
   / kernel ms) of the kernel and the library call; the bf16 K3 must give
   bit-identical dW in two runs; a shape that takes the thin body is also
   run and timed on the tensor-core body, the evidence for the choice;
3. the InstanceNorm kernels against their plain versions at every (C, size)
   of the two networks (28 and 4 norms), batch 3, for each activation: the
   forward (K4) and the backward (K5: dx, dgamma, dbeta against autograd of
   instance_norm_act_plain), with the same tolerances and timing;
4. the soft-skeleton kernels against their plain version (morphology) at the
   step's shape, 3 x 128^3, 15 iterations: the forward (K6) on the min-max
   normalised tanh of seeded noise and on a binary volume touching every
   face, bit-exact (max |diff| == 0); the backward (K7) on seeded continuous
   data with distinct values against autograd of morphology.soft_skel, max
   |diff| <= 1e-5 * max |g|; CUDA event times (median of 5);
5. gen_IS (f=16, 4 levels) on a batch of 8 x 128^3 from seeded weights: one
   bf16 call must launch the conv kernel 17 times and the IN kernel 28 times;
   in f32 the kernel path must match the plain path (max |diff| <= 1e-3 on
   the tanh outputs); in bf16 the kernel path must be no further from the f32
   plain result than the bf16 plain path is (2x on the mean, 3x on the max,
   see ``bf16_vs_reference``); ms per bf16 batch of both paths;
6. the evaluation path: ``VanGan.distributed_test_step`` at full width (four
   networks from seeded init, a seeded batch of 3 x 128^3, bf16): one step
   must launch the conv kernel 4 x 17 + 4 x 1 times, the IN kernel
   4 x 28 + 4 x 4 times and the skeleton kernel 2 x 16 times; all ten losses
   finite; in f32 each loss of the kernel path within 1e-3 relative of the
   plain path's; in bf16 each within max(3 |plain bf16 - f32|, 1e-3 |f32|)
   of the f32 plain loss; ms per step of both paths, in turns, and peak
   device memory;
7. the serving path: ``python -m vangan_torch predict`` (through cli.main) on
   a seeded 256^3 volume with weights saved from seeded init, stride 64,
   uniform blend, padFactor 0.25; the TIFF must be (256, 256, 256, 1)
   z-x-y-c, finite, in [0, 255], every kernel must have launched once per
   gen_IS batch, and the volume must pass the bf16 check of phase 5 against
   plain-path stitches of the same input;
8. the training path: ``VanGan.distributed_train_step`` at full width (four
   networks from seeded init, the seeded batch of phase 6, noise sigma 0.1,
   dropout on, bf16): one step must launch every kernel an exact count (see
   ``TRAIN_LAUNCHES``), give ten finite losses, and leave every network's
   parameters finite and changed; from the same weights and noise seed, on
   the batch's first sample (the f32 plain path does not fit in 80 GB at
   batch 3): in f32 each loss of the kernel path within 1e-3 relative of the
   plain path's and each network's flat gradient within 3x the plain path's
   own spread under a 1e-6 weight perturbation (relative L2, see
   ``SPREAD_FACTOR``), in bf16 each network's gradient no further from the
   f32 plain gradient than max(3 x the bf16 plain path's distance, 1e-3);
   on the whole batch in bf16, each loss and each network's gradient of the
   kernel path within max(3x the two bf16 paths' distance on one sample,
   1e-3) of the plain path's; ms per step of both paths in turns after a
   warm-up step, and peak device memory.

Then one JSON line of the seven kernels (launches counted in one train step
of phase 8, the path that runs them all; ms, plain ms, library ms and the
bound summed over the convs / norms of one gen_IS and one disc_I call at
batch 3 (phases 2-3), one 3 x 128^3 skeleton for soft_skel) and,
last, the ok line. Without CUDA, or outside the repository, it exits
non-zero before printing either.
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

N = 128          # patch edge (SUBVOL_PATCH_SIZE)
BATCH = 8        # stitcher_batch
VOLUME = 256     # predict phase volume edge
STRIDE = 64
STEP_BATCH = 3   # test and train step batch (BATCH_SIZE x N_DEVICES of the default config)
SKEL_ITERS = 15  # cldice_iters
SEED = 0
DEVICE = "cuda"
CONV_PATH_CALLS = 17  # kernel convs per gen_IS call (max(Ci, Co) < 128)
IN_PATH_CALLS = 28    # InstanceNorms per gen_IS call
DISC_CONV_CALLS = 1   # kernel convs per disc call (conv0; the wider ones take cuDNN)
DISC_IN_CALLS = 4     # InstanceNorms per disc call
NOISE = 0.1           # discriminator noise sigma of the train step (layer_noise at epoch 0)
# One train step (phase 8), derived from the path:
# - forward: 4 generator calls x 17 kernel convs / 28 norms, and 6
#   discriminator calls (real S, real I, and each fake judged twice) x conv0
#   / 4 norms; the two skeletons (prediction, ground truth) x 16 rounds;
# - K3 for every kernel conv whose weight needs a gradient: the 17 of each
#   generator call, and conv0 in the 4 discriminator calls with live
#   parameters (the 2 generator-branch judgements freeze them);
# - K2, one forward-kernel launch per non-empty stride parity, for every
#   kernel conv whose input needs a gradient: per generator call all but
#   stem.conv1 and stem.shortcut (they read data or a detached fake):
#   stem.conv_block 1, enc1 and enc2 10 each (block1, 3^3 stride 2: 8
#   parities; shortcut, 1^3 stride 2: 1 non-empty parity; block2: 1),
#   dec2.block2 1, dec1 3, dec0 3, head 1 = 29; and conv0 (4^3 stride 2: 8
#   parities) of the 2 generator-branch judgements, whose input is the fake;
# - one K5 call per norm; 16 K7 rounds for the prediction's skeleton (the
#   ground truth's takes no gradient).
TRAIN_LAUNCHES = {
    "conv3d_fwd": 4 * CONV_PATH_CALLS + 6 * DISC_CONV_CALLS,
    "conv3d_dgrad": 4 * 29 + 2 * 8,
    "conv3d_wgrad": 4 * CONV_PATH_CALLS + 4 * DISC_CONV_CALLS,
    "instnorm_fwd": 4 * IN_PATH_CALLS + 6 * DISC_IN_CALLS,
    "instnorm_bwd": 4 * IN_PATH_CALLS + 6 * DISC_IN_CALLS,
    "soft_skel_fwd": 2 * (SKEL_ITERS + 1),
    "soft_skel_bwd": SKEL_ITERS + 1,
}


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps=5):
    """Median of ``reps`` CUDA-event timings of ``fn()`` after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def errs(got, want):
    d = (got.float() - want.float()).abs()
    scale = float(want.float().abs().max())
    return float(d.max()), float(d.max()) / max(scale, 1e-30)


def path_shapes(model):
    """The (name, module, input shape) of every conv and InstanceNorm of one
    call of ``model`` at N^3, batch 1, recorded on the plain path."""
    from vangan_torch.models.layers import ConvND, InstanceNorm

    seen, hooks = [], []
    for name, m in model.named_modules():
        if isinstance(m, (ConvND, InstanceNorm)):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, inp, name=name: seen.append((name, mod, tuple(inp[0].shape)))))
    model.set_use_kernels(False)
    with torch.inference_mode():
        model(torch.zeros(1, N, N, N, 1, device=DEVICE))
    model.set_use_kernels(True)
    for h in hooks:
        h.remove()
    return seen


# Peaks of one H100 SXM (NVIDIA's data sheet, dense): the bound of a kernel is
# the larger of its bytes over the memory rate and its operations over the
# rate of their type.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12  # tensor cores
F32_OP_PER_S = 67e12      # CUDA cores (the skeleton's compares and adds)


def bound(ops, nbytes, rate):
    """(ms, "operations" or "bytes"): the least time for the work."""
    t_ops, t_bytes = ops / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def conv_work(co, ci, k, out_dims, in_dims, batch, esize=2):
    """(FLOPs, bytes of x, w, y) of one conv."""
    taps, n_out = math.prod(k), batch * math.prod(out_dims)
    return (2 * co * ci * taps * n_out,
            esize * (ci * batch * math.prod(in_dims) + co * ci * taps + co * n_out))


def plans(ci, co, k, stride, pads, dims, out_dims):
    """The bf16 plans (route and tiles) of K1, each K2 parity and K3 of a conv."""
    from vangan_torch.ops import conv3d as C

    keys = ("route", "co_tile", "co_tiles", "tap_warps", "tap_groups", "split",
            "workspace_bytes", "pad_share")
    brief = lambda p: {k_: getattr(p, k_) for k_ in keys}  # noqa: E731
    bf16 = torch.bfloat16
    return {"brick": list(C.BRICK), "ci_chunk": C.CI_CHUNK,
            "fwd": brief(C.conv_plan("fwd", ci, co, k, stride, out_dims, bf16, STEP_BATCH)),
            "dgrad": [dict(brief(C.conv_plan("fwd", co, ci, e, (1, 1, 1), n, bf16, STEP_BATCH)),
                           k=list(e)) for _, e, n in C.dgrad_parities(
                               k, stride, C.padded_dims(dims, pads))],
            "wgrad": brief(C.conv_plan("wgrad", ci, co, k, stride, out_dims, bf16,
                                       STEP_BATCH))}


def check_convs(net, shapes, expected, tol):
    """K1 (forward), K2 (dgrad) and K3 (wgrad) at each conv shape of ``net``."""
    from vangan_torch.models.layers import KERNEL_MAX_CHANNELS, ConvND
    from vangan_torch.ops import conv3d as C
    from vangan_torch.ops.pad import pad3d

    groups = {}
    for name, m, shape in shapes:
        if isinstance(m, ConvND) and max(m.weight.shape[:2]) < KERNEL_MAX_CHANNELS:
            key = (tuple(m.weight.shape), m.strides, str(m.padding), m.pad_mode,
                   m.bias is not None, shape[2:])
            groups.setdefault(key, []).append(name)
    n_calls = sum(len(v) for v in groups.values())
    require(n_calls == expected, f"{n_calls} kernel convs in a {net} call, "
            f"expected {expected}")
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    grad_tol = {"dx": tol, "dw": {torch.float32: 1e-3, torch.bfloat16: 2e-2}}
    rows = []
    for (wshape, stride, padding, pad_mode, has_bias, dims), names in groups.items():
        m = next(mm for nn_, mm, _ in shapes if nn_ == names[0])
        co, ci = wshape[:2]
        x32 = torch.randn(STEP_BATCH, ci, *dims, device=DEVICE, generator=g)
        w = torch.randn(wshape, device=DEVICE, generator=g) * math.sqrt(2.0 / (ci * 27))
        b = torch.randn(co, device=DEVICE, generator=g) * 0.1 if has_bias else None
        pads = C.norm_padding(m.padding, m.kernel_size, stride, dims)
        out_dims = [(n + lo + hi - kk) // s + 1
                    for n, (lo, hi), kk, s in zip(dims, pads, m.kernel_size, stride)]
        gy32 = torch.randn(STEP_BATCH, co, *out_dims, device=DEVICE, generator=g)
        flops, nbytes = conv_work(co, ci, m.kernel_size, out_dims, dims, STEP_BATCH)
        xp_shape = (STEP_BATCH, ci, *C.padded_dims(dims, pads))
        row = {"net": net, "convs": names, "w": list(wshape), "stride": list(stride),
               "in": list(dims), "gflop": flops / 1e9,
               "bound": {k: bound(flops, nb, BF16_FLOP_PER_S) for k, nb in (
                   ("fwd", nbytes), ("dgrad", nbytes),
                   # wgrad: x, g read, dW written in f32
                   ("wgrad", nbytes + 2 * co * ci * math.prod(m.kernel_size)))}}
        for dtype in (torch.float32, torch.bfloat16):
            x, gy = x32.to(dtype), gy32.to(dtype)
            xp = pad3d(x, pads, pad_mode)
            tag = "f32" if dtype == torch.float32 else "bf16"
            with torch.inference_mode():
                ops = {
                    "fwd": (lambda: C.conv3d(x, w, b, stride, m.padding, pad_mode),
                            lambda: C.conv3d_plain(x, w, b, stride, pads, pad_mode),
                            lambda: F.conv3d(xp, w.to(dtype), None if b is None
                                             else b.to(dtype), stride)),
                    "dgrad": (lambda: C.conv3d_dgrad(gy, w, x.shape, stride, pads, pad_mode),
                              lambda: C.conv3d_dgrad_plain(gy, w, x.shape, stride, pads,
                                                           pad_mode),
                              lambda: torch.nn.grad.conv3d_input(xp_shape, w.to(dtype), gy,
                                                                 stride)),
                    "wgrad": (lambda: C.conv3d_wgrad(x, gy, wshape, stride, pads, pad_mode),
                              lambda: C.conv3d_wgrad_plain(x, gy, wshape, stride, pads,
                                                           pad_mode),
                              lambda: torch.nn.grad.conv3d_weight(xp, wshape, gy, stride)),
                }
                for op, (kern, plain, library) in ops.items():
                    got, want = kern(), plain()
                    torch.cuda.synchronize()
                    require(got.shape == want.shape, f"conv {op} {names}: shape {got.shape} "
                            f"vs {want.shape}")
                    abs_err, rel = errs(got, want)
                    limit = tol[dtype] if op == "fwd" else grad_tol[
                        "dw" if op == "wgrad" else "dx"][dtype]
                    row[f"{op}_{tag}_abs_err"], row[f"{op}_{tag}_rel_err"] = abs_err, rel
                    require(rel <= limit, f"conv {op} {names} {dtype}: rel err {rel:.3e} "
                            f"> {limit}")
                    if op == "wgrad" and dtype == torch.bfloat16:
                        # split-K in a fixed order: the same bits every run
                        require(torch.equal(got, kern()), f"conv wgrad {names}: dW differs "
                                "between two runs on the same inputs")
                        row["wgrad_bf16_bit_identical"] = True
                    row[f"{op}_{tag}_ms"] = cuda_ms(kern)
                    row[f"{op}_{tag}_plain_ms"] = cuda_ms(plain)
                    row[f"{op}_{tag}_library_ms"] = cuda_ms(library)
                    row[f"{op}_{tag}_tflops"] = flops / row[f"{op}_{tag}_ms"] / 1e9
                    row[f"{op}_{tag}_library_tflops"] = flops / row[f"{op}_{tag}_library_ms"] / 1e9
                row["plan"] = plans(ci, co, m.kernel_size, stride, pads, dims, out_dims)
                if dtype == torch.bfloat16 and row["plan"]["fwd"]["route"] == "thin":
                    # the tensor-core body on the same shape, Ci padded to
                    # 16: what the thin shapes' choice of body rests on
                    mma = C.conv_plan("fwd", ci, co, m.kernel_size, stride, out_dims, dtype,
                                      STEP_BATCH, thin_max_ci=0)
                    if mma.route == "mma":
                        run = lambda: C._launch_fwd(x, w, b, stride, [lo for lo, _ in pads],  # noqa: E731
                                                    pad_mode == "reflect", out_dims, "conv3d",
                                                    plan=mma)
                        _, rel = errs(run(), C.conv3d_plain(x, w, b, stride, pads, pad_mode))
                        require(rel <= tol[dtype], f"conv fwd {names} on the tensor-core "
                                f"body: rel err {rel:.3e}")
                        row["fwd_bf16_mma_body_ms"] = cuda_ms(run)
        rows.append(row)
        print("conv", json.dumps(row))
    return rows


def check_instnorms(net, shapes, expected, tol):
    """K4 (forward) and K5 (backward) at each (C, size) and activation of ``net``."""
    from vangan_torch.models.layers import InstanceNorm
    from vangan_torch.ops import instnorm as I

    groups = {}
    for name, m, shape in shapes:
        if isinstance(m, InstanceNorm):
            groups.setdefault((shape[1], shape[2:]), []).append((name, m.act))
    n_calls = sum(len(v) for v in groups.values())
    require(n_calls == expected, f"{n_calls} InstanceNorms in a {net} call, "
            f"expected {expected}")
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    rows = []
    for (c, dims), uses in groups.items():
        x32 = torch.randn(STEP_BATCH, c, *dims, device=DEVICE, generator=g) * 2 + 0.5
        gy32 = torch.randn(STEP_BATCH, c, *dims, device=DEVICE, generator=g)
        gamma = torch.randn(c, device=DEVICE, generator=g) * 0.5 + 1
        beta = torch.randn(c, device=DEVICE, generator=g) * 0.2
        n = STEP_BATCH * c * math.prod(dims)
        for act in ("none", "relu", "leaky_relu"):
            row = {"net": net, "c": c, "in": list(dims), "act": act,
                   "uses": [nm for nm, a in uses if a == act],
                   # x read, y written / x, g read, dx written (bf16)
                   "bound": {"fwd": bound(8 * n, 4 * n, BF16_FLOP_PER_S),
                             "bwd": bound(16 * n, 6 * n, BF16_FLOP_PER_S)}}
            for dtype in (torch.float32, torch.bfloat16):
                x, gy = x32.to(dtype), gy32.to(dtype)
                tag = "f32" if dtype == torch.float32 else "bf16"
                with torch.inference_mode():
                    kern = lambda: I.instance_norm_act(x, gamma, beta, 1e-3, act)  # noqa: E731
                    plain = lambda: I.instance_norm_act_plain(x, gamma, beta, 1e-3, act)  # noqa: E731
                    got, want = kern(), plain()
                    torch.cuda.synchronize()
                    abs_err, rel = errs(got, want)
                    require(rel <= tol[dtype], f"IN C={c} {dims} {act} {dtype}: "
                            f"rel err {rel:.3e}")
                    row[f"fwd_{tag}_abs_err"], row[f"fwd_{tag}_rel_err"] = abs_err, rel
                    row[f"fwd_{tag}_ms"], row[f"fwd_{tag}_plain_ms"] = cuda_ms(kern), cuda_ms(plain)
                    row[f"fwd_{tag}_library_ms"] = cuda_ms(
                        lambda: F.instance_norm(x, weight=gamma.to(dtype),
                                                bias=beta.to(dtype), eps=1e-3))
                    _, stats = I._instance_norm_act_cuda(x, gamma, beta, 1e-3, act, 0.2)
                    kern_b = lambda: I._instance_norm_act_bwd_cuda(x, gy, stats, act, 0.2)  # noqa: E731
                    plain_b = lambda: I.instance_norm_act_bwd_plain(x, gy, gamma, beta, 1e-3,  # noqa: E731
                                                                    act)
                    got_b = kern_b()
                # the plain backward: autograd of the plain forward
                leaves = [t.clone().requires_grad_() for t in (x, gamma, beta)]
                I.instance_norm_act_plain(*leaves, 1e-3, act).backward(gy)
                torch.cuda.synchronize()
                # act' has a kink at pre = 0, where the two paths' f32
                # pre-activations (an fma in the kernel, two rounded ops in
                # torch) may fall on different sides, and any slope between
                # the one-sided ones is a subgradient: dx leaves out the
                # voxels within 1e-6 of max |pre| of it, and dgamma / dbeta
                # may differ per channel by what those voxels contribute
                # (sum |g * xhat| / sum |g|) on top of the tolerance
                xd = x.double()
                var, mean = torch.var_mean(xd, dim=(2, 3, 4), unbiased=False, keepdim=True)
                xhat = (xd - mean) * torch.rsqrt(var + 1e-3)
                pre = (xhat * gamma.double().reshape(1, -1, 1, 1, 1)
                       + beta.double().reshape(1, -1, 1, 1, 1))
                kink = pre.abs() <= 1e-6 * float(pre.abs().max())
                if act == "none":
                    kink = torch.zeros_like(kink)
                gk_abs = gy.double().abs() * kink
                slack = {"dx": None, "dgamma": (gk_abs * xhat.abs()).sum(dim=(0, 2, 3, 4)),
                         "dbeta": gk_abs.sum(dim=(0, 2, 3, 4))}
                row[f"bwd_{tag}_kink_voxels"] = int(kink.sum())
                for part, gk, leaf in zip(("dx", "dgamma", "dbeta"), got_b, leaves):
                    want = leaf.grad.double()
                    diff = (gk.double() - want).abs()
                    if part == "dx":
                        diff = diff[~kink]
                    else:
                        diff = (diff - slack[part]).clamp(min=0.0)
                    abs_err = float(diff.max())
                    rel = abs_err / max(float(want.abs().max()), 1e-30)
                    require(rel <= tol[dtype], f"IN backward {part} C={c} {dims} {act} "
                            f"{dtype}: rel err {rel:.3e}")
                    row[f"bwd_{part}_{tag}_abs_err"], row[f"bwd_{part}_{tag}_rel_err"] = \
                        abs_err, rel
                with torch.inference_mode():
                    row[f"bwd_{tag}_ms"] = cuda_ms(kern_b)
                    row[f"bwd_{tag}_plain_ms"] = cuda_ms(plain_b)
            rows.append(row)
            print("instnorm", json.dumps(row))
    return rows


def bf16_vs_reference(k16, p16, ref, what):
    """The bf16 kernel path against the f32 plain reference, measured against
    the bf16 plain path's own distance to that reference: the two bf16 paths
    round at different points, and a random-init network amplifies those
    2^-8 differences, so the check is that the kernel path is no further from
    the f32 result than 2x (mean) / 3x (max) the plain bf16 path is."""
    ek, ep = (k16 - ref).abs(), (p16 - ref).abs()
    d = (k16 - p16).abs()
    res = {"kernel_vs_ref_max": float(ek.max()), "kernel_vs_ref_mean": float(ek.mean()),
           "plain_vs_ref_max": float(ep.max()), "plain_vs_ref_mean": float(ep.mean()),
           "kernel_vs_plain_max": float(d.max()), "kernel_vs_plain_mean": float(d.mean())}
    require(res["kernel_vs_ref_mean"] <= 2 * res["plain_vs_ref_mean"]
            and res["kernel_vs_ref_max"] <= 3 * res["plain_vs_ref_max"],
            f"{what}: bf16 kernel path too far from the f32 reference: {res}")
    return res


def check_skeleton(skel_ops):
    """K6 bit-exact on two inputs; K7 against autograd of the plain skeleton."""
    from vangan_torch.ops import morphology
    from vangan_torch.ops.norms import min_max_norm

    shape = (STEP_BATCH, N, N, N, 1)
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    noise = torch.randn(shape, device=DEVICE, generator=g)
    vessels = (torch.rand(shape, device=DEVICE, generator=g) > 0.7).float()
    for face in (vessels[:, 0], vessels[:, -1], vessels[:, :, 0], vessels[:, :, -1],
                 vessels[:, :, :, 0], vessels[:, :, :, -1]):
        face[..., :N // 2, :] = 1.0  # a structure on every face
    inputs = {"tanh_noise": min_max_norm(torch.tanh(noise), axis=(1, 2, 3, 4)),
              "binary_faces": vessels}
    n_vox = math.prod(shape)
    rounds = SKEL_ITERS + 1
    # per voxel and round: 19 + 27 compares and a few adds forward; twice the
    # compares and the gathers backward; the function's input and output (and
    # cotangent) read or written once, f32
    res = {"shape": list(shape), "iters": SKEL_ITERS,
           "fwd_bound": bound(50 * rounds * n_vox, 8 * n_vox, F32_OP_PER_S),
           "bwd_bound": bound(100 * rounds * n_vox, 12 * n_vox, F32_OP_PER_S)}
    with torch.inference_mode():
        for tag, x in inputs.items():
            got = skel_ops.soft_skel(x, SKEL_ITERS)
            want = morphology.soft_skel(x, SKEL_ITERS)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            require(got.shape == want.shape and err == 0.0,
                    f"soft_skel kernel vs plain on {tag}: max |diff| {err:.3e}")
            res[f"{tag}_max_abs_err"] = err
            res[f"{tag}_ms"] = cuda_ms(lambda: skel_ops.soft_skel(x, SKEL_ITERS))
            res[f"{tag}_plain_ms"] = cuda_ms(lambda: morphology.soft_skel(x, SKEL_ITERS))

    # K7: distinct values, where every tie rule gives the same input gradient
    x = (torch.randperm(n_vox, device=DEVICE, generator=g).float() / n_vox).reshape(shape)
    gy = torch.randn(shape, device=DEVICE, generator=g)
    xk, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
    skel_ops.soft_skel(xk, SKEL_ITERS).backward(gy)
    ref_out = morphology.soft_skel(xp, SKEL_ITERS)
    (ref,) = torch.autograd.grad(ref_out, xp, gy, retain_graph=True)
    torch.cuda.synchronize()
    err, scale = float((xk.grad - ref).abs().max()), float(ref.abs().max())
    res["bwd_max_abs_err"], res["bwd_max_abs_grad"] = err, scale
    require(err <= 1e-5 * scale, f"soft_skel backward kernel vs autograd: max |diff| "
            f"{err:.3e}, max |g| {scale:.3e}")
    _, imgs, skels = skel_ops._soft_skel_cuda(x, SKEL_ITERS, keep=True)
    res["bwd_ms"] = cuda_ms(lambda: skel_ops._soft_skel_bwd_cuda(imgs, skels, gy, shape))
    res["bwd_plain_ms"] = cuda_ms(lambda: torch.autograd.grad(ref_out, xp, gy,
                                                              retain_graph=True))
    del imgs, skels, ref_out
    print("soft_skel", json.dumps(res))
    return res


def check_generator(model, conv_ops, in_ops):
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.uniform(-1, 1, (BATCH, N, N, N, 1)).astype(np.float32)).to(DEVICE)

    def run(kernels, dtype):
        model.set_use_kernels(kernels)
        model.dtype = dtype
        out = model(x)
        torch.cuda.synchronize()
        return out

    with torch.inference_mode():
        conv_ops.launches = in_ops.launches = 0
        k16 = run(True, torch.bfloat16)
        counts = (conv_ops.launches, in_ops.launches)
        require(counts == (CONV_PATH_CALLS, IN_PATH_CALLS),
                f"one gen_IS call launched conv/IN kernels {counts} times, "
                f"expected {(CONV_PATH_CALLS, IN_PATH_CALLS)}")
        require(k16.shape == (BATCH, N, N, N, 1) and bool(torch.isfinite(k16).all()),
                "generator output shape or finiteness")
        p16 = run(False, torch.bfloat16)
        k32 = run(True, torch.float32)
        ref = run(False, torch.float32)  # TF32 off: the f32 reference
        f32_max = float((k32 - ref).abs().max())
        # f32 sums in another order through 30 convs and 28 norms
        require(f32_max <= 1e-3, f"generator f32 kernel vs plain: max {f32_max:.3e}")
        res = {"f32_kernel_vs_plain_max": f32_max,
               **bf16_vs_reference(k16, p16, ref, "generator")}
        del k16, p16, k32, ref
        times = {"kernel": [], "plain": []}
        for _ in range(3):  # in turns, so drift hits both paths alike
            for path in ("kernel", "plain"):
                model.set_use_kernels(path == "kernel")
                model.dtype = torch.bfloat16
                times[path].append(cuda_ms(lambda: model(x), reps=1))
        model.set_use_kernels(True)
    res.update({"kernel_ms_per_batch": float(np.median(times["kernel"])),
                "plain_ms_per_batch": float(np.median(times["plain"])),
                "conv_launches_per_call": counts[0], "in_launches_per_call": counts[1]})
    print("generator", json.dumps(res))
    return res


def step_batch():
    """The seeded 3 x 128^3 batch of phases 6 and 8: real_I uniform in
    [-1, 1], real_S binary in {-1, 1}."""
    rng = np.random.default_rng(SEED + 4)
    shape = (STEP_BATCH, N, N, N, 1)
    real_I = torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)).to(DEVICE)
    seg = rng.uniform(size=shape) > 0.7
    real_S = torch.from_numpy(np.where(seg, 1.0, -1.0).astype(np.float32)).to(DEVICE)
    return shape, real_I, real_S


def check_test_step(conv_ops, in_ops, skel_ops):
    from vangan_torch.config import VanGanConfig
    from vangan_torch.vangan import VanGan

    cfg = VanGanConfig(SUBVOL_PATCH_SIZE=(N, N, N), BATCH_SIZE=STEP_BATCH,
                       cldice_iters=SKEL_ITERS)
    gan = VanGan(cfg, device=DEVICE)
    shape, real_I, real_S = step_batch()

    def run(kernels, dtype):
        gan.set_use_kernels(kernels)
        for net in gan.nets.values():
            net.dtype = dtype
        out = gan.distributed_test_step(real_I, real_S)
        torch.cuda.synchronize()
        return {k: float(v) for k, v in out.items()}

    conv_ops.launches = in_ops.launches = skel_ops.launches = 0
    k16 = run(True, torch.bfloat16)
    launches = {"conv3d_fwd": conv_ops.launches, "instnorm_fwd": in_ops.launches,
                "soft_skel_fwd": skel_ops.launches}
    want = {"conv3d_fwd": 4 * CONV_PATH_CALLS + 4 * DISC_CONV_CALLS,
            "instnorm_fwd": 4 * IN_PATH_CALLS + 4 * DISC_IN_CALLS,
            "soft_skel_fwd": 2 * (SKEL_ITERS + 1)}
    require(launches == want, f"one test step launched {launches}, expected {want}")
    require(len(k16) == 10 and all(math.isfinite(v) for v in k16.values()),
            f"test step losses not all finite: {k16}")
    p16 = run(False, torch.bfloat16)
    k32 = run(True, torch.float32)
    ref = run(False, torch.float32)  # TF32 off: the f32 reference
    losses = {}
    for key, r in ref.items():
        f32_rel = abs(k32[key] - r) / max(abs(r), 1e-30)
        require(f32_rel <= 1e-3, f"test step {key}: f32 kernel {k32[key]} vs plain {r}")
        bound = max(3 * abs(p16[key] - r), 1e-3 * abs(r))
        require(abs(k16[key] - r) <= bound,
                f"test step {key}: bf16 kernel {k16[key]}, bf16 plain {p16[key]}, f32 {r}")
        losses[key] = {"f32_plain": r, "f32_kernel_rel": f32_rel, "bf16_kernel": k16[key],
                       "bf16_plain": p16[key]}

    times, peak = {"kernel": [], "plain": []}, {}
    for path in ("plain", "kernel", "kernel", "plain", "plain", "kernel"):  # in turns
        gan.set_use_kernels(path == "kernel")
        for net in gan.nets.values():
            net.dtype = torch.bfloat16
        torch.cuda.reset_peak_memory_stats()
        times[path].append(cuda_ms(lambda: gan.distributed_test_step(real_I, real_S), reps=1))
        peak[path] = torch.cuda.max_memory_allocated() / 2**30
    gan.set_use_kernels(True)
    res = {"batch": list(shape), "launches": launches, "losses": losses,
           "kernel_ms_per_step": float(np.median(times["kernel"])),
           "plain_ms_per_step": float(np.median(times["plain"])),
           "kernel_ms_all": times["kernel"], "plain_ms_all": times["plain"],
           "kernel_peak_gib": peak["kernel"], "plain_peak_gib": peak["plain"]}
    print("test_step", json.dumps(res))
    return res


def check_predict(conv_ops, in_ops):
    from vangan_torch import cli
    from vangan_torch.config import VanGanConfig
    from vangan_torch.data.preprocess import read_tiff
    from vangan_torch.inference.stitcher import stitch_origins, stitch_subvolumes
    from vangan_torch.vangan import VanGan

    cfg = VanGanConfig(SUBVOL_PATCH_SIZE=(N, N, N), stitcher_batch=BATCH)
    with tempfile.TemporaryDirectory(prefix="vangan_smoke_") as tmp:
        in_dir, out_dir = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        os.makedirs(in_dir)
        rng = np.random.default_rng(SEED + 2)
        vol = rng.normal(100.0, 40.0, (VOLUME,) * 3 + (1,)).astype(np.float32)
        np.save(os.path.join(in_dir, "vol.npy"), vol)
        weights, cfg_path = os.path.join(tmp, "weights.pt"), os.path.join(tmp, "cfg.yaml")
        VanGan(cfg, device=DEVICE).save_weights(weights)
        cfg.to_yaml(cfg_path)

        pad = int(0.25 * VOLUME)
        origins = stitch_origins((VOLUME + 2 * pad,) * 3, cfg.SUBVOL_PATCH_SIZE, (STRIDE,) * 3)
        n_unique = len(set(origins))
        n_batches = -(-n_unique // cfg.stitcher_batch)

        conv_ops.launches = in_ops.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli.main(["predict", "--config", cfg_path, "--input", in_dir, "--output", out_dir,
                  "--weights", weights, "--stride", str(STRIDE), str(STRIDE), str(STRIDE),
                  "--device", DEVICE])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"conv3d_fwd": conv_ops.launches, "instnorm_fwd": in_ops.launches}

        out = read_tiff(os.path.join(out_dir, "VANGAN_vol.tiff"))
        require(out.shape == (VOLUME,) * 3 + (1,), f"TIFF shape {out.shape}")
        require(bool(np.isfinite(out).all()), "TIFF has non-finite voxels")
        require(out.min() >= 0.0 and out.max() <= 255.0, "TIFF outside [0, 255]")
        require(launches == {"conv3d_fwd": CONV_PATH_CALLS * n_batches,
                             "instnorm_fwd": IN_PATH_CALLS * n_batches},
                f"predict launches {launches}, expected {n_batches} gen_IS batches")

        gan = VanGan(cfg, device=DEVICE)
        gan.load_weights(weights)
        gan.gen_IS.set_use_kernels(False)
        plain = {}
        for dtype in (torch.bfloat16, torch.float32):
            gan.gen_IS.dtype = dtype
            plain[dtype] = torch.from_numpy(stitch_subvolumes(
                gan.gen_IS_batched, vol, cfg.subvol_size, stride=(STRIDE,) * 3,
                complete=True, padFactor=0.25, save=False, batch_size=cfg.stitcher_batch,
                device=DEVICE))
        close = bf16_vs_reference(torch.from_numpy(np.transpose(out, (1, 2, 0, 3))),
                                  plain[torch.bfloat16], plain[torch.float32], "predict")
    res = {"volume": [VOLUME] * 3, "patches": len(origins), "unique_patches": n_unique,
           "batches": n_batches, "seconds": seconds,
           "mvox_per_s": VOLUME ** 3 / seconds / 1e6, "launches": launches,
           "grey_levels": close}
    print("predict", json.dumps(res))
    return res


# f32 gradients, kernel path vs plain path (relative L2 per network): the
# random-init generators' f32 gradient moves at the 1e-3 level under
# last-bit differences of the forward (their norms and ReLUs, the skeleton's
# min/max routing and the min-max normalisation are not smooth), so each
# network is held to SPREAD_FACTOR x the plain path's own spread when every
# weight moves by 1e-6 relative, measured in the same run (1.5e-3, 3.7e-3,
# 3.7e-4 and 7.8e-4 for gen_IS, gen_SI, disc_I, disc_S on the H100).
SPREAD_FACTOR = 3


def counters(ops):
    conv_ops, in_ops, skel_ops = ops
    return {"conv3d_fwd": conv_ops.launches, "conv3d_dgrad": conv_ops.dgrad_launches,
            "conv3d_wgrad": conv_ops.wgrad_launches, "instnorm_fwd": in_ops.launches,
            "instnorm_bwd": in_ops.bwd_launches, "soft_skel_fwd": skel_ops.launches,
            "soft_skel_bwd": skel_ops.bwd_launches}


def reset_counters(ops):
    conv_ops, in_ops, skel_ops = ops
    conv_ops.launches = conv_ops.dgrad_launches = conv_ops.wgrad_launches = 0
    in_ops.launches = in_ops.bwd_launches = 0
    skel_ops.launches = skel_ops.bwd_launches = 0


def check_train_step(ops):
    import copy

    from vangan_torch.config import VanGanConfig
    from vangan_torch.training import step
    from vangan_torch.training.state import NETWORKS, make_train_state
    from vangan_torch.vangan import VanGan

    cfg = VanGanConfig(SUBVOL_PATCH_SIZE=(N, N, N), BATCH_SIZE=STEP_BATCH,
                       cldice_iters=SKEL_ITERS)
    gan = VanGan(cfg, device=DEVICE)
    init = {name: copy.deepcopy(net.state_dict()) for name, net in gan.nets.items()}
    shape, real_I, real_S = step_batch()

    def reset(kernels, dtype):
        """Seeded weights, fresh optimizers, the same noise draws."""
        for name, net in gan.nets.items():
            net.load_state_dict(init[name])
            net.dtype = dtype
        gan.set_use_kernels(kernels)
        gan.state = make_train_state(gan.nets, cfg, gan.steps_per_epoch)
        gan.generator.manual_seed(SEED + 5)

    # the main path: one bf16 step on the kernels
    reset(True, torch.bfloat16)
    torch.cuda.synchronize()
    reset_counters(ops)
    out = gan.distributed_train_step(real_I, real_S, NOISE, True)
    torch.cuda.synchronize()
    launches = counters(ops)
    require(launches == TRAIN_LAUNCHES, f"one train step launched {launches}, "
            f"expected {TRAIN_LAUNCHES}")
    step_losses = {k: float(v) for k, v in out.items()}
    require(len(step_losses) == 10 and all(math.isfinite(v) for v in step_losses.values()),
            f"train step losses not all finite: {step_losses}")
    for name, net in gan.nets.items():
        params = list(net.parameters())
        require(all(bool(torch.isfinite(p).all()) for p in params),
                f"{name}: non-finite parameters after the step")
        moved = sum(not torch.equal(p.detach(), init[name][k].to(p.device))
                    for (k, _), p in zip(net.named_parameters(), params))
        require(moved > 0, f"{name}: no parameter changed in the step")

    def grads_of(kernels, dtype, n):
        """Gradients (flat f32 per network) and losses of the first ``n``
        samples, from the seeded weights and noise draws."""
        reset(kernels, dtype)
        g, res = step.compute_grads(gan.nets, cfg, gan.scales, real_I[:n], real_S[:n], NOISE,
                                    gan.generator)
        return ({name: torch.cat([t.float().flatten() for t in g[name]]) for name in NETWORKS},
                {k: float(v) for k, v in res.items()})

    # gradients of both paths from the same weights and noise draws: in f32
    # and bf16 on the batch's first sample (the f32 plain path, with f32
    # activations and the plain norms' f32 intermediates of ten network
    # applications, needs over 80 GB at batch 3; the bf16 plain step peaks
    # at 68 GiB), and in bf16 on the whole batch, where K3 and K5 sum over
    # the samples
    f32, bf16 = torch.float32, torch.bfloat16
    grads, losses = {}, {}
    for kernels, dtype, n in ((True, f32, 1), (False, f32, 1), (True, bf16, 1),
                              (False, bf16, 1), (True, bf16, STEP_BATCH),
                              (False, bf16, STEP_BATCH)):
        grads[kernels, dtype, n], losses[kernels, dtype, n] = grads_of(kernels, dtype, n)
    # the plain f32 gradient's own spread: the same step with every weight
    # scaled by (1 + 1e-6 N(0, 1)), below the f32 kernel-vs-plain forward
    # difference (phase 5: up to 4e-5 on tanh outputs)
    reset(False, f32)
    with torch.no_grad():
        pg = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
        for net in gan.nets.values():
            for prm in net.parameters():
                prm.mul_(1 + 1e-6 * torch.randn(prm.shape, device=DEVICE, generator=pg))
    g, _ = step.compute_grads(gan.nets, cfg, gan.scales, real_I[:1], real_S[:1], NOISE,
                              gan.generator)
    perturbed = {n: torch.cat([t.float().flatten() for t in g[n]]) for n in NETWORKS}
    del g
    rel = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
    rel_loss = lambda a, b: abs(a - b) / max(abs(b), 1e-30)  # noqa: E731
    one, full = 1, STEP_BATCH
    report = {"losses": {}, "grads": {}}
    for key, r in losses[False, f32, one].items():
        k16_3, p16_3 = losses[True, bf16, full][key], losses[False, bf16, full][key]
        report["losses"][key] = {
            "f32_plain": r, "f32_kernel": losses[True, f32, one][key],
            "bf16_kernel": losses[True, bf16, one][key],
            "bf16_plain": losses[False, bf16, one][key],
            "f32_rel": rel_loss(losses[True, f32, one][key], r),
            "bf16_kernel_vs_plain": rel_loss(losses[True, bf16, one][key],
                                             losses[False, bf16, one][key]),
            "batch3_bf16_kernel": k16_3, "batch3_bf16_plain": p16_3,
            "batch3_bf16_kernel_vs_plain": rel_loss(k16_3, p16_3)}
    for n in NETWORKS:
        ref = grads[False, f32, one][n]
        p16_3 = grads[False, bf16, full][n]
        report["grads"][n] = {
            "f32_kernel_vs_plain": rel(grads[True, f32, one][n], ref),
            "f32_plain_perturbed_vs_plain": rel(perturbed[n], ref),
            "bf16_kernel_vs_f32": rel(grads[True, bf16, one][n], ref),
            "bf16_plain_vs_f32": rel(grads[False, bf16, one][n], ref),
            "bf16_kernel_vs_plain": rel(grads[True, bf16, one][n], grads[False, bf16, one][n]),
            "batch3_bf16_kernel_vs_plain": rel(grads[True, bf16, full][n], p16_3),
            # what a fault that drops two samples' share would read
            "control_batch1_vs_batch3_plain": rel(grads[False, bf16, one][n], p16_3)}
    del grads
    print("train_step_agreement", json.dumps(report))
    for key, v in report["losses"].items():
        require(v["f32_rel"] <= 1e-3, f"train step {key}: f32 kernel {v['f32_kernel']} vs "
                f"plain {v['f32_plain']}")
        # at batch 3 no f32 reference fits: the bf16 paths may differ there
        # by 3x what they differ by on one sample
        require(v["batch3_bf16_kernel_vs_plain"] <= max(3 * v["bf16_kernel_vs_plain"], 1e-3),
                f"train step {key} at batch {STEP_BATCH}: bf16 kernel vs plain: {v}")
    for n, v in report["grads"].items():
        require(v["f32_kernel_vs_plain"] <= SPREAD_FACTOR * v["f32_plain_perturbed_vs_plain"],
                f"{n}: f32 kernel gradient {v['f32_kernel_vs_plain']:.3e} from plain, the "
                f"plain path's spread {v['f32_plain_perturbed_vs_plain']:.3e}")
        require(v["bf16_kernel_vs_f32"] <= max(3 * v["bf16_plain_vs_f32"], 1e-3),
                f"{n}: bf16 kernel gradient too far from f32: {v}")
        require(v["batch3_bf16_kernel_vs_plain"] <= max(3 * v["bf16_kernel_vs_plain"], 1e-3),
                f"{n}: bf16 kernel gradient at batch {STEP_BATCH} too far from plain: {v}")

    # ms per step of both paths in turns, after a warm-up step of each
    times, peak = {"kernel": [], "plain": []}, {"kernel": 0.0, "plain": 0.0}
    for path in ("kernel", "plain"):
        reset(path == "kernel", bf16)
        gan.distributed_train_step(real_I, real_S, NOISE, True)
    for path in ("plain", "kernel", "kernel", "plain", "plain", "kernel"):
        gan.set_use_kernels(path == "kernel")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        gan.distributed_train_step(real_I, real_S, NOISE, True)
        b.record()
        b.synchronize()
        times[path].append(a.elapsed_time(b))
        peak[path] = max(peak[path], torch.cuda.max_memory_allocated() / 2**30)
    gan.set_use_kernels(True)
    res = {"batch": list(shape), "noise_std": NOISE, "launches": launches,
           "losses": step_losses,
           "kernel_ms_per_step": float(np.median(times["kernel"])),
           "plain_ms_per_step": float(np.median(times["plain"])),
           "kernel_ms_all": times["kernel"], "plain_ms_all": times["plain"],
           "kernel_peak_gib": peak["kernel"], "plain_peak_gib": peak["plain"]}
    print("train_step", json.dumps(res))
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])

    from vangan_torch.config import VanGanConfig
    from vangan_torch.models.factory import build_discriminator, build_generator
    from vangan_torch.ops import build
    from vangan_torch.ops import conv3d as conv_ops
    from vangan_torch.ops import instnorm as in_ops
    from vangan_torch.ops import skeleton as skel_ops

    t0 = time.perf_counter()
    build.build(verbose=True)
    build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {build.library_path()}")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    g = torch.Generator().manual_seed(SEED)
    model = build_generator("resUnet", VanGanConfig(), generator=g).to(DEVICE).eval()
    disc = build_discriminator(VanGanConfig(), generator=g).to(DEVICE).eval()
    shapes, disc_shapes = path_shapes(model), path_shapes(disc)
    conv_rows = check_convs("gen_IS", shapes, CONV_PATH_CALLS, tol)
    conv_rows += check_convs("disc_I", disc_shapes, DISC_CONV_CALLS, tol)
    in_rows = check_instnorms("gen_IS", shapes, IN_PATH_CALLS, tol)
    in_rows += check_instnorms("disc_I", disc_shapes, DISC_IN_CALLS, tol)
    del disc
    skel = check_skeleton(skel_ops)
    check_generator(model, conv_ops, in_ops)
    del model
    torch.cuda.empty_cache()
    check_test_step(conv_ops, in_ops, skel_ops)
    torch.cuda.empty_cache()
    check_predict(conv_ops, in_ops)
    torch.cuda.empty_cache()
    train = check_train_step((conv_ops, in_ops, skel_ops))

    require("jax" not in sys.modules and "vangan_tpu" not in sys.modules,
            "the port imported JAX or the JAX package")

    def summed_bound(parts):
        """The bounds of a sequence of calls, (count, (ms, kind)), added up
        and named by the kind that bounds most of the sum."""
        by = {"operations": 0.0, "bytes": 0.0}
        for count, (ms, kind) in parts:
            by[kind] += count * ms
        return {"bound_ms": sum(by.values()), "bound_by": max(by, key=by.get)}

    def conv_entry(name, op, source, replaces):
        """Sums over one gen_IS and one disc_I call at batch 3, bf16."""
        total = lambda key: sum(len(r["convs"]) * r[key] for r in conv_rows)  # noqa: E731
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": train["launches"][name],
                "max_abs_err": max(r[f"{op}_bf16_abs_err"] for r in conv_rows),
                "ms": total(f"{op}_bf16_ms"), "plain_ms": total(f"{op}_bf16_plain_ms"),
                **summed_bound([(len(r["convs"]), r["bound"][op]) for r in conv_rows]),
                "library_ms": total(f"{op}_bf16_library_ms")}

    def in_entry(name, op, replaces):
        total = lambda key: sum(len(r["uses"]) * r[key] for r in in_rows)  # noqa: E731
        errs_ = [r[f"{op}_bf16_abs_err"] for r in in_rows] if op == "fwd" else [
            r[f"bwd_{part}_bf16_abs_err"] for r in in_rows for part in ("dx", "dgamma", "dbeta")]
        entry = {"name": name, "route": "cuda",
                 "source": f"vangan_torch/ops/csrc/instnorm_{op}.cu", "replaces": replaces,
                 "launches": train["launches"][name], "max_abs_err": max(errs_),
                 "ms": total(f"{op}_bf16_ms"), "plain_ms": total(f"{op}_bf16_plain_ms"),
                 **summed_bound([(len(r["uses"]), r["bound"][op]) for r in in_rows]),
                 "library_ms": None}
        if op == "fwd":  # F.instance_norm has no activation: the act='none' norms only
            none = [r for r in in_rows if r["act"] == "none"]
            entry["ms_act_none"] = sum(len(r["uses"]) * r["fwd_bf16_ms"] for r in none)
            entry["library_ms_act_none"] = sum(len(r["uses"]) * r["fwd_bf16_library_ms"]
                                               for r in none)
        return entry

    kernels = [
        conv_entry("conv3d_fwd", "fwd", "vangan_torch/ops/csrc/conv3d_fwd.cu",
                   "vangan_tpu/ops/pallas/conv3d.py:577"),
        conv_entry("conv3d_dgrad", "dgrad", "vangan_torch/ops/conv3d.py",
                   "vangan_tpu/ops/pallas/conv3d.py:904"),
        conv_entry("conv3d_wgrad", "wgrad", "vangan_torch/ops/csrc/conv3d_wgrad.cu",
                   "vangan_tpu/ops/pallas/conv3d.py:817"),
        in_entry("instnorm_fwd", "fwd", "vangan_tpu/ops/pallas/instnorm.py:309"),
        in_entry("instnorm_bwd", "bwd", "vangan_tpu/ops/pallas/instnorm.py:379"),
        {"name": "soft_skel_fwd", "route": "cuda",
         "source": "vangan_torch/ops/csrc/skeleton_fwd.cu",
         "replaces": "vangan_tpu/ops/pallas/skeleton.py:185",
         "launches": train["launches"]["soft_skel_fwd"],
         "max_abs_err": max(skel["tanh_noise_max_abs_err"], skel["binary_faces_max_abs_err"]),
         "ms": skel["tanh_noise_ms"], "plain_ms": skel["tanh_noise_plain_ms"],
         "bound_ms": skel["fwd_bound"][0], "bound_by": skel["fwd_bound"][1],
         "library_ms": None},
        {"name": "soft_skel_bwd", "route": "cuda",
         "source": "vangan_torch/ops/csrc/skeleton_bwd.cu",
         "replaces": "vangan_tpu/ops/pallas/skeleton.py:274",
         "launches": train["launches"]["soft_skel_bwd"],
         "max_abs_err": skel["bwd_max_abs_err"], "ms": skel["bwd_ms"],
         "plain_ms": skel["bwd_plain_ms"], "bound_ms": skel["bwd_bound"][0],
         "bound_by": skel["bwd_bound"][1], "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
