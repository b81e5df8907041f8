#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vangan_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

0. the card (nvidia-smi name and power limit); CUDA must be available;
1. build the CUDA kernels from vangan_torch/ops/csrc with nvcc (sm_90a);
2. the conv3d kernels against their plain versions at every conv shape the
   full-width gen_IS (17 kernel convs) and disc_I (1: conv0) give them at
   128^3, at the step's batch of 3: the forward (K1) against F.conv3d, the input gradient (K2,
   one launch for every stride parity, and a fold launch for a reflect pad)
   against torch.nn.grad.conv3d_input and the weight gradient (K3) against
   torch.nn.grad.conv3d_weight, in
   float32 (TF32 off; y and dx within 1e-4 * max |ref|, dW within 1e-3, its
   sums run over up to 2 M voxels in another order) and bfloat16 (2e-2),
   with CUDA event times (median of 5) of the kernel, the plain version and
   the library call; each row names the bf16 plan (``conv_plan``: the
   route, tensor-core or thin CUDA-core body, and the Co tile, split and
   workspace) of K1, K2 (its Ci tile, parities in launch order, fold planes
   and launches) and K3, and the achieved TFLOP/s (FLOPs / kernel ms) of the
   kernel and the library call; the bf16 K3 must give bit-identical dW in two
   runs, on either route (split-K slices summed in a fixed order); a shape that
   takes the thin body is also run and timed on the
   tensor-core body, the evidence for that choice;
3. the InstanceNorm kernels against their plain versions at every (C, size)
   of the two networks (28 and 4 norms), batch 3, for each activation: the
   forward (K4, one kernel launch per call on the route of ``fwd_plan``:
   small, a cluster of up to 16 blocks, or stream) and the backward (K5:
   dx, dgamma, dbeta against autograd of instance_norm_act_plain), with the
   same tolerances and timing; each row names K4's and K5's plans
   (``fwd_plan``, ``bwd_plan``), the bf16 K4 must give bit-identical y and
   stats and the bf16 K5 bit-identical sums and dx in two runs, K4's kernel
   launches (as its C entry counts them) must be one per call, and the
   act='none' rows time aten.native_batch_norm_backward on the same inputs
   as K5's yardstick;
4. the soft-skeleton kernels against their plain version (morphology) at the
   step's shape, 3 x 128^3, 15 iterations: the forward (K6) on the min-max
   normalised tanh of seeded noise and on a binary volume touching every
   face, bit-exact (max |diff| == 0); the backward (K7) on seeded continuous
   data with distinct values against autograd of morphology.soft_skel, max
   |diff| <= 1e-5 * max |g|, with one kernel launch per round, and on both
   inputs against its gather in torch (``skeleton.round_bwd_plain``) round by
   round, max |diff| == 0; CUDA event times (median of 5);
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
   dropout on, bf16): one step must call every kernel an exact count (see
   ``TRAIN_LAUNCHES``) and launch K4 and K7 an exact count of kernels, as
   their C entries count them (``TRAIN_KERNEL_LAUNCHES``), give ten finite
   losses, and leave every parameter tensor of every network finite and
   changed; from the same weights and noise seed, on
   the batch's first sample (the f32 plain path does not fit in 80 GB at
   batch 3): in f32 each loss of the kernel path within 1e-3 relative of the
   plain path's and each network's flat gradient within 3x the plain path's
   own spread under a 1e-6 weight perturbation (relative L2, see
   ``SPREAD_FACTOR``), in bf16 each network's gradient no further from the
   f32 plain gradient than max(3 x the bf16 plain path's distance, 1e-3);
   on the whole batch in bf16, each loss and each network's gradient of the
   kernel path within max(3x the two bf16 paths' distance on one sample,
   1e-3) of the plain path's, and each gradient closer to it than the plain
   path's one-sample gradient is (what a step that dropped samples would
   read); ms per step of both paths in turns after a warm-up step, and peak
   device memory;
9. the training CLI: a seeded dataset at the config's volume size (512 x 512
   x 128 x 1 float32; imaging volumes of uniform noise, segmentation volumes
   of +-1 random tubes in the half x < 256, so a third of the crops must be
   re-cropped; 2 training and 1 validation volume per domain, the validation
   volumes also the test set; JAX-layout partition pickles) in a temporary
   directory; the host feed alone (``VanGanDataset``, pinned batches) in
   batches/s at DATA_WORKERS 1 and 4; ``python -m vangan_torch train``
   (through cli.main) at full width with EPOCHS 2, 3 train steps and 1
   validation step an epoch, PERIOD_2D_CALLBACK 2 and ``--predict-after``:
   every kernel counter over the run must equal 6 x ``TRAIN_LAUNCHES`` + 2 x
   phase 6's test-step launches + 17 convs and 28 norms for each generator
   call of the panels (6) and of the predict-after batches; the event files
   must parse back (CRCs checked) to the ten finite losses of each epoch and
   split, and ``elapse``; ``torch_e2.pt`` must hold the four networks, four
   Adam states, counts of 6 and step 6; the two panels and the two
   predict-after TIFFs (finite, in [0, 255]) must exist; ``train
   --resume-epoch 2`` with EPOCHS 3 must continue the counts to 9; and, at
   the ``VanGan`` level on phase 6's batch, 2 steps, a checkpoint, a fresh
   ``VanGan`` loading it (the noise generator's state copied across) and 2
   more steps must give each network's parameters bit-identical to 4
   straight steps when two straight runs are bit-identical, else within 3x
   their relative L2 distance (cuDNN's wide-conv weight gradient may not be
   deterministic). The ``train_cli`` line has the feed's batches/s, the fit's
   wall time per train step against phase 8's bare step, the checkpoint's
   snapshot ms, background write s and bytes, and predict-after Mvox/s.

10. BASELINE config 4 (``gen_i2s = gen_s2i = "vnet"``: the i2s V-Net with
   32 filters and InstanceNorm, the s2i V-Net with 16, BatchNorm and
   deconvs; config 2's PatchGANs), at full width: phase 8's checks on its
   train step (3 x 128^3 bf16, noise sigma 0.1, dropout on; the counts of
   ``C4_TRAIN_LAUNCHES``; every BatchNorm running statistic must also stay
   finite and move), and its f32 checks again on the whole batch cropped to
   96^3 (``C4_F32_CROP``), phase 6's on its
   test step (``C4_TEST_LAUNCHES``; the bf16 losses against the plain
   path's largest distance from f32 over three runs, see
   ``check_test_step``), phases 2-3's on every kernel conv and
   norm shape of the two V-Nets (9 and 12 kernel convs, 18 and 0 norms a
   call), ``F.max_pool3d``'s tied-window gradient on the card equal to the
   CPU's (first element in X, Y, Z order, as ``reduce_window``), phase 9's
   exact resume (parameters and running statistics), and phase 7's
   ``predict`` with a V-Net gen_IS;
11. the other generators, each alone at full width, batch 1, 128^3, in
   training, bf16 forward and backward: the ResU-Net with deconv and with
   the attention gate, and the ResNet generator; kernel counts
   exact (derived from the call: each kernel conv once forward and once for
   its weight gradient, once for its input gradient where the input needs
   one, with a fold for a reflect pad, each norm once each way), outputs by
   phase 5's rules, gradients by phase 8's, ms of both paths; and phase 2's
   checks and times at the ResNet's 4 kernel conv shapes (its 343-tap stem
   and head on the CUDA-core bodies; the ResNet is one generator whatever the
   role, as in the JAX factory, so it runs once).

Then one JSON line of the seven kernels (launches counted in one train step
of phase 8, the path that runs them all, and of phase 10 as
``config4_launches``, and for K4 and K7 the kernel launches beside the
calls; ms, plain ms, library ms and the bound summed over the convs / norms
of one gen_IS and one disc_I call at batch 3 (phases 2-3), one 3 x 128^3
skeleton for soft_skel) and, last, the ok line. Without CUDA, or outside
the repository, it exits non-zero before printing either.
"""

import dataclasses
import json
import math
import os
import pickle
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
# - K2, one launch per conv whose input needs a gradient: per generator call
#   the 15 kernel convs but stem.conv1 and stem.shortcut (they read data or a
#   detached fake): stem.conv_block, enc1 and enc2 3 each (block1, block2,
#   shortcut), dec2.block2, dec1 and dec0 3 each, head; and conv0 of the 2
#   generator-branch judgements, whose input is the fake; plus one fold
#   launch for each of them with a reflect pad: per generator call the 10
#   block convs (all but the 4 shortcuts and the head), and conv0;
# - one K5 call per norm; 16 K7 rounds for the prediction's skeleton (the
#   ground truth's takes no gradient).
TRAIN_LAUNCHES = {
    "conv3d_fwd": 4 * CONV_PATH_CALLS + 6 * DISC_CONV_CALLS,
    "conv3d_dgrad": 4 * 15 + 2 * 1,
    "conv3d_dgrad_fold": 4 * 10 + 2 * 1,
    "conv3d_wgrad": 4 * CONV_PATH_CALLS + 4 * DISC_CONV_CALLS,
    "instnorm_fwd": 4 * IN_PATH_CALLS + 6 * DISC_IN_CALLS,
    "instnorm_bwd": 4 * IN_PATH_CALLS + 6 * DISC_IN_CALLS,
    "soft_skel_fwd": 2 * (SKEL_ITERS + 1),
    "soft_skel_bwd": SKEL_ITERS + 1,
}
# kernel launches of one train step, as the C entries of K4 and K7 count
# them: K4 one per call, K7 one per round
TRAIN_KERNEL_LAUNCHES = {"instnorm_fwd": TRAIN_LAUNCHES["instnorm_fwd"],
                         "soft_skel_bwd": TRAIN_LAUNCHES["soft_skel_bwd"]}
# one test step (phase 6): 4 generator and 4 discriminator calls, 2 skeletons
TEST_LAUNCHES = {"conv3d_fwd": 4 * CONV_PATH_CALLS + 4 * DISC_CONV_CALLS,
                 "instnorm_fwd": 4 * IN_PATH_CALLS + 4 * DISC_IN_CALLS,
                 "soft_skel_fwd": 2 * (SKEL_ITERS + 1)}
# phase 10: BASELINE config 4, V-Net generators (gen_filters 16), derived
# from the path. The i2s V-Net (32 filters, InstanceNorm, nearest upsample +
# 3^3 zero-padded 'same' conv) has 9 kernel convs a call: down0 and down1
# x2, up2.conv1, upconv3, up3 x2 and head (the rest have >= 128 channels),
# and 18 InstanceNorms (2 in each of 9 blocks). The s2i V-Net (16 filters,
# BatchNorm, deconvs) has 12: down0-down2 x2, up1.conv1, up2 x2, up3 x2 and
# head; no InstanceNorm. In one train step each generator runs twice and
# each discriminator three times, as in phase 8:
# - K2 for every kernel conv but each generator's down0.conv0, which reads
#   data or a detached fake (8 and 11 a call), and the 2 generator-branch
#   conv0s; a fold launch for those with a reflect pad: all block convs (6
#   and 10 a call; upconv3 pads with zeros, head is 1^3) and conv0;
# - K3 for every kernel conv of the generators and of the 4 discriminator
#   calls with live parameters;
# - K4 and K5 once per norm; K6 and K7 as in phase 8.
C4_IS_CONVS, C4_IS_INS, C4_SI_CONVS = 9, 18, 12
C4_TRAIN_LAUNCHES = {
    "conv3d_fwd": 2 * C4_IS_CONVS + 2 * C4_SI_CONVS + 6 * DISC_CONV_CALLS,
    "conv3d_dgrad": 2 * 8 + 2 * 11 + 2 * 1,
    "conv3d_dgrad_fold": 2 * 6 + 2 * 10 + 2 * 1,
    "conv3d_wgrad": 2 * C4_IS_CONVS + 2 * C4_SI_CONVS + 4 * DISC_CONV_CALLS,
    "instnorm_fwd": 2 * C4_IS_INS + 6 * DISC_IN_CALLS,
    "instnorm_bwd": 2 * C4_IS_INS + 6 * DISC_IN_CALLS,
    "soft_skel_fwd": 2 * (SKEL_ITERS + 1),
    "soft_skel_bwd": SKEL_ITERS + 1,
}
C4_TRAIN_KERNEL_LAUNCHES = {"instnorm_fwd": C4_TRAIN_LAUNCHES["instnorm_fwd"],
                            "soft_skel_bwd": C4_TRAIN_LAUNCHES["soft_skel_bwd"]}
C4_TEST_LAUNCHES = {"conv3d_fwd": 2 * C4_IS_CONVS + 2 * C4_SI_CONVS + 4 * DISC_CONV_CALLS,
                    "instnorm_fwd": 2 * C4_IS_INS + 4 * DISC_IN_CALLS,
                    "soft_skel_fwd": 2 * (SKEL_ITERS + 1)}
C4 = {"gen_i2s": "vnet", "gen_s2i": "vnet"}
# its f32 checks on the whole batch, cropped to 96^3 (the V-Net halves 4
# times): the bf16 i2s V-Net's gradient is no closer to f32 than 1.2-1.3
# relative L2 on either path, so its bf16 rules hold nothing at batch 3
C4_F32_CROP = 96
# phase 11: the ResNet generator's kernel convs (stem_conv, down0, up2, head)
RESNET_CONVS = 4
# phase 9: the training CLI
VOLUME_SHAPE = (512, 512, 128, 1)  # TARG_RAW_IMG_SIZE and TARG_SYNTH_IMG_SIZE
TUBES = 120            # segmentation tubes a volume (a few % foreground)
TRAIN_STEPS, VAL_STEPS = 3, 1
PREDICT_STRIDE = 25    # the stride of train --predict-after
PANEL_GEN_CALLS = 6    # a saving epoch's panels: 2 x (translated, cycled, identity)
FEED_BATCHES = 8       # batches timed of the host feed alone


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


def skel_fwd_bound(n_vox):
    """(ms, "operations" or "bytes"): the least time for one skeleton of
    ``n_vox`` voxels, forward; per voxel and round 19 + 27 compares and a few
    adds, the input read and the output written once, f32."""
    return bound(50 * (SKEL_ITERS + 1) * n_vox, 8 * n_vox, F32_OP_PER_S)


def skel_fwd_floor_ms(n_vox, keep):
    """The least ms of K6's design (one launch a round) for one skeleton of
    ``n_vox`` voxels: the f32 volumes it must move at the memory rate. Read:
    img every round, skel after round 0; written: skel every round, e every
    round with the residuals kept (``keep``), else in all but the last."""
    rounds = SKEL_ITERS + 1
    volumes = 2 * rounds - 1 + (2 * rounds if keep else 2 * rounds - 1)
    return volumes * 4 * n_vox / HBM_BYTES_PER_S * 1e3


def conv_work(co, ci, k, out_dims, in_dims, batch, esize=2):
    """(FLOPs, bytes of x, w, y) of one conv."""
    taps, n_out = math.prod(k), batch * math.prod(out_dims)
    return (2 * co * ci * taps * n_out,
            esize * (ci * batch * math.prod(in_dims) + co * ci * taps + co * n_out))


def plans(ci, co, k, stride, pads, pad_mode, dims, out_dims):
    """The bf16 plans (route and tiles) of K1, K2 and K3 of a conv."""
    from vangan_torch.ops import conv3d as C

    keys = ("route", "co_tile", "co_tiles", "tap_warps", "tap_groups", "split",
            "workspace_bytes", "pad_share", "shared_halo")
    brief = lambda p: {k_: getattr(p, k_) for k_ in keys}  # noqa: E731
    bf16 = torch.bfloat16
    dg = C.conv_plan("dgrad", ci, co, k, stride, out_dims, bf16, STEP_BATCH, in_dims=dims,
                     pads=pads, pad_mode=pad_mode)
    return {"brick": list(C.BRICK), "ci_chunk": C.CI_CHUNK,
            "fwd": brief(C.conv_plan("fwd", ci, co, k, stride, out_dims, bf16, STEP_BATCH)),
            "dgrad": dict(brief(dg), ci_tile=dg.co_tile, launches=dg.launches,
                          parities=[[list(p), list(e)] for p, e, _ in dg.parities],
                          fold=[list(f) for f in dg.fold], fold_bytes=dg.fold_bytes),
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
                        # both routes sum split-K in a fixed order: the same
                        # bits every run
                        same = torch.equal(got, kern())
                        require(same, f"conv wgrad {names}: dW differs between two runs on "
                                "the same inputs")
                        row["wgrad_bf16_bit_identical"] = same
                    row[f"{op}_{tag}_ms"] = cuda_ms(kern)
                    row[f"{op}_{tag}_plain_ms"] = cuda_ms(plain)
                    row[f"{op}_{tag}_library_ms"] = cuda_ms(library)
                    row[f"{op}_{tag}_tflops"] = flops / row[f"{op}_{tag}_ms"] / 1e9
                    row[f"{op}_{tag}_library_tflops"] = flops / row[f"{op}_{tag}_library_ms"] / 1e9
                row["plan"] = plans(ci, co, m.kernel_size, stride, pads, pad_mode, dims, out_dims)
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
                    kernels0 = I.fwd_kernel_launches
                    got, want = kern(), plain()
                    torch.cuda.synchronize()
                    # the plans the wrappers run: planes 16-byte aligned or not
                    aligned = math.prod(dims) * x.element_size() % 16 == 0
                    plan_f = I.fwd_plan(math.prod(dims), dtype, aligned)
                    row[f"fwd_{tag}_plan"] = dict(vars(plan_f))
                    row[f"fwd_{tag}_kernel_launches"] = I.fwd_kernel_launches - kernels0
                    require(row[f"fwd_{tag}_kernel_launches"] == plan_f.launches == 1,
                            f"IN C={c} {dims} {dtype}: {row[f'fwd_{tag}_kernel_launches']} "
                            "kernel launches in one forward call")
                    abs_err, rel = errs(got, want)
                    require(rel <= tol[dtype], f"IN C={c} {dims} {act} {dtype}: "
                            f"rel err {rel:.3e}")
                    row[f"fwd_{tag}_abs_err"], row[f"fwd_{tag}_rel_err"] = abs_err, rel
                    if dtype == torch.bfloat16:
                        # the cluster's partials merge in rank order: the same bits every run
                        y1, s1 = I._instance_norm_act_cuda(x, gamma, beta, 1e-3, act, 0.2)
                        y2, s2 = I._instance_norm_act_cuda(x, gamma, beta, 1e-3, act, 0.2)
                        require(torch.equal(y1, y2) and torch.equal(s1, s2) and
                                torch.equal(y1, got), f"IN C={c} {dims} {act}: the forward "
                                "differs between two runs")
                        row["fwd_bf16_bit_identical"] = True
                    row[f"fwd_{tag}_ms"], row[f"fwd_{tag}_plain_ms"] = cuda_ms(kern), cuda_ms(plain)
                    row[f"fwd_{tag}_library_ms"] = cuda_ms(
                        lambda: F.instance_norm(x, weight=gamma.to(dtype),
                                                bias=beta.to(dtype), eps=1e-3))
                    _, stats = I._instance_norm_act_cuda(x, gamma, beta, 1e-3, act, 0.2)
                    kern_b = lambda: I._instance_norm_act_bwd_cuda(x, gy, stats, act, 0.2)  # noqa: E731
                    plain_b = lambda: I.instance_norm_act_bwd_plain(x, gy, gamma, beta, 1e-3,  # noqa: E731
                                                                    act)
                    got_b = kern_b()
                    plan_b = I.bwd_plan(math.prod(dims), dtype, aligned)
                    row[f"bwd_{tag}_plan"] = dict(vars(plan_b))
                    if dtype == torch.bfloat16:
                        # the partial sums are added in a fixed order: the same bits every run
                        again = kern_b()
                        require(all(torch.equal(a_, b_) for a_, b_ in zip(got_b, again)),
                                f"IN backward C={c} {dims} {act}: differs between two runs")
                        row["bwd_bf16_bit_identical"] = True
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
                    if act == "none":
                        # yardstick only (the port never calls it): the act-none
                        # backward as one batch-norm backward over (1, B*C, ...)
                        # with the forward's mean and inverse std
                        ab = stats.view(-1, 4)
                        xv = x.reshape(1, STEP_BATCH * c, *dims)
                        gv = gy.reshape(1, STEP_BATCH * c, *dims)
                        wv = gamma.float().repeat(STEP_BATCH)
                        lib = lambda: torch.ops.aten.native_batch_norm_backward(  # noqa: E731
                            gv, xv, wv, None, None, ab[:, 0].contiguous(),
                            ab[:, 3].contiguous(), True, 1e-3, [True, True, True])
                        lib_dx = lib()[0].reshape(x.shape)
                        row[f"bwd_{tag}_library_dx_rel_err"] = errs(lib_dx, got_b[0])[1]
                        row[f"bwd_{tag}_library_ms"] = cuda_ms(lib)
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
    # backward, per voxel and round: twice the forward's compares and the
    # gathers; the input, output and cotangent read or written once, f32
    res = {"shape": list(shape), "iters": SKEL_ITERS, "fwd_bound": skel_fwd_bound(n_vox),
           "fwd_floor_ms": skel_fwd_floor_ms(n_vox, keep=False),
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
    kernels0 = skel_ops.bwd_kernel_launches
    skel_ops.soft_skel(xk, SKEL_ITERS).backward(gy)
    torch.cuda.synchronize()
    res["bwd_kernel_launches"] = skel_ops.bwd_kernel_launches - kernels0
    require(res["bwd_kernel_launches"] == rounds, f"soft_skel backward: "
            f"{res['bwd_kernel_launches']} kernel launches for {rounds} rounds")
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
    # K7 against its gather in torch, round by round from the same kept
    # volumes (the same tie rule, the same sums in the same order), on both
    # inputs: on the binary one autograd routes ties otherwise
    with torch.inference_mode():
        for tag, v in (("distinct", x), ("binary_faces", vessels)):
            _, imgs, skels = skel_ops._soft_skel_cuda(v, SKEL_ITERS, keep=True)
            got = skel_ops._soft_skel_bwd_cuda(imgs, skels, gy, shape)[..., 0]
            d_skel, d_img = gy[..., 0], None
            for t in reversed(range(rounds)):
                d_img, d_skel = skel_ops.round_bwd_plain(
                    imgs[t], imgs[t + 1], skels[t - 1] if t else None, d_img, d_skel)
            torch.cuda.synchronize()
            gap = float((got - d_img).abs().max())
            require(gap == 0.0, f"soft_skel backward kernel vs its gather on {tag}: max "
                    f"|diff| {gap:.3e}")
            res[f"bwd_{tag}_vs_gather_max_abs_err"] = gap
            del imgs, skels, got, d_img, d_skel
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


def check_test_step(conv_ops, in_ops, skel_ops, want=TEST_LAUNCHES, tag="test_step",
                    bf16_spread_runs=0, **cfg_kw):
    """The test step of the config with ``cfg_kw`` (phase 6: config 2).

    A bf16 loss of the kernel path may be 3x as far from the f32 plain loss
    as the bf16 plain path's is. With ``bf16_spread_runs`` the plain path's
    distance is the largest of that one and of as many more plain runs, each
    from the weights scaled by (1 + 1e-3 N(0, 1)) (a quarter of bf16's
    rounding step, so about a quarter of the weights round the other way)
    against its own f32 run: where the network amplifies rounding, as the
    i2s V-Net's InstanceNorms of ReLU'd planes do, one plain run is one draw
    of that noise, not its scale."""
    from vangan_torch.config import VanGanConfig
    from vangan_torch.vangan import VanGan

    cfg = VanGanConfig(SUBVOL_PATCH_SIZE=(N, N, N), BATCH_SIZE=STEP_BATCH,
                       cldice_iters=SKEL_ITERS, **cfg_kw)
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
    require(launches == want, f"{tag}: one step launched {launches}, expected {want}")
    require(len(k16) == 10 and all(math.isfinite(v) for v in k16.values()),
            f"{tag}: losses not all finite: {k16}")
    p16 = run(False, torch.bfloat16)
    k32 = run(True, torch.float32)
    ref = run(False, torch.float32)  # TF32 off: the f32 reference
    plain_dist = {key: abs(p16[key] - r) for key, r in ref.items()}
    if bf16_spread_runs:
        init = {name: {k: v.clone() for k, v in net.state_dict().items()}
                for name, net in gan.nets.items()}
        pg = torch.Generator(device=DEVICE).manual_seed(SEED + 10)
        for _ in range(bf16_spread_runs):
            with torch.no_grad():
                for net in gan.nets.values():
                    for prm in net.parameters():
                        prm.mul_(1 + 1e-3 * torch.randn(prm.shape, device=DEVICE, generator=pg))
            q16, q32 = run(False, torch.bfloat16), run(False, torch.float32)
            for key in plain_dist:
                plain_dist[key] = max(plain_dist[key], abs(q16[key] - q32[key]))
            for name, net in gan.nets.items():
                net.load_state_dict(init[name])
    losses = {}
    for key, r in ref.items():
        f32_rel = abs(k32[key] - r) / max(abs(r), 1e-30)
        require(f32_rel <= 1e-3, f"{tag} {key}: f32 kernel {k32[key]} vs plain {r}")
        bound = max(3 * plain_dist[key], 1e-3 * abs(r))
        require(abs(k16[key] - r) <= bound,
                f"{tag} {key}: bf16 kernel {k16[key]}, bf16 plain {p16[key]}, f32 {r}")
        losses[key] = {"f32_plain": r, "f32_kernel_rel": f32_rel, "bf16_kernel": k16[key],
                       "bf16_plain": p16[key], "bf16_plain_dist": plain_dist[key]}

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
    print(tag, json.dumps(res))
    return res


def check_predict(conv_ops, in_ops, calls=(CONV_PATH_CALLS, IN_PATH_CALLS), tag="predict",
                  **cfg_kw):
    """``predict`` through cli.main with the gen_IS of the config with
    ``cfg_kw`` (phase 7: config 2's), which makes ``calls`` kernel convs and
    InstanceNorms a batch."""
    from vangan_torch import cli
    from vangan_torch.config import VanGanConfig
    from vangan_torch.data.preprocess import read_tiff
    from vangan_torch.inference.stitcher import stitch_origins, stitch_subvolumes
    from vangan_torch.vangan import VanGan

    cfg = VanGanConfig(SUBVOL_PATCH_SIZE=(N, N, N), stitcher_batch=BATCH, **cfg_kw)
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
        require(launches == {"conv3d_fwd": calls[0] * n_batches,
                             "instnorm_fwd": calls[1] * n_batches},
                f"{tag} launches {launches}, expected {n_batches} gen_IS batches")

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
                                  plain[torch.bfloat16], plain[torch.float32], tag)
    res = {"volume": [VOLUME] * 3, "patches": len(origins), "unique_patches": n_unique,
           "batches": n_batches, "seconds": seconds,
           "mvox_per_s": VOLUME ** 3 / seconds / 1e6, "launches": launches,
           "grey_levels": close}
    print(tag, json.dumps(res))
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
            "conv3d_dgrad_fold": conv_ops.dgrad_fold_launches,
            "conv3d_wgrad": conv_ops.wgrad_launches, "instnorm_fwd": in_ops.launches,
            "instnorm_bwd": in_ops.bwd_launches, "soft_skel_fwd": skel_ops.launches,
            "soft_skel_bwd": skel_ops.bwd_launches}


def kernel_counters(ops):
    _, in_ops, skel_ops = ops
    return {"instnorm_fwd": in_ops.fwd_kernel_launches,
            "soft_skel_bwd": skel_ops.bwd_kernel_launches}


def reset_counters(ops):
    conv_ops, in_ops, skel_ops = ops
    conv_ops.launches = conv_ops.dgrad_launches = conv_ops.dgrad_fold_launches = 0
    conv_ops.wgrad_launches = 0
    in_ops.launches = in_ops.bwd_launches = in_ops.fwd_kernel_launches = 0
    skel_ops.launches = skel_ops.bwd_launches = skel_ops.bwd_kernel_launches = 0


def check_train_step(ops, want=TRAIN_LAUNCHES, want_kernels=TRAIN_KERNEL_LAUNCHES,
                     tag="train_step", f32_crop=None, **cfg_kw):
    """The train step of the config with ``cfg_kw`` (phase 8: config 2).
    Every parameter tensor must move in the step, and every running
    statistic (BatchNorm buffer) must stay finite and move. With
    ``f32_crop`` the f32 checks also run on the whole batch, cropped to
    ``f32_crop``^3 (where the f32 plain path fits), so that they hold the
    kernels' sums over the samples."""
    import copy

    from vangan_torch.config import VanGanConfig
    from vangan_torch.training import step
    from vangan_torch.training.state import NETWORKS, make_train_state
    from vangan_torch.vangan import VanGan

    cfg = VanGanConfig(SUBVOL_PATCH_SIZE=(N, N, N), BATCH_SIZE=STEP_BATCH,
                       cldice_iters=SKEL_ITERS, **cfg_kw)
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
    launches, kernel_launches = counters(ops), kernel_counters(ops)
    require(launches == want, f"{tag}: one step launched {launches}, expected {want}")
    require(kernel_launches == want_kernels, f"{tag}: one step launched "
            f"{kernel_launches} kernels, expected {want_kernels}")
    step_losses = {k: float(v) for k, v in out.items()}
    require(len(step_losses) == 10 and all(math.isfinite(v) for v in step_losses.values()),
            f"{tag}: losses not all finite: {step_losses}")
    moved_report = {}
    for name, net in gan.nets.items():
        params = list(net.parameters())
        require(all(bool(torch.isfinite(p).all()) for p in params),
                f"{tag} {name}: non-finite parameters after the step")
        moved = sum(not torch.equal(p.detach(), init[name][k].to(p.device))
                    for (k, _), p in zip(net.named_parameters(), params))
        require(moved == len(params),
                f"{tag} {name}: {moved} of {len(params)} parameters changed in the step")
        buffers = list(net.named_buffers())
        for bname, b in buffers:
            require(bool(torch.isfinite(b).all()) and
                    not torch.equal(b, init[name][bname].to(b.device)),
                    f"{tag} {name}.{bname}: running statistic not finite or not moved")
        moved_report[name] = {"params_moved": moved, "params": len(params),
                              "buffers_moved": len(buffers)}

    def grads_of(kernels, dtype, n, crop=N, perturb=0.0):
        """Gradients (flat f32 per network) and losses of the first ``n``
        samples cropped to ``crop``^3, from the seeded weights and noise
        draws; with ``perturb``, every weight scaled by (1 + perturb N(0, 1))."""
        reset(kernels, dtype)
        if perturb:
            with torch.no_grad():
                pg = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
                for net in gan.nets.values():
                    for prm in net.parameters():
                        prm.mul_(1 + perturb * torch.randn(prm.shape, device=DEVICE,
                                                           generator=pg))
        box = (slice(0, n), slice(0, crop), slice(0, crop), slice(0, crop))
        g, res = step.compute_grads(gan.nets, cfg, gan.scales, real_I[box].contiguous(),
                                    real_S[box].contiguous(), NOISE, gan.generator)
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
    perturbed, _ = grads_of(False, f32, 1, perturb=1e-6)
    crop = {}
    if f32_crop:
        for kernels in (True, False):
            crop[kernels] = grads_of(kernels, f32, STEP_BATCH, f32_crop)
        crop["perturbed"] = grads_of(False, f32, STEP_BATCH, f32_crop, 1e-6)[0]
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
        if crop:
            report["losses"][key]["crop_f32_batch3_rel"] = rel_loss(crop[True][1][key],
                                                                    crop[False][1][key])
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
        if crop:
            report["grads"][n].update({
                "crop_f32_batch3_kernel_vs_plain": rel(crop[True][0][n], crop[False][0][n]),
                "crop_f32_batch3_plain_perturbed_vs_plain": rel(crop["perturbed"][n],
                                                                crop[False][0][n])})
    del grads, crop
    print(f"{tag}_agreement", json.dumps(report))
    for key, v in report["losses"].items():
        require(v["f32_rel"] <= 1e-3, f"{tag} {key}: f32 kernel {v['f32_kernel']} vs "
                f"plain {v['f32_plain']}")
        # at batch 3 no f32 reference fits: the bf16 paths may differ there
        # by 3x what they differ by on one sample
        require(v["batch3_bf16_kernel_vs_plain"] <= max(3 * v["bf16_kernel_vs_plain"], 1e-3),
                f"{tag} {key} at batch {STEP_BATCH}: bf16 kernel vs plain: {v}")
        require(v.get("crop_f32_batch3_rel", 0.0) <= 1e-3,
                f"{tag} {key}: f32 kernel vs plain at batch {STEP_BATCH} on the crop: {v}")
    for n, v in report["grads"].items():
        require(v["f32_kernel_vs_plain"] <= SPREAD_FACTOR * v["f32_plain_perturbed_vs_plain"],
                f"{tag} {n}: f32 kernel gradient {v['f32_kernel_vs_plain']:.3e} from plain, "
                f"the plain path's spread {v['f32_plain_perturbed_vs_plain']:.3e}")
        require(v["bf16_kernel_vs_f32"] <= max(3 * v["bf16_plain_vs_f32"], 1e-3),
                f"{tag} {n}: bf16 kernel gradient too far from f32: {v}")
        require(v["batch3_bf16_kernel_vs_plain"] <= max(3 * v["bf16_kernel_vs_plain"], 1e-3),
                f"{tag} {n}: bf16 kernel gradient at batch {STEP_BATCH} too far from plain: {v}")
        # below what a step that dropped samples would read
        require(v["batch3_bf16_kernel_vs_plain"] < v["control_batch1_vs_batch3_plain"],
                f"{tag} {n}: bf16 kernel gradient at batch {STEP_BATCH} as far from plain "
                f"as one sample's: {v}")
        if f32_crop:
            require(v["crop_f32_batch3_kernel_vs_plain"] <=
                    SPREAD_FACTOR * v["crop_f32_batch3_plain_perturbed_vs_plain"],
                    f"{tag} {n}: f32 kernel gradient at batch {STEP_BATCH} on the crop: {v}")

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
           "kernel_launches": kernel_launches, "losses": step_losses, "moved": moved_report,
           "kernel_ms_per_step": float(np.median(times["kernel"])),
           "plain_ms_per_step": float(np.median(times["plain"])),
           "kernel_ms_all": times["kernel"], "plain_ms_all": times["plain"],
           "kernel_peak_gib": peak["kernel"], "plain_peak_gib": peak["plain"]}
    print(tag, json.dumps(res))
    return res


def tubes(rng):
    """A +-1 segmentation volume of VOLUME_SHAPE: TUBES axis-aligned tubes of
    radius 2-4 voxels, all in the half x < X/2 (crops starting beyond it hold
    no foreground and are re-cropped by the feed's rejection sampler)."""
    X, Y, Z = VOLUME_SHAPE[:3]
    vol = np.full((X, Y, Z), -1.0, np.float32)
    for _ in range(TUBES):
        axis, r = int(rng.integers(3)), int(rng.integers(2, 5))
        d = np.arange(-r, r + 1)
        disk = d[:, None] ** 2 + d[None, :] ** 2 <= r * r
        x0 = int(rng.integers(r, X // 2 - r))
        y0, z0 = int(rng.integers(r, Y - r)), int(rng.integers(r, Z - r))
        if axis == 0:
            vol[:X // 2, y0 - r:y0 + r + 1, z0 - r:z0 + r + 1][:, disk] = 1.0
        elif axis == 1:
            vol[x0 - r:x0 + r + 1, :, z0 - r:z0 + r + 1].transpose(1, 0, 2)[:, disk] = 1.0
        else:
            vol[x0 - r:x0 + r + 1, y0 - r:y0 + r + 1, :][disk] = 1.0
    return vol[..., None]


def write_dataset(root):
    """Seeded .npy volumes and the JAX-layout partition pickles
    (``data{A,B}_partition.pkl``: split -> object array of paths) in
    ``root``; returns ({A, B}: partition, segmentation foreground share)."""
    rng = np.random.default_rng(SEED + 9)
    parts, fg = {}, []
    for pid, seg in (("A", False), ("B", True)):
        part = {}
        for split, n in (("training", 2), ("validation", 1)):
            d = os.path.join(root, f"{split}{pid}")
            os.makedirs(d)
            paths = []
            for i in range(n):
                if seg:
                    vol = tubes(rng)
                    fg.append(float((vol > 0).mean()))
                else:
                    vol = rng.random(VOLUME_SHAPE, dtype=np.float32) * 2 - 1
                paths.append(os.path.join(d, f"{'seg' if seg else 'img'}_{split}{i}.npy"))
                np.save(paths[-1], vol)
            part[split] = np.array(paths, dtype=object)
        part["testing"] = part["validation"]  # the predict-after volumes
        with open(os.path.join(root, f"data{pid}_partition.pkl"), "wb") as f:
            pickle.dump(part, f)
        parts[pid] = part
    return parts, float(np.mean(fg))


def predict_batches(shape, stride):
    """gen batches of one complete stitch (padFactor 0.25, stitcher_batch BATCH)."""
    from vangan_torch.inference.stitcher import stitch_origins

    padded = [d + 2 * int(0.25 * d) for d in shape[:3]]
    return -(-len(set(stitch_origins(padded, (N, N, N), (stride,) * 3))) // BATCH)


def expected_fit_launches(train_steps, test_launches, val_steps, gen_calls):
    want = {k: train_steps * v for k, v in TRAIN_LAUNCHES.items()}
    for k, v in test_launches.items():
        want[k] += val_steps * v
    want["conv3d_fwd"] += gen_calls * CONV_PATH_CALLS
    want["instnorm_fwd"] += gen_calls * IN_PATH_CALLS
    # K4 one kernel a call, K7 one a round
    return want, {"instnorm_fwd": want["instnorm_fwd"], "soft_skel_bwd": want["soft_skel_bwd"]}


def check_exact_resume(tmp, **cfg_kw):
    """4 straight steps twice, and 2 steps, a checkpoint, a fresh VanGan
    loading it and 2 more, at full width on phase 6's batch, in the config
    with ``cfg_kw``: each network's parameters and running statistics."""
    from vangan_torch.config import VanGanConfig
    from vangan_torch.training.state import NETWORKS
    from vangan_torch.vangan import VanGan

    cfg = VanGanConfig(SUBVOL_PATCH_SIZE=(N, N, N), BATCH_SIZE=STEP_BATCH,
                       cldice_iters=SKEL_ITERS, output_dir=tmp, **cfg_kw)
    _, real_I, real_S = step_batch()

    def run(gan, n):
        for _ in range(n):
            gan.distributed_train_step(real_I, real_S, NOISE, True)
        torch.cuda.synchronize()

    def flat(gan):
        return {n: torch.cat([p.detach().flatten() for p in (*gan.nets[n].parameters(),
                                                             *gan.nets[n].buffers())])
                for n in NETWORKS}

    straight = []
    for _ in range(2):
        gan = VanGan(cfg, device=DEVICE)
        run(gan, 4)
        straight.append(flat(gan))
        del gan
    first = VanGan(cfg, device=DEVICE)
    run(first, 2)
    first.save_checkpoint(epoch=1)
    ck = first.checkpointer
    ck.wait_until_finished()
    resumed = VanGan(dataclasses.replace(cfg, seed=SEED + 3), device=DEVICE)
    resumed.load_checkpoint(epoch=2)
    require(resumed.checkpoint_loaded and resumed.state.step == 2, "resume: not loaded")
    resumed.generator.set_state(first.generator.get_state())
    del first
    run(resumed, 2)
    got = flat(resumed)
    require(resumed.state.step == 4 and set(resumed.state.counts.values()) == {4},
            f"resume: step {resumed.state.step}, counts {resumed.state.counts}")
    del resumed
    rel = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
    report = {}
    for n in NETWORKS:
        a, b = straight
        same = torch.equal(a[n], b[n])
        report[n] = {"straight_runs_bit_identical": same, "resumed_bit_identical":
                     torch.equal(got[n], a[n]), "resumed_rel": rel(got[n], a[n]),
                     "straight_rel": rel(b[n], a[n])}
        if same:
            require(report[n]["resumed_bit_identical"], f"{n}: resumed differs: {report[n]}")
        else:
            require(report[n]["resumed_rel"] <= 3 * report[n]["straight_rel"],
                    f"{n}: resumed too far from straight: {report[n]}")
    return report, {"snapshot_ms": ck.last_snapshot_ms, "write_s": ck.last_write_s,
                    "bytes": ck.last_bytes}


def check_train_cli(ops, train, test):
    from vangan_torch import cli
    from vangan_torch.config import VanGanConfig
    from vangan_torch.data.pipeline import VanGanDataset
    from vangan_torch.data.preprocess import read_tiff
    from vangan_torch.inference import mapping
    from vangan_torch.monitor.tb import read_scalars
    from vangan_torch.training import loop
    from vangan_torch.training.state import NETWORKS
    from vangan_torch.training.step import RESULT_KEYS
    from vangan_torch.vangan import VanGan

    res = {"volume": list(VOLUME_SHAPE)}
    with tempfile.TemporaryDirectory(prefix="vangan_smoke_train_") as tmp:
        data, out = os.path.join(tmp, "data"), os.path.join(tmp, "out")
        t0 = time.perf_counter()
        parts, res["seg_foreground"] = write_dataset(data)
        res["dataset_write_s"] = time.perf_counter() - t0
        base = dict(SUBVOL_PATCH_SIZE=(N, N, N), BATCH_SIZE=STEP_BATCH, cldice_iters=SKEL_ITERS,
                    train_steps=TRAIN_STEPS, val_steps=VAL_STEPS, PERIOD_2D_CALLBACK=2,
                    output_dir=out)
        cfgs = {}
        for epochs in (2, 3):
            cfgs[epochs] = os.path.join(tmp, f"cfg{epochs}.yaml")
            VanGanConfig(EPOCHS=epochs, **base).to_yaml(cfgs[epochs])

        # the host feed alone: batches/s once the prefetch buffer is drained
        res["feed_batches_per_s"] = {}
        for workers in (1, 4):
            cfg = VanGanConfig(EPOCHS=2, DATA_WORKERS=workers, **base)
            ds = VanGanDataset(cfg, parts["A"], parts["B"], seed=cfg.seed, device=DEVICE)
            try:
                it = ds.train_batches()
                for _ in range(cfg.PREFETCH_SIZE + 2):
                    next(it)
                t0 = time.perf_counter()
                for _ in range(FEED_BATCHES):
                    x, y = next(it)
                res["feed_batches_per_s"][workers] = FEED_BATCHES / (time.perf_counter() - t0)
            finally:
                ds.close()
            require(x.is_pinned() and y.is_pinned() and
                    tuple(x.shape) == (STEP_BATCH, N, N, N, 1)
                    and float(y.amax(dim=(1, 2, 3, 4)).min()) >= cfg.SEG_THRESH,
                    f"feed batch: pinned {x.is_pinned()}, shape {tuple(x.shape)}")

        # wall time of each train() call of the fit and of the predict-after
        # mapping, and the checkpointer of each save
        calls = {"train": [], "validate": [], "predict": [], "saves": []}
        real_train, real_mapping = loop.train, mapping.run_mapping
        real_save = VanGan.save_checkpoint

        def timed_train(ds, gan, summary, epoch, steps=None, desc=None, training=True,
                        noise_std=0.0):
            t = time.perf_counter()
            out_ = real_train(ds, gan, summary, epoch, steps, desc, training, noise_std)
            calls["train" if training else "validate"].append(time.perf_counter() - t)
            return out_

        def timed_mapping(*args, **kwargs):
            t = time.perf_counter()
            real_mapping(*args, **kwargs)
            calls["predict"].append(time.perf_counter() - t)

        def recorded_save(gan, epoch):
            real_save(gan, epoch)
            calls["saves"].append(gan.checkpointer)

        def save_times():
            """The saves of the last run: each write is done (fit waits)."""
            out_ = [{"snapshot_ms": c.last_snapshot_ms, "write_s": c.last_write_s,
                     "bytes": c.last_bytes} for c in calls["saves"]]
            calls["saves"].clear()
            return out_

        n_pred = predict_batches(VOLUME_SHAPE, PREDICT_STRIDE)
        loop.train, mapping.run_mapping, VanGan.save_checkpoint = (timed_train, timed_mapping,
                                                                   recorded_save)
        try:
            torch.cuda.synchronize()
            reset_counters(ops)
            cli.main(["train", "--config", cfgs[2], "--data-dir", data, "--device", DEVICE,
                      "--predict-after"])
            torch.cuda.synchronize()
            launches, kernel_launches = counters(ops), kernel_counters(ops)
            fit_saves = save_times()
        finally:
            loop.train, mapping.run_mapping, VanGan.save_checkpoint = (real_train, real_mapping,
                                                                       real_save)
        want, want_kernels = expected_fit_launches(2 * TRAIN_STEPS, test["launches"],
                                                   2 * VAL_STEPS, PANEL_GEN_CALLS + 2 * n_pred)
        require(launches == want, f"train CLI launched {launches}, expected {want}")
        require(kernel_launches == want_kernels,
                f"train CLI launched {kernel_launches} kernels, expected {want_kernels}")

        scalars = {split: read_scalars(os.path.join(out, "TB_Logs", split))
                   for split in ("train", "validate")}
        for split, tags in (("train", set(RESULT_KEYS) | {"elapse"}),
                            ("validate", set(RESULT_KEYS))):
            require(set(scalars[split]) == tags, f"{split} event tags {sorted(scalars[split])}")
            for tag, events in scalars[split].items():
                require([e for e, _ in events] == [0, 1] and all(math.isfinite(v)
                                                                  for _, v in events),
                        f"{split}/{tag}: {events}")
        ckdir = os.path.join(out, "checkpoints")
        require(os.listdir(ckdir) == ["torch_e2.pt"], f"checkpoints {os.listdir(ckdir)}")
        ck = torch.load(os.path.join(ckdir, "torch_e2.pt"), map_location=DEVICE,
                        weights_only=True)
        ts = ck["train_state"]
        require(sorted(ck) == sorted([*NETWORKS, "train_state"]) and
                sorted(ts["opt"]) == sorted(NETWORKS) and
                all(len(ts["opt"][n]["state"]) == len(ts["opt"][n]["param_groups"][0]["params"])
                    == len(ck[n]) and
                    all(set(s_) == {"step", "exp_avg", "exp_avg_sq"}
                        for s_ in ts["opt"][n]["state"].values()) for n in NETWORKS) and
                set(ts["counts"].values()) == {2 * TRAIN_STEPS} and
                ts["step"] == 2 * TRAIN_STEPS,
                f"torch_e2.pt: keys {sorted(ck)}, counts {ts['counts']}, step {ts['step']}")
        fit_bytes = os.path.getsize(os.path.join(ckdir, "torch_e2.pt"))
        del ck, ts
        for panel in ("2_genIS.png", "2_genSI.png"):
            require(os.path.isfile(os.path.join(out, "GANMonitor", panel)), f"no {panel}")
        for pid in ("A", "B"):
            name = os.path.splitext(os.path.basename(parts[pid]["testing"][0]))[0]
            vol = read_tiff(os.path.join(out, f"VANGAN_{name}.tiff"))
            require(vol.shape == (VOLUME_SHAPE[2], *VOLUME_SHAPE[:2], 1) and
                    bool(np.isfinite(vol).all()) and vol.min() >= 0 and vol.max() <= 255,
                    f"predict-after {name}: shape {vol.shape}")

        # resume: one more epoch from torch_e2.pt
        VanGan.save_checkpoint = recorded_save
        try:
            torch.cuda.synchronize()
            reset_counters(ops)
            cli.main(["train", "--config", cfgs[3], "--data-dir", data, "--device", DEVICE,
                      "--resume-epoch", "2"])
            torch.cuda.synchronize()
            resume_launches = counters(ops)
            resume_saves = save_times()
        finally:
            VanGan.save_checkpoint = real_save
        want3, _ = expected_fit_launches(TRAIN_STEPS, test["launches"], VAL_STEPS,
                                         PANEL_GEN_CALLS)
        require(resume_launches == want3, f"resumed train launched {resume_launches}, "
                f"expected {want3}")
        ts3 = torch.load(os.path.join(ckdir, "torch_e3.pt"), map_location="cpu",
                         weights_only=True)["train_state"]
        require(set(ts3["counts"].values()) == {3 * TRAIN_STEPS} and
                ts3["step"] == 3 * TRAIN_STEPS,
                f"torch_e3.pt: counts {ts3['counts']}, step {ts3['step']}")
        elapse = read_scalars(os.path.join(out, "TB_Logs", "train"))["elapse"]
        require([e for e, _ in elapse] == [0, 1, 2], f"elapse after resume: {elapse}")

        torch.cuda.empty_cache()
        res["exact_resume"], res["checkpoint"] = check_exact_resume(tmp)
    # the process's first save (the fit's) pays for pinning its host memory;
    # the later ones reuse the caching host allocator's blocks
    res["checkpoint"].update(fit_file_bytes=fit_bytes, fit_saves=fit_saves,
                             resume_saves=resume_saves)
    bare_train, bare_test = train["kernel_ms_per_step"] / 1e3, test["kernel_ms_per_step"] / 1e3
    res.update({
        "launches": launches, "kernel_launches": kernel_launches,
        "resume_launches": resume_launches, "losses": {
            split: {k: v[-1][1] for k, v in scalars[split].items() if k != "elapse"}
            for split in scalars},
        "epoch_elapse_s": [v for _, v in elapse],
        "fit_train_s": calls["train"], "fit_validate_s": calls["validate"],
        "fit_s_per_train_step": [t / TRAIN_STEPS for t in calls["train"]],
        "bare_train_step_s": bare_train, "bare_test_step_s": bare_test,
        "fit_over_bare": [t / TRAIN_STEPS / bare_train for t in calls["train"]],
        "predict_after": {"volumes": 2, "batches": 2 * n_pred, "seconds": calls["predict"],
                          "mvox_per_s": 2 * math.prod(VOLUME_SHAPE) / sum(calls["predict"])
                          / 1e6},
        "counts_after_resume": ts3["counts"], "step_after_resume": ts3["step"]})
    print("train_cli", json.dumps(res))
    return res


def check_max_pool_ties():
    """``F.max_pool3d`` on the card sends a tied window's gradient to its
    first element in X, Y, Z order, as the CPU's does (and the JAX package's
    ``reduce_window``, tests/test_torch_vnet.py): ReLU'd data at the i2s
    V-Net's first pool (32 x 128^3), most windows all zeros; values and
    gradients equal to the CPU's, f32 and bf16."""
    g = torch.Generator().manual_seed(SEED + 9)
    x = torch.relu(torch.randn(1, 32, N, N, N, generator=g) - 2.0)
    gy = torch.randn(1, 32, N // 2, N // 2, N // 2, generator=g)
    tied = float((x.reshape(1, 32, N // 2, 2, N // 2, 2, N // 2, 2) == 0)
                 .all(dim=7).all(dim=5).all(dim=3).float().mean())
    res = {"tied_window_share": tied}
    for dtype in (torch.float32, torch.bfloat16):
        grads, outs = [], []
        for dev in ("cpu", DEVICE):
            xd = x.to(dev, dtype, copy=True).requires_grad_()
            y = F.max_pool3d(xd, 2)
            y.backward(gy.to(dev, dtype))
            outs.append(y.detach().cpu())
            grads.append(xd.grad.cpu())
        require(torch.equal(outs[0], outs[1]) and torch.equal(grads[0], grads[1]),
                f"max_pool3d {dtype}: the card's values or tied-window gradients differ "
                "from the CPU's")
        res[f"{dtype}".replace("torch.", "") + "_equal_to_cpu"] = True
    print("max_pool_ties", json.dumps(res))
    return res


def check_generator_family(name, model, ops):
    """One generator alone at full width, batch 1, N^3, in training (its
    dropout drawn from one seed on both paths): forward and backward of
    ``sum(out * gy)``. Every kernel is called the count the path derives:
    each kernel conv (max(Ci, Co) < 128) once forward and once for its
    weight gradient, once for its input gradient where the input needs one
    (all but the convs reading the input), with a fold launch where it pads
    by reflection; each InstanceNorm once each way. Outputs by phase 5's
    rules (f32 within 1e-3, bf16 by ``bf16_vs_reference``), gradients by
    phase 8's (f32 within SPREAD_FACTOR x the plain path's spread, bf16 no
    further from f32 than max(3x the bf16 plain path's distance, 1e-3)); ms
    per forward + backward of both paths."""
    import copy

    from vangan_torch.models.layers import KERNEL_MAX_CHANNELS, ConvND, InstanceNorm

    rng = np.random.default_rng(SEED + 7)
    x = torch.from_numpy(rng.uniform(-1, 1, (1, N, N, N, 1)).astype(np.float32)).to(DEVICE)
    gy = torch.from_numpy(rng.normal(size=(1, N, N, N, 1)).astype(np.float32)).to(DEVICE)
    model = model.to(DEVICE)
    init = copy.deepcopy(model.state_dict())
    seen = {"convs": 0, "dx": 0, "fold": 0, "norms": 0}

    def on_conv(mod, inp):
        if max(mod.weight.shape[:2]) < KERNEL_MAX_CHANNELS:
            seen["convs"] += 1
            if inp[0].requires_grad:
                seen["dx"] += 1
                pads = [p for lohi in (mod.padding if not isinstance(mod.padding, str)
                                       else ()) for p in lohi]
                seen["fold"] += mod.pad_mode == "reflect" and any(pads)

    def on_norm(mod, inp):
        seen["norms"] += 1

    def run(kernels, dtype, perturb=False):
        model.load_state_dict(init)
        model.dtype = dtype
        model.set_use_kernels(kernels)
        if perturb:
            with torch.no_grad():
                pg = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
                for prm in model.parameters():
                    prm.mul_(1 + 1e-6 * torch.randn(prm.shape, device=DEVICE, generator=pg))
        model.zero_grad(set_to_none=True)
        y = model(x, True, torch.Generator(device=DEVICE).manual_seed(SEED + 8))
        (y * gy).sum().backward()
        grads = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad).float().flatten()
                           for p in model.parameters()])
        model.zero_grad(set_to_none=True)
        return y.detach(), grads

    hooks = [m.register_forward_pre_hook(on_conv) for m in model.modules()
             if isinstance(m, ConvND)]
    hooks += [m.register_forward_pre_hook(on_norm) for m in model.modules()
              if isinstance(m, InstanceNorm)]
    torch.cuda.synchronize()
    reset_counters(ops)
    k16, gk16 = run(True, torch.bfloat16)
    torch.cuda.synchronize()
    launches, kernel_launches = counters(ops), kernel_counters(ops)
    for h in hooks:
        h.remove()
    want = {"conv3d_fwd": seen["convs"], "conv3d_dgrad": seen["dx"],
            "conv3d_dgrad_fold": seen["fold"], "conv3d_wgrad": seen["convs"],
            "instnorm_fwd": seen["norms"], "instnorm_bwd": seen["norms"],
            "soft_skel_fwd": 0, "soft_skel_bwd": 0}
    require(launches == want and kernel_launches == {"instnorm_fwd": seen["norms"],
                                                     "soft_skel_bwd": 0},
            f"{name}: launched {launches} ({kernel_launches} kernels), expected {want}")
    require(k16.shape == x.shape and bool(torch.isfinite(k16).all()) and
            bool(torch.isfinite(gk16).all()), f"{name}: output or gradient not finite")
    p16, gp16 = run(False, torch.bfloat16)
    k32, gk32 = run(True, torch.float32)
    ref, gref = run(False, torch.float32)
    _, gpert = run(False, torch.float32, perturb=True)
    rel = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
    f32_max = float((k32 - ref).abs().max())
    res = {"launches": launches, "f32_kernel_vs_plain_max": f32_max,
           **bf16_vs_reference(k16, p16, ref, name),
           "grads": {"f32_kernel_vs_plain": rel(gk32, gref),
                     "f32_plain_perturbed_vs_plain": rel(gpert, gref),
                     "bf16_kernel_vs_f32": rel(gk16, gref),
                     "bf16_plain_vs_f32": rel(gp16, gref)}}
    require(f32_max <= 1e-3, f"{name}: f32 kernel vs plain output max {f32_max:.3e}")
    v = res["grads"]
    require(v["f32_kernel_vs_plain"] <= SPREAD_FACTOR * v["f32_plain_perturbed_vs_plain"],
            f"{name}: f32 kernel gradient too far from plain: {v}")
    require(v["bf16_kernel_vs_f32"] <= max(3 * v["bf16_plain_vs_f32"], 1e-3),
            f"{name}: bf16 kernel gradient too far from f32: {v}")
    times = {"kernel": [], "plain": []}
    for path in ("plain", "kernel", "kernel", "plain", "plain", "kernel"):  # in turns
        times[path].append(cuda_ms(lambda: run(path == "kernel", torch.bfloat16), reps=1))
    res.update({"kernel_ms_fwd_bwd": float(np.median(times["kernel"])),
                "plain_ms_fwd_bwd": float(np.median(times["plain"]))})
    model.set_use_kernels(True)
    print("generator_family", name, json.dumps(res))
    return res


def check_config4(ops, tol):
    """Phase 10: BASELINE config 4 (V-Net generators) at full width."""
    from vangan_torch.config import VanGanConfig
    from vangan_torch.models.factory import build_generator

    conv_ops, in_ops, skel_ops = ops
    # the main path: config 4's train step, counters read just after it
    train = check_train_step(ops, C4_TRAIN_LAUNCHES, C4_TRAIN_KERNEL_LAUNCHES,
                             "config4_train_step", f32_crop=C4_F32_CROP, **C4)
    torch.cuda.empty_cache()
    test = check_test_step(conv_ops, in_ops, skel_ops, C4_TEST_LAUNCHES, "config4_test_step",
                           bf16_spread_runs=2, **C4)
    torch.cuda.empty_cache()
    g = torch.Generator().manual_seed(SEED)
    shapes = {}
    for role in ("i2s", "s2i"):
        model = build_generator("vnet", VanGanConfig(), role=role, generator=g).to(DEVICE)
        shapes[role] = path_shapes(model.eval())
        del model
    rows = {"convs": check_convs("vnet_i2s", shapes["i2s"], C4_IS_CONVS, tol) +
            check_convs("vnet_s2i", shapes["s2i"], C4_SI_CONVS, tol),
            "instnorms": check_instnorms("vnet_i2s", shapes["i2s"], C4_IS_INS, tol) +
            check_instnorms("vnet_s2i", shapes["s2i"], 0, tol)}
    pool = check_max_pool_ties()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="vangan_smoke_c4_") as tmp:
        resume, _ = check_exact_resume(tmp, **C4)
    print("config4_exact_resume", json.dumps(resume))
    torch.cuda.empty_cache()
    predict = check_predict(conv_ops, in_ops, (C4_IS_CONVS, C4_IS_INS), "config4_predict", **C4)
    torch.cuda.empty_cache()
    return {"train": train, "test": test, "rows": rows, "max_pool": pool, "resume": resume,
            "predict": predict}


def check_other_generators(ops, tol):
    """Phase 11: the ResU-Net with deconv and with the attention gate, and
    the ResNet generator, each alone at full width; and K1-K3
    at the ResNet's kernel conv shapes (its 7^3 stem and head take the
    CUDA-core bodies: 343 taps), timed against their plain versions and
    cuDNN as in phase 2."""
    from vangan_torch.config import VanGanConfig
    from vangan_torch.models.factory import build_generator
    from vangan_torch.models.resunet import ResUNet3D

    g = torch.Generator().manual_seed(SEED)
    families = {
        "resunet_deconv": lambda: ResUNet3D(16, 4, upsample_mode="deconv", generator=g),
        "resunet_attention": lambda: ResUNet3D(16, 4, use_attention_gate=True, generator=g),
        # the factory's ResNet takes no role (vangan_tpu/models/factory.py)
        "resnet": lambda: build_generator("resnet", VanGanConfig(), generator=g),
    }
    out = {}
    for name, build_fn in families.items():
        out[name] = check_generator_family(name, build_fn(), ops)
        torch.cuda.empty_cache()
    resnet = build_generator("resnet", VanGanConfig(), generator=g).to(DEVICE).eval()
    out["resnet_convs"] = check_convs("resnet", path_shapes(resnet), RESNET_CONVS, tol)
    return out


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
    test = check_test_step(conv_ops, in_ops, skel_ops)
    torch.cuda.empty_cache()
    check_predict(conv_ops, in_ops)
    torch.cuda.empty_cache()
    train = check_train_step((conv_ops, in_ops, skel_ops))
    torch.cuda.empty_cache()
    check_train_cli((conv_ops, in_ops, skel_ops), train, test)
    torch.cuda.empty_cache()
    c4 = check_config4((conv_ops, in_ops, skel_ops), tol)
    check_other_generators((conv_ops, in_ops, skel_ops), tol)

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
                "config4_launches": c4["train"]["launches"][name],
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
                 "launches": train["launches"][name],
                 "config4_launches": c4["train"]["launches"][name], "max_abs_err": max(errs_),
                 "ms": total(f"{op}_bf16_ms"), "plain_ms": total(f"{op}_bf16_plain_ms"),
                 **summed_bound([(len(r["uses"]), r["bound"][op]) for r in in_rows]),
                 "library_ms": None}
        # the library calls (F.instance_norm, native_batch_norm_backward) have no
        # activation: the act='none' norms only
        none = [r for r in in_rows if r["act"] == "none"]
        entry["ms_act_none"] = sum(len(r["uses"]) * r[f"{op}_bf16_ms"] for r in none)
        entry["library_ms_act_none"] = sum(len(r["uses"]) * r[f"{op}_bf16_library_ms"]
                                           for r in none)
        return entry

    kernels = [
        conv_entry("conv3d_fwd", "fwd", "vangan_torch/ops/csrc/conv3d_fwd.cu",
                   "vangan_tpu/ops/pallas/conv3d.py:577"),
        dict(conv_entry("conv3d_dgrad", "dgrad", "vangan_torch/ops/csrc/conv3d_dgrad.cu",
                        "vangan_tpu/ops/pallas/conv3d.py:904"),
             fold_launches=train["launches"]["conv3d_dgrad_fold"],
             config4_fold_launches=c4["train"]["launches"]["conv3d_dgrad_fold"]),
        conv_entry("conv3d_wgrad", "wgrad", "vangan_torch/ops/csrc/conv3d_wgrad.cu",
                   "vangan_tpu/ops/pallas/conv3d.py:817"),
        dict(in_entry("instnorm_fwd", "fwd", "vangan_tpu/ops/pallas/instnorm.py:309"),
             kernel_launches=train["kernel_launches"]["instnorm_fwd"],
             config4_kernel_launches=c4["train"]["kernel_launches"]["instnorm_fwd"]),
        in_entry("instnorm_bwd", "bwd", "vangan_tpu/ops/pallas/instnorm.py:379"),
        {"name": "soft_skel_fwd", "route": "cuda",
         "source": "vangan_torch/ops/csrc/skeleton_fwd.cu",
         "replaces": "vangan_tpu/ops/pallas/skeleton.py:185",
         "launches": train["launches"]["soft_skel_fwd"],
         "config4_launches": c4["train"]["launches"]["soft_skel_fwd"],
         "max_abs_err": max(skel["tanh_noise_max_abs_err"], skel["binary_faces_max_abs_err"]),
         "ms": skel["tanh_noise_ms"], "plain_ms": skel["tanh_noise_plain_ms"],
         "bound_ms": skel["fwd_bound"][0], "bound_by": skel["fwd_bound"][1],
         "library_ms": None},
        {"name": "soft_skel_bwd", "route": "cuda",
         "source": "vangan_torch/ops/csrc/skeleton_bwd.cu",
         "replaces": "vangan_tpu/ops/pallas/skeleton.py:274",
         "launches": train["launches"]["soft_skel_bwd"],
         "kernel_launches": train["kernel_launches"]["soft_skel_bwd"],
         "config4_launches": c4["train"]["launches"]["soft_skel_bwd"],
         "config4_kernel_launches": c4["train"]["kernel_launches"]["soft_skel_bwd"],
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
