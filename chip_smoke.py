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
   route, tensor-core or thin CUDA-core body, the C entry's route number
   (``body``), and the Co tile, split and workspace; above 64 taps the tap
   chunks or the (dx, dy) pairs on K, and the brick) of K1, K2 (its Ci
   tile, parities in launch order, fold planes and launches) and K3, and
   the achieved TFLOP/s (FLOPs / kernel ms) of the kernel and the library
   call; the bf16 K3 must give bit-identical dW in two
   runs, on either route (split-K slices summed in a fixed order), and the
   bf16 K2 bit-identical dx (no atomics); a shape that
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
   checks and times at the ResNet's 4 kernel conv shapes at the step's batch
   of 3, each 343-tap row (K1, K2, K3 of the stem and the head) against its
   plain version and cuDNN, with its plan's route (its 343-tap head, 32 ->
   1, takes K1 and K3 on the tensor cores in tap chunks, route 2, and K2 on
   route 3, the (dx, dy) pairs on K; its stem, 1 -> 32, K1 and K3 on route
   3, the (dx, dy) pairs on K and M, and K2 in tap chunks; the ResNet is one
   generator whatever the role, as in the JAX factory, so it runs once);
12. data in and evaluation out, at the config's sizes: seeded raw TIFFs
   (two imaging volumes of RAW_IMG_SIZE 512 x 512 x 140 as uint16, two
   segmentation volumes of 512 x 512 x 128 as uint8 0/255 tubes) through
   ``python -m vangan_torch preprocess --resize --preprocess rsom`` (through
   cli.main; the partition counts, every imaging .npy (512, 512, 128, 1) in
   [-1, 1], every segmentation .npy exactly the +-1 tubes written); then
   ``predict`` on the raw imaging TIFFs with ``--resize --preprocess rsom
   --stride 64 64 64`` and weights saved from seeded init (phase 7's checks:
   K1 and K4 launched 17 and 28 times a gen_IS batch, the TIFFs finite and in
   [0, 255], the first volume by phase 5's bf16 rule against plain-path
   stitches of the same preprocessed input); then
   ``metrics.evaluate_segmentation`` on the card of that prediction against
   a seeded tube truth of its shape: K6 launched exactly 2 x 16 times, Dice
   and clDice exactly equal to the plain skeleton's on the card; and K6
   bit-exact against ``morphology.soft_skel`` at 512 x 512 x 128 (the truth,
   the binarised prediction and a continuous volume) and at (1, 97, 61, 45,
   1), shapes that meet its warp tile's partial tiles. Each part's seconds
   and Mvox/s on the ``data_eval`` line, with the card's name and power limit;
13. WGAN-GP training: BASELINE config 2 with ``wasserstein: true`` (the
   critics' Wasserstein head, the WGAN Adam, the gradient penalty of weight
   10 from step 1) at full width, as phase 8 (3 x 128^3, bf16, noise sigma
   0.1, dropout on, seeded): steps 0 (no penalty) and 1 (penalty on) through
   ``VanGan.distributed_train_step`` must launch every kernel an exact count
   (``WGAN_LAUNCHES``, derived from the path: the penalty's second
   derivative runs K1 and K3 through conv0's input gradient and the critic
   norms' double backward on K4's statistics and K5's sums), give ten
   finite losses and two penalties > 0 at step 1, and move every parameter
   but each critic's ``w_dense.bias`` (no loss sees it: its gradient is 0);
   phase 8's kernel-vs-plain rules on the gradients with the penalty on
   (the signed Wasserstein losses by their absolute differences at batch
   3), the check that catches a second-order term the kernel path drops;
   the double backward alone at conv0's shape and the four critic norm
   shapes, batch 3, against torch's of the plain versions (f32 1e-4 x max
   |ref|, a weight gradient 1e-3; bf16 2e-2), with its ms; ``train()`` over
   6 steps with ncritic 5 must update the generators at exactly the steps
   the JAX package's bookkeeping names; ms per step of both paths with the
   penalty off and on, in turns, peak memory, and the step's phases by the
   CUDA events of its spans (``monitor.profiling``; the penalty's share). Its numbers
   on the ``wgan_step`` and ``wgan_double_backward`` lines;
14. the 2-D mode: config 2 with ``DIMENSIONS: 2`` at full width (ResU-Nets
   f=16 with 4 levels, PatchGANs f=64) on 128 x 128 images, whose layers run
   on depth-1 volumes (B, C, 1, H, W) with (1, k, k) kernels: phases 2-3's
   checks, tolerances and bit-identity rules at every conv shape of the 2-D
   gen_IS and disc_I (K1-K3 timed against cuDNN's 2-D conv, ``F.conv2d``
   and its two gradients) and every norm shape, plus planes of 4, 16 and 64
   elements (``TWOD_TINY_PLANES``); phase 6's test step and phase 8's train
   step (batch 3, bf16, noise sigma 0.1, dropout on) with the launches of
   ``TWOD_TEST_LAUNCHES`` / ``TWOD_TRAIN_LAUNCHES`` (K1-K5 as phase 8, K6
   and K7 none: the 2-D skeleton's erosion is not K6's and runs torch ops),
   their losses, kernel-vs-plain rules, ms and peak memory; the train step
   timed again at 512 x 512; ``predict`` through cli.main on a seeded 2048
   x 2048 .npy image, stride 64 (one (h, w) page, finite, in [0, 255], K1
   and K4 17 and 28 times a gen_IS batch, phase 5's bf16 rule against
   plain-path stitches, Mpix/s); and ``evaluate_segmentation`` of that
   prediction against seeded lines on the card: no K6 launch, scores equal
   to the CPU's; and the 2-D skeleton's torch ops timed at the step's
   shapes. Its numbers on the ``twod*`` lines;
15. data parallelism (BASELINE config 5: config 2 with ``N_DEVICES: 2``,
   ``BATCH_SIZE`` 3 a rank, a global batch of 6 at 128^3), through
   ``vangan_torch.parallel``: (a) world 1 over NCCL in this process, two
   ``VanGan.distributed_train_step`` steps (bf16, noise and dropout on)
   bit-identical, parameters and losses, to the same steps without a
   group, and the two in turns timed; (b) two ranks sharing the card over
   gloo (``parallel.spawn``, joined within ``DP_TIMEOUT_S``): one step of
   each on the seeded global batch must launch each kernel ``TRAIN_LAUNCHES``
   times and K4/K7 ``TRAIN_KERNEL_LAUNCHES`` kernels (each rank's counters,
   set to 0 just before it), give ten finite losses equal on both ranks, and
   leave the two ranks' parameters bit-identical; then, from the seeded
   weights with noise 0 and dropout off, the averaged gradients and losses
   against one process's step of the same global batch under the same
   contract: bf16 at 128^3 each network's gradient and each loss within
   max(SPREAD_FACTOR x the one-process step's distance from its own
   arithmetic by halves, 1e-3) relative (each half at the rank's scales,
   averaged: the rounding that splitting the batch brings, since a kernel's
   or cuDNN's bf16 result may depend on the batch it runs in), and f32 on
   the batch cropped to ``DP_CROP``^3 by phase 8's f32 rules (losses 1e-3,
   gradients SPREAD_FACTOR x the one-process spread under a 1e-6 weight
   perturbation, or by halves if that is larger); (c) BASELINE config 4
   (V-Nets, BatchNorm across the ranks) by phase 8's f32 rules on the crop,
   and each moved BatchNorm statistic, after the step's forward and after
   gen_SI's forward alone on the data, within max(SPREAD_FACTOR x its
   spread, 1e-5) relative L2, equal on both ranks; (d) phase 7's 256^3 volume stitched
   with the patches split over the two ranks against the one-process
   stitch, max |diff| <= 255 x 2^-16 on the [0, 255] scale (the same patch
   predictions, added in another order in float32); (e) with two cards,
   the two ranks over NCCL (one a card): launches, bit-identical ranks, ms
   per step and patches/s (else a line says it did not run); (f) ms per
   step of each, the all-reduce's ms for the gradients' bytes (world 1 over
   NCCL on a buffer of that size; the two gloo ranks' own), and each rank's
   peak memory. Its numbers on the ``dp*`` lines;
16. gradient accumulation (``micro_batches``, ``check_micro``): config 2 at
   BATCH_SIZE 3 in 3 slices (3x phase 8's launches, the slices' gradients
   kernel against plain by phase 8's f32 rules on the whole batch at 128^3
   and its bf16 rule, ms of both paths and peak memory); BASELINE config 5's
   global batch of 12 on the one card in 4 slices (4x the launches, ms,
   patches/s, peak memory; the step's rise above what it found allocated
   within a batch-3 step's plus the gradient buffers and one incoming
   gradient); config 4 in 3 slices in f32 on the 96^3 crop (its averaged
   BatchNorm statistics kernel against plain); a ResU-Net and a V-Net with
   the options no factory role sets (input noise, encoder dropout with a
   per-layer change, sigmoid heads, two V-Net classes, the V-Net's
   ``addnoise`` and decoder dropout), forward and backward, kernel against
   plain. Its numbers on the ``micro3``, ``micro4_of_12``,
   ``config4_micro3`` and ``generator_family`` lines;
17. the ResNet CycleGAN: config 2 with ``gen_i2s = gen_s2i = "resnet"``
   (the factory's ResNet, 32 filters, 3 downsampling blocks, 6 residual
   blocks at 256 channels, 3 upsampling blocks; config 2's PatchGANs, noise
   sigma 0.1, dropout on, 3 x 128^3, bf16) through
   ``VanGan.distributed_train_step``: phase 8's checks (the launches of
   ``RESNET_TRAIN_LAUNCHES``, derived from the path; of them, K1 and K3 of
   the 4 head calls on the tap chunks, the 4 stem calls' K1 and K3 on route
   3 and the 4 head calls' K2 on route 3, ``RESNET_TAP_CHUNKS``, and none
   in phases 8 and 10; the plans of the 343-tap convs on the bodies that
   count: the stem's K1 and K3 and the head's K2 on route 3, the head's K1
   and K3 on the tap chunks; f32 kernel against plain on one sample at
   128^3, the
   bf16 rules on one sample and on the batch; ms a step of both paths in
   turns, peak memory), and where the time of its 343-tap convs goes: each
   kernel's launches in the step times its ms at phase 11's shape, beside
   the step's ms. Its numbers on the ``resnet_train_step`` and
   ``resnet_step`` lines;

Then one JSON line of the seven kernels (launches counted in one train step
of phase 8, the path that runs them all, and of phase 10 as
``config4_launches``; phase 13's step 1 as ``wgan_launches``; phase 14's
2-D train step as ``twod_launches``; phase 15's per rank as
``dp_launches``; phase 16's step of 3 slices as ``micro_launches``; phase 17's
as ``resnet_launches``, with the head's K1 and K3 on the tap chunks beside the
conv kernels (``resnet_tap_chunk_launches``), the stem's K1 and K3 on route 3
(``resnet_pair_launches``) and the head's K2 on route 3
(``resnet_tap_launches``: K2 on either forward body), and each conv kernel's
``taps_343``: at the stem's and the head's shapes (phase 11, batch 3) its
route and body, ms, plain ms, library ms and bound, with its launches in
phase 17's step; phase 12's as
``raw_predict_launches`` for K1 and K4 and ``metric_launches`` for K6; for
K4 and K7 the kernel launches beside the calls; ms, plain ms, library ms and the bound summed over the convs / norms
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
# phase 17: the ResNet CycleGAN, config 2 with ResNet generators, derived from
# the path as phase 8's. A ResNet call has 4 kernel convs (stem_conv 1 -> 32
# and head 32 -> 1, 7^3 reflect-padded; down0 32 -> 64, 3^3 stride 2
# reflect; up2 64 -> 32, 4^3 'same' zeros) and 19 InstanceNorms (stem, 3
# down, 6 x 2 residual, 3 up); one train step:
# - K1: the 4 generator calls' 4, and conv0 of the 6 discriminator calls;
# - K2: down0, up2 and head of each generator call (its stem reads data or a
#   detached fake), and the 2 generator-branch conv0s; a fold launch for
#   those with a reflect pad: down0 and head, and conv0;
# - K3: the 4 generator calls' 4, and conv0 of the 4 discriminator calls with
#   live parameters;
# - K4 and K5 once per norm; K6 and K7 as in phase 8.
# Of K1 and K3, the head's (4 calls each) run on the tap chunks.
RESNET = {"gen_i2s": "resnet", "gen_s2i": "resnet"}
RESNET_IN_CALLS = 19
RESNET_TRAIN_LAUNCHES = {
    "conv3d_fwd": 4 * RESNET_CONVS + 6 * DISC_CONV_CALLS,
    "conv3d_dgrad": 4 * 3 + 2 * 1,
    "conv3d_dgrad_fold": 4 * 2 + 2 * 1,
    "conv3d_wgrad": 4 * RESNET_CONVS + 4 * DISC_CONV_CALLS,
    "instnorm_fwd": 4 * RESNET_IN_CALLS + 6 * DISC_IN_CALLS,
    "instnorm_bwd": 4 * RESNET_IN_CALLS + 6 * DISC_IN_CALLS,
    "soft_skel_fwd": 2 * (SKEL_ITERS + 1),
    "soft_skel_bwd": SKEL_ITERS + 1,
}
RESNET_TRAIN_KERNEL_LAUNCHES = {"instnorm_fwd": RESNET_TRAIN_LAUNCHES["instnorm_fwd"],
                                "soft_skel_bwd": RESNET_TRAIN_LAUNCHES["soft_skel_bwd"]}
# of K1, K2 and K3, the launches on the bodies above 64 taps: K1 and K3 on
# the tap chunks (the head's), K1 and K3 on route 3 (the stem's), K2 on
# route 2 or 3 (the head's, route 3; the stem's K2 never runs)
RESNET_TAP_CHUNKS = {"conv3d_fwd": 4, "conv3d_wgrad": 4, "conv3d_fwd_pairs": 4,
                     "conv3d_wgrad_pairs": 4, "conv3d_dgrad_taps": 4}
NO_TAP_CHUNKS = dict.fromkeys(RESNET_TAP_CHUNKS, 0)
# the C entry's route (ConvPlan.body) of each 343-tap conv's (K1, K2, K3)
RESNET_343_BODIES = {"stem_conv": (3, 2, 3), "head": (2, 3, 2)}
# each 343-tap conv's launches in one step: (K1, K2, K3)
RESNET_343_LAUNCHES = {"stem_conv": (4, 0, 4), "head": (4, 4, 4)}
# phase 12: data in, evaluation out
RAW_SHAPE = (512, 512, 140)  # RAW_IMG_SIZE (x, y, z), read as uint16 pages
RAW_VOLUMES = 2              # a domain: 1 validation and 1 test volume by the 72/18/10 split
ODD_SKEL_SHAPE = (1, 97, 61, 45, 1)
# phase 9: the training CLI
VOLUME_SHAPE = (512, 512, 128, 1)  # TARG_RAW_IMG_SIZE and TARG_SYNTH_IMG_SIZE
TUBES = 120            # segmentation tubes a volume (a few % foreground)
TRAIN_STEPS, VAL_STEPS = 3, 1
PREDICT_STRIDE = 25    # the stride of train --predict-after
PANEL_GEN_CALLS = 6    # a saving epoch's panels: 2 x (translated, cycled, identity)
FEED_BATCHES = 8       # batches timed of the host feed alone
# phase 13: WGAN-GP, config 2 with wasserstein: true. Step 0 runs without the
# gradient penalty (gp_scale 0), so it launches what phase 8's step does.
# From step 1 each critic's penalty adds, derived from the path (one critic
# call on the interpolate, its input gradient under create_graph, then the
# step's backward through both):
# - K1: conv0 of the critic call, and conv(ddx, w) in the double backward of
#   conv0's input gradient;
# - K2 (and its fold, conv0 pads by reflection): conv0's input gradient in
#   the first-order pass, and again in the step's backward through the
#   critic call, whose input (the interpolate) requires grad: that one is
#   thrown away;
# - K3: conv0's weight gradient in the first-order pass (thrown away:
#   ``needs_input_grad`` is fixed at the forward), W(ddx, g) in the double
#   backward, and conv0's weight gradient in the step's backward;
# - K4: the call's 4 norms; K5: 4 in the first-order pass and 3 in the
#   step's backward (down2.inorm's output feeds only the head, whose input
#   gradient does not depend on it); the norms' double backward is torch ops.
GP_LAUNCHES = {"conv3d_fwd": 2, "conv3d_dgrad": 2, "conv3d_dgrad_fold": 2, "conv3d_wgrad": 3,
               "instnorm_fwd": DISC_IN_CALLS, "instnorm_bwd": 2 * DISC_IN_CALLS - 1}
WGAN_LAUNCHES = {0: TRAIN_LAUNCHES,
                 1: {k: v + 2 * GP_LAUNCHES.get(k, 0) for k, v in TRAIN_LAUNCHES.items()}}
WGAN_KERNEL_LAUNCHES = {k: {"instnorm_fwd": v["instnorm_fwd"],
                            "soft_skel_bwd": v["soft_skel_bwd"]}
                        for k, v in WGAN_LAUNCHES.items()}
NCRITIC_STEPS = 6      # train() steps of the ncritic check (ncritic 5)
# phase 14: the 2-D mode, config 2 with DIMENSIONS: 2 (its SUBVOL_PATCH_SIZE
# gives 128 x 128 images). Every layer runs on depth-1 volumes (B, C, 1, H,
# W) with (1, k, k) kernels, so the networks have phase 8's kernel convs and
# norms, with the same channels, the same (reflect) pads on H and W and the
# same strides on them: one train step launches K1-K5 as phase 8's does.
# The 2-D skeleton erodes with the (3,1) and (1,3) windows only, which K6
# does not compute: it runs torch ops, and K6 and K7 launch 0 times.
TWOD = {"DIMENSIONS": 2}
TWOD_N = 128             # image edge (SUBVOL_PATCH_SIZE[:2])
TWOD_BIG = 512           # the train step timed again at 512 x 512
TWOD_IMAGE = 2048        # predict's seeded image edge
TWOD_TUBES = 60          # the metric's truth: random lines of 1.5-4 px radius
TWOD_NO_SKELETON = {"soft_skel_fwd": 0, "soft_skel_bwd": 0}
TWOD_TRAIN_LAUNCHES = {**TRAIN_LAUNCHES, **TWOD_NO_SKELETON}
TWOD_TRAIN_KERNEL_LAUNCHES = {"instnorm_fwd": TWOD_TRAIN_LAUNCHES["instnorm_fwd"],
                              "soft_skel_bwd": 0}
TWOD_TEST_LAUNCHES = {**TEST_LAUNCHES, "soft_skel_fwd": 0}
# K4/K5 on planes no 3-D shape gave them: 2 x 2 (4 elements: in bf16 8
# bytes, less than one 16-byte vector, the unaligned route), 4 x 4 and 8 x 8,
# at the channels of the levels that reach them (the deepest level of a
# 32^2 or 64^2 patch, and of phase 14's 128^2 one)
TWOD_TINY_PLANES = ((256, (1, 2, 2)), (256, (1, 4, 4)), (256, (1, 8, 8)))
# The f32 gradients' rule, kernel against plain, takes the plain path's
# spread as the largest of this many 1e-6 perturbation draws. A ReLU or
# LeakyReLU pre-activation within rounding of 0 takes the other slope in
# another f32 run; on 128^2 images a discriminator has 16x fewer voxels a
# plane than at 128^3, so one such flip moves its whole gradient upstream of
# the flipped norm at once (relative L2 up to ~1e-3) and the gradient jumps
# between ~1e-6 and ~1e-3 from draw to draw, kernel path and perturbed plain
# path alike (the per-draw spreads are on the twod_train_step_agreement
# line); one draw does not bound it.
TWOD_SPREAD_DRAWS = 5


# phase 15: data parallelism, config 2 (and config 4) with N_DEVICES 2: two
# ranks of BATCH_SIZE 3, a global batch of 6 at 128^3
DP_WORLD = 2
DP = {"N_DEVICES": DP_WORLD}
DP_CROP = 96           # the f32 checks' crop, phase 10's C4_F32_CROP
DP_TIMED_STEPS = 3
DP_TIMEOUT_S = 600     # a rank that runs longer fails the phase

# phase 16: gradient accumulation (micro_batches), config 2 at BATCH_SIZE 3 in
# 3 slices, and BASELINE config 5's global batch of 12 (4 cards x 3) on one
# card in 4 slices; each slice launches what a train step of phase 8 does
MICRO = 3
MICRO_BIG_BATCH, MICRO_BIG = 12, 4
MICRO_TIMED_STEPS = 3


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


def path_shapes(model, sample=(N, N, N)):
    """The (name, module, input shape) of every conv and InstanceNorm of one
    call of ``model`` on a ``sample`` (default N^3; (H, W) for a 2-D
    network), batch 1, recorded on the plain path."""
    from vangan_torch.models.layers import ConvND, InstanceNorm

    seen, hooks = [], []
    for name, m in model.named_modules():
        if isinstance(m, (ConvND, InstanceNorm)):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, inp, name=name: seen.append((name, mod, tuple(inp[0].shape)))))
    model.set_use_kernels(False)
    with torch.inference_mode():
        model(torch.zeros(1, *sample, 1, device=DEVICE))
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

    keys = ("route", "body", "co_tile", "co_tiles", "tap_warps", "tap_groups", "split",
            "workspace_bytes", "pad_share", "shared_halo", "tap_chunk", "tap_chunks", "k_pairs",
            "brick")
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
        # a 2-D network's conv (a depth-1 volume, a (1, kh, kw) kernel) is
        # timed against cuDNN's 2-D conv, the library call a 2-D model makes
        depth1 = dims[0] == 1 and m.kernel_size[0] == 1
        row = {"net": net, "convs": names, "w": list(wshape), "stride": list(stride),
               "in": list(dims), "gflop": flops / 1e9,
               "library": "conv2d" if depth1 else "conv3d",
               "bound": {k: bound(flops, nb, BF16_FLOP_PER_S) for k, nb in (
                   ("fwd", nbytes), ("dgrad", nbytes),
                   # wgrad: x, g read, dW written in f32
                   ("wgrad", nbytes + 2 * co * ci * math.prod(m.kernel_size)))}}
        for dtype in (torch.float32, torch.bfloat16):
            x, gy = x32.to(dtype), gy32.to(dtype)
            xp = pad3d(x, pads, pad_mode)
            tag = "f32" if dtype == torch.float32 else "bf16"
            with torch.inference_mode():
                if depth1:
                    sq, s2 = (lambda t: t[:, :, 0]), stride[1:]  # noqa: E731
                    w2 = w[:, :, 0].to(dtype)
                    library = {
                        "fwd": lambda: F.conv2d(sq(xp), w2, None if b is None else b.to(dtype),
                                                s2),
                        "dgrad": lambda: torch.nn.grad.conv2d_input(
                            (STEP_BATCH, ci, *xp_shape[3:]), w2, sq(gy), s2),
                        "wgrad": lambda: torch.nn.grad.conv2d_weight(sq(xp), w2.shape, sq(gy),
                                                                      s2)}
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
                for op, (kern, plain, lib) in ops.items():
                    lib = library[op] if depth1 else lib
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
                    if op == "dgrad" and dtype == torch.bfloat16:
                        # every dx value is written once, no atomics
                        same = torch.equal(got, kern())
                        require(same, f"conv dgrad {names}: dx differs between two runs on "
                                "the same inputs")
                        row["dgrad_bf16_bit_identical"] = same
                    row[f"{op}_{tag}_ms"] = cuda_ms(kern)
                    row[f"{op}_{tag}_plain_ms"] = cuda_ms(plain)
                    row[f"{op}_{tag}_library_ms"] = cuda_ms(lib)
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


def check_instnorms(net, shapes, expected, tol, extra=()):
    """K4 (forward) and K5 (backward) at each (C, size) and activation of
    ``net``, and at the (C, size) planes of ``extra``, which no call of it
    uses."""
    from vangan_torch.models.layers import InstanceNorm
    from vangan_torch.ops import instnorm as I

    groups = {}
    for name, m, shape in shapes:
        if isinstance(m, InstanceNorm):
            groups.setdefault((shape[1], shape[2:]), []).append((name, m.act))
    n_calls = sum(len(v) for v in groups.values())
    require(n_calls == expected, f"{n_calls} InstanceNorms in a {net} call, "
            f"expected {expected}")
    for c, dims in extra:
        groups.setdefault((c, tuple(dims)), [])
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


def step_batch(sample=(N, N, N)):
    """The seeded 3 x 128^3 batch of phases 6 and 8 (3 x ``sample``): real_I
    uniform in [-1, 1], real_S binary in {-1, 1}."""
    rng = np.random.default_rng(SEED + 4)
    shape = (STEP_BATCH, *sample, 1)
    real_I = torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)).to(DEVICE)
    seg = rng.uniform(size=shape) > 0.7
    real_S = torch.from_numpy(np.where(seg, 1.0, -1.0).astype(np.float32)).to(DEVICE)
    return shape, real_I, real_S


def check_test_step(conv_ops, in_ops, skel_ops, want=TEST_LAUNCHES, tag="test_step",
                    bf16_spread_runs=0, sample=(N, N, N), **cfg_kw):
    """The test step of the config with ``cfg_kw`` (phase 6: config 2) on a
    batch of 3 ``sample``s (SUBVOL_PATCH_SIZE their size; (H, W) in 2-D).

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

    cfg = VanGanConfig(SUBVOL_PATCH_SIZE=(sample[0],) * 3, BATCH_SIZE=STEP_BATCH,
                       cldice_iters=SKEL_ITERS, **cfg_kw)
    gan = VanGan(cfg, device=DEVICE)
    shape, real_I, real_S = step_batch(sample)

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


def tap_chunk_counters(ops):
    """The conv kernels' launches on the bodies above 64 taps: K1's and K3's
    on the tap chunks (route 2), K1's and K3's on route 3, K2's on routes 2
    and 3."""
    return {"conv3d_fwd": ops[0].tap_chunk_launches,
            "conv3d_wgrad": ops[0].wgrad_tap_chunk_launches,
            "conv3d_fwd_pairs": ops[0].pair_launches,
            "conv3d_wgrad_pairs": ops[0].wgrad_pair_launches,
            "conv3d_dgrad_taps": ops[0].dgrad_tap_launches}


def reset_counters(ops):
    conv_ops, in_ops, skel_ops = ops
    conv_ops.launches = conv_ops.dgrad_launches = conv_ops.dgrad_fold_launches = 0
    conv_ops.wgrad_launches = conv_ops.tap_chunk_launches = 0
    conv_ops.wgrad_tap_chunk_launches = conv_ops.pair_launches = 0
    conv_ops.wgrad_pair_launches = conv_ops.dgrad_tap_launches = 0
    in_ops.launches = in_ops.bwd_launches = in_ops.fwd_kernel_launches = 0
    skel_ops.launches = skel_ops.bwd_launches = skel_ops.bwd_kernel_launches = 0


def rel_l2(a, b):
    return float((a - b).norm() / b.norm())


def rel_loss(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def f32_agreement(kernel, plain, perturbed):
    """Phase 8's f32 measures, kernel path against plain path: ``kernel`` and
    ``plain`` are (flat f32 gradient per network, losses) from the same
    weights and draws, ``perturbed`` the plain path's gradients with every
    weight scaled by (1 + 1e-6 N(0, 1)), one per draw; the spread is the
    largest draw's distance (``require_f32`` holds them to the rules)."""
    (gk, lk), (gp, lp) = kernel, plain
    return {"losses": {k: rel_loss(lk[k], lp[k]) for k in lp},
            "grads": {n: {"kernel_vs_plain": rel_l2(gk[n], gp[n]),
                          "plain_perturbed_vs_plain": max(rel_l2(d[n], gp[n])
                                                          for d in perturbed)}
                      for n in gp}}


def require_f32(tag, out):
    """Phase 8's f32 rules on ``f32_agreement``'s measures: each loss within
    1e-3 relative, each gradient within SPREAD_FACTOR x the plain path's
    spread."""
    for k, v in out["losses"].items():
        require(v <= 1e-3, f"{tag} {k}: f32 kernel loss {v:.3e} relative from plain")
    for n, v in out["grads"].items():
        require(v["kernel_vs_plain"] <= SPREAD_FACTOR * v["plain_perturbed_vs_plain"],
                f"{tag} {n}: f32 kernel gradient {v['kernel_vs_plain']:.3e} from plain, "
                f"the plain path's spread {v['plain_perturbed_vs_plain']:.3e}")


def bf16_agreement(kernel16, plain16, plain32):
    """Each network's bf16 kernel and bf16 plain gradient, relative L2 from
    the f32 plain one (flat f32 gradients per network)."""
    return {n: {"kernel_vs_f32": rel_l2(kernel16[n], plain32[n]),
                "plain_vs_f32": rel_l2(plain16[n], plain32[n])} for n in plain32}


def require_bf16(tag, out):
    """Phase 8's bf16 rule: the kernel path within max(3x the plain path's
    distance, 1e-3) of the f32 gradient."""
    for n, v in out.items():
        require(v["kernel_vs_f32"] <= max(3 * v["plain_vs_f32"], 1e-3),
                f"{tag} {n}: bf16 kernel gradient too far from f32: {v}")


def path_agreement(tag, grads_of, f32_crop=None, signed=(), spread_draws=1):
    """Phase 8's rules, kernel path against plain path, from ``grads_of(kernels,
    dtype, n, crop=N, perturb=0.0)`` -> (flat f32 gradient per network,
    losses) of the first ``n`` samples cropped to ``crop``^3 from the same
    seeded weights and draws: f32 losses within 1e-3 relative and gradients
    within SPREAD_FACTOR x the plain path's spread, the bf16 rules on one
    sample and on the batch (the losses named in ``signed`` by their
    absolute differences); with ``f32_crop`` the f32 checks also on the whole
    batch cropped to ``f32_crop``^3. With ``spread_draws`` > 1 the spread is
    the largest of that many perturbation draws (``grads_of(..., draw=i)``,
    see ``TWOD_SPREAD_DRAWS``). Prints and returns the report."""
    from vangan_torch.training.state import NETWORKS

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
    if spread_draws == 1:
        draws = [grads_of(False, f32, 1, perturb=1e-6)[0]]
    else:
        draws = [grads_of(False, f32, 1, perturb=1e-6, draw=i)[0] for i in range(spread_draws)]
    crop = {}
    if f32_crop:
        for kernels in (True, False):
            crop[kernels] = grads_of(kernels, f32, STEP_BATCH, f32_crop)
        crop["perturbed"] = grads_of(False, f32, STEP_BATCH, f32_crop, 1e-6)[0]
    one, full = 1, STEP_BATCH
    f32_out = f32_agreement((grads[True, f32, one], losses[True, f32, one]),
                            (grads[False, f32, one], losses[False, f32, one]), draws)
    bf16_out = bf16_agreement(grads[True, bf16, one], grads[False, bf16, one],
                              grads[False, f32, one])
    if crop:
        crop = f32_agreement(crop[True], crop[False], [crop["perturbed"]])
    report = {"losses": {}, "grads": {}}
    for key, r in losses[False, f32, one].items():
        k16_3, p16_3 = losses[True, bf16, full][key], losses[False, bf16, full][key]
        report["losses"][key] = {
            "f32_plain": r, "f32_kernel": losses[True, f32, one][key],
            "bf16_kernel": losses[True, bf16, one][key],
            "bf16_plain": losses[False, bf16, one][key],
            "f32_rel": f32_out["losses"][key],
            "bf16_kernel_vs_plain": rel_loss(losses[True, bf16, one][key],
                                             losses[False, bf16, one][key]),
            "batch3_bf16_kernel": k16_3, "batch3_bf16_plain": p16_3,
            "batch3_bf16_kernel_vs_plain": rel_loss(k16_3, p16_3)}
        if crop:
            report["losses"][key]["crop_f32_batch3_rel"] = crop["losses"][key]
    for n in NETWORKS:
        ref = grads[False, f32, one][n]
        p16_3 = grads[False, bf16, full][n]
        report["grads"][n] = {
            "f32_kernel_vs_plain": f32_out["grads"][n]["kernel_vs_plain"],
            "f32_plain_perturbed_vs_plain": f32_out["grads"][n]["plain_perturbed_vs_plain"],
            "f32_plain_perturbed_draws": [rel_l2(d[n], ref) for d in draws],
            "bf16_kernel_vs_f32": bf16_out[n]["kernel_vs_f32"],
            "bf16_plain_vs_f32": bf16_out[n]["plain_vs_f32"],
            "bf16_kernel_vs_plain": rel_l2(grads[True, bf16, one][n],
                                           grads[False, bf16, one][n]),
            "batch3_bf16_kernel_vs_plain": rel_l2(grads[True, bf16, full][n], p16_3),
            # what a fault that drops two samples' share would read
            "control_batch1_vs_batch3_plain": rel_l2(grads[False, bf16, one][n], p16_3)}
        if crop:
            report["grads"][n].update({
                "crop_f32_batch3_kernel_vs_plain": crop["grads"][n]["kernel_vs_plain"],
                "crop_f32_batch3_plain_perturbed_vs_plain":
                    crop["grads"][n]["plain_perturbed_vs_plain"]})
    del grads
    print(f"{tag}_agreement", json.dumps(report))
    require_f32(tag, f32_out)
    require_bf16(tag, bf16_out)
    if crop:
        require_f32(f"{tag} at batch {STEP_BATCH} on the crop", crop)
    for key, v in report["losses"].items():
        # at batch 3 no f32 reference fits: the bf16 paths may differ there
        # by 3x what they differ by on one sample; a signed loss (the
        # Wasserstein values, means of scores of either sign) by its
        # absolute difference, since its value at batch 3 may lie near 0
        if key in signed:
            d3 = abs(v["batch3_bf16_kernel"] - v["batch3_bf16_plain"])
            d1 = abs(v["bf16_kernel"] - v["bf16_plain"])
            require(d3 <= max(3 * d1, 1e-3 * abs(v["f32_plain"])),
                    f"{tag} {key} at batch {STEP_BATCH}: bf16 kernel vs plain: {v}")
        else:
            require(v["batch3_bf16_kernel_vs_plain"] <= max(3 * v["bf16_kernel_vs_plain"],
                                                            1e-3),
                    f"{tag} {key} at batch {STEP_BATCH}: bf16 kernel vs plain: {v}")
    for n, v in report["grads"].items():
        require(v["batch3_bf16_kernel_vs_plain"] <= max(3 * v["bf16_kernel_vs_plain"], 1e-3),
                f"{tag} {n}: bf16 kernel gradient at batch {STEP_BATCH} too far from plain: {v}")
        # below what a step that dropped samples would read
        require(v["batch3_bf16_kernel_vs_plain"] < v["control_batch1_vs_batch3_plain"],
                f"{tag} {n}: bf16 kernel gradient at batch {STEP_BATCH} as far from plain "
                f"as one sample's: {v}")

    return report


def train_steps_in_turns(gan, real_I, real_S):
    """ms per train step of the kernel and the plain path, three each in
    turns (plain, kernel, kernel, plain, plain, kernel), and each path's peak
    memory; the caller has warmed both up. Leaves the kernels on."""
    times, peak = {"kernel": [], "plain": []}, {"kernel": 0.0, "plain": 0.0}
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
    return {"kernel_ms_per_step": float(np.median(times["kernel"])),
            "plain_ms_per_step": float(np.median(times["plain"])),
            "kernel_ms_all": times["kernel"], "plain_ms_all": times["plain"],
            "kernel_peak_gib": peak["kernel"], "plain_peak_gib": peak["plain"]}


def check_train_step(ops, want=TRAIN_LAUNCHES, want_kernels=TRAIN_KERNEL_LAUNCHES,
                     tag="train_step", f32_crop=None, sample=(N, N, N), spread_draws=1,
                     want_tap_chunks=NO_TAP_CHUNKS, **cfg_kw):
    """The train step of the config with ``cfg_kw`` (phase 8: config 2) on a
    batch of 3 ``sample``s (SUBVOL_PATCH_SIZE their size; (H, W) in 2-D).
    Every parameter tensor must move in the step, and every running
    statistic (BatchNorm buffer) must stay finite and move. With
    ``f32_crop`` the f32 checks also run on the whole batch, cropped to
    ``f32_crop``^3 (where the f32 plain path fits), so that they hold the
    kernels' sums over the samples. The conv launches on the bodies above 64
    taps (``tap_chunk_counters``) must be ``want_tap_chunks``."""
    import copy

    from vangan_torch.config import VanGanConfig
    from vangan_torch.training import step
    from vangan_torch.training.state import NETWORKS, make_train_state
    from vangan_torch.vangan import VanGan

    cfg = VanGanConfig(SUBVOL_PATCH_SIZE=(sample[0],) * 3, BATCH_SIZE=STEP_BATCH,
                       cldice_iters=SKEL_ITERS, **cfg_kw)
    gan = VanGan(cfg, device=DEVICE)
    init = {name: copy.deepcopy(net.state_dict()) for name, net in gan.nets.items()}
    shape, real_I, real_S = step_batch(sample)

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
    tap_chunks = tap_chunk_counters(ops)
    require(launches == want, f"{tag}: one step launched {launches}, expected {want}")
    require(kernel_launches == want_kernels, f"{tag}: one step launched "
            f"{kernel_launches} kernels, expected {want_kernels}")
    require(tap_chunks == want_tap_chunks, f"{tag}: one step launched {tap_chunks} on the "
            f"tap chunks, expected {want_tap_chunks}")
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

    def grads_of(kernels, dtype, n, crop=N, perturb=0.0, draw=0):
        """Gradients (flat f32 per network) and losses of the first ``n``
        samples cropped to ``crop`` on each axis, from the seeded weights and
        noise draws; with ``perturb``, every weight scaled by (1 + perturb
        N(0, 1)), the ``draw``-th such draw."""
        reset(kernels, dtype)
        if perturb:
            with torch.no_grad():
                pg = torch.Generator(device=DEVICE).manual_seed(SEED + 6 + draw)
                for net in gan.nets.values():
                    for prm in net.parameters():
                        prm.mul_(1 + perturb * torch.randn(prm.shape, device=DEVICE,
                                                           generator=pg))
        box = (slice(0, n),) + (slice(0, crop),) * len(sample)
        g, res = step.compute_grads(gan.nets, cfg, gan.scales, real_I[box].contiguous(),
                                    real_S[box].contiguous(), NOISE, gan.generator)
        return ({name: torch.cat([t.float().flatten() for t in g[name]]) for name in NETWORKS},
                {k: float(v) for k, v in res.items()})

    path_agreement(tag, grads_of, f32_crop, spread_draws=spread_draws)

    # ms per step of both paths in turns, after a warm-up step of each
    for path in ("kernel", "plain"):
        reset(path == "kernel", torch.bfloat16)
        gan.distributed_train_step(real_I, real_S, NOISE, True)
    res = {"batch": list(shape), "noise_std": NOISE, "launches": launches,
           "kernel_launches": kernel_launches, "tap_chunk_launches": tap_chunks,
           "losses": step_losses, "moved": moved_report,
           **train_steps_in_turns(gan, real_I, real_S)}
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


def check_generator_family(name, model, ops, out_channels=1):
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
    gy = torch.from_numpy(rng.normal(size=(1, N, N, N, out_channels)).astype(np.float32)
                          ).to(DEVICE)
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
    require(k16.shape == gy.shape and bool(torch.isfinite(k16).all()) and
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
    at the ResNet's kernel conv shapes (343 taps: its 7^3 head takes K1 and
    K3 on the tap chunks and K2 on route 3, its stem K1 and K3 on route 3
    and K2 on the tap chunks), timed against their plain versions and cuDNN
    as in phase 2."""
    from vangan_torch.config import VanGanConfig
    from vangan_torch.models.factory import build_generator
    from vangan_torch.models.resunet import ResUNet3D

    g = torch.Generator().manual_seed(SEED)
    families = {
        "resunet_deconv": lambda: ResUNet3D(16, 4, upsample_mode="deconv", generator=g),
        "resunet_attention": lambda: ResUNet3D(16, 4, upsample_mode="simple",
                                               use_attention_gate=True, generator=g),
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


def check_resnet_step(ops, resnet_rows):
    """Phase 17: the ResNet CycleGAN's train step at full width (phase 8's
    checks, ``RESNET_TRAIN_LAUNCHES``, the launches on the bodies above 64
    taps of ``RESNET_TAP_CHUNKS``, each 343-tap plan on its body of
    ``RESNET_343_BODIES``), and where its 343-tap convs' time goes: each
    kernel's launches in one step (``RESNET_343_LAUNCHES``) times its bf16 ms
    at batch 3 from phase 11's rows (``resnet_rows``), against the step's
    kernel ms."""
    t0 = time.perf_counter()
    train = check_train_step(ops, RESNET_TRAIN_LAUNCHES, RESNET_TRAIN_KERNEL_LAUNCHES,
                             "resnet_train_step", want_tap_chunks=RESNET_TAP_CHUNKS, **RESNET)
    torch.cuda.empty_cache()
    rows = {r["convs"][0]: r for r in resnet_rows}
    convs, total = {}, 0.0
    for name, counts in RESNET_343_LAUNCHES.items():
        r, parts = rows[name], {}
        bodies = tuple(r["plan"][op]["body"] for op in ("fwd", "dgrad", "wgrad"))
        require(bodies == RESNET_343_BODIES[name], f"resnet {name}: K1, K2, K3 on bodies "
                f"{bodies}, expected {RESNET_343_BODIES[name]}")
        for op, n in zip(("fwd", "dgrad", "wgrad"), counts):
            parts[op] = {"launches": n, "route": r["plan"][op]["route"],
                         "body": r["plan"][op]["body"],
                         "tap_chunks": r["plan"][op]["tap_chunks"],
                         "ms_each": r[f"{op}_bf16_ms"], "ms": n * r[f"{op}_bf16_ms"],
                         "library_ms_each": r[f"{op}_bf16_library_ms"],
                         "bound_ms_each": r["bound"][op][0]}
            total += n * r[f"{op}_bf16_ms"]
        convs[name] = parts
    step_ms = train["kernel_ms_per_step"]
    res = {"kernel_ms_per_step": step_ms, "plain_ms_per_step": train["plain_ms_per_step"],
           "kernel_peak_gib": train["kernel_peak_gib"], "plain_peak_gib": train["plain_peak_gib"],
           "launches": train["launches"], "tap_chunk_launches": train["tap_chunk_launches"],
           "convs_343": convs, "convs_343_ms": total, "convs_343_share": total / step_ms,
           "phase_s": time.perf_counter() - t0}
    print("resnet_step", json.dumps(res))
    return res


def write_raw_tiff(path, vol_xyz):
    """A raw TIFF as a lab's instrument writes one: a page per z, each page
    (x rows, y columns), in the array's dtype (uint8 or uint16 pages), so
    that preprocessing reads it back as (x, y, z)."""
    from PIL import Image

    pages = [Image.fromarray(np.ascontiguousarray(p)) for p in np.transpose(vol_xyz, (2, 0, 1))]
    pages[0].save(path, format="TIFF", save_all=True, append_images=pages[1:])


def check_data_eval(ops, card):
    """Phase 12: preprocess, raw-TIFF predict and evaluate_segmentation."""
    from vangan_torch import cli, metrics
    from vangan_torch.config import VanGanConfig
    from vangan_torch.data.preprocess import read_tiff
    from vangan_torch.inference.stitcher import stitch_subvolumes
    from vangan_torch.ops import morphology
    from vangan_torch.ops.norms import min_max_norm
    from vangan_torch.vangan import VanGan

    conv_ops, in_ops, skel_ops = ops
    res = {"card": card, "raw_shape": list(RAW_SHAPE), "volume": list(VOLUME_SHAPE)}
    n_raw, n_vol = math.prod(RAW_SHAPE), math.prod(VOLUME_SHAPE)
    rng = np.random.default_rng(SEED + 12)
    with tempfile.TemporaryDirectory(prefix="vangan_smoke_data_") as tmp:
        raw_a, raw_b = os.path.join(tmp, "rawA"), os.path.join(tmp, "rawB")
        data, pred = os.path.join(tmp, "data"), os.path.join(tmp, "pred")
        os.makedirs(raw_a)
        os.makedirs(raw_b)
        # (a) seeded raw TIFFs at the config's sizes
        t0 = time.perf_counter()
        segs = {}
        for i in range(RAW_VOLUMES):
            write_raw_tiff(os.path.join(raw_a, f"img{i}.tiff"),
                           rng.integers(0, 4096, RAW_SHAPE, dtype=np.uint16))
            segs[f"seg{i}"] = tubes(rng)
            write_raw_tiff(os.path.join(raw_b, f"seg{i}.tiff"),
                           np.where(segs[f"seg{i}"][..., 0] > 0, 255, 0).astype(np.uint8))
        res["raw_write_s"] = time.perf_counter() - t0
        cfg = VanGanConfig(SUBVOL_PATCH_SIZE=(N, N, N), stitcher_batch=BATCH, seed=SEED)
        require(cfg.RAW_IMG_SIZE[:3] == RAW_SHAPE and cfg.TARG_RAW_IMG_SIZE == VOLUME_SHAPE
                and cfg.SYNTH_IMG_SIZE == VOLUME_SHAPE[:3], "the config's sizes")
        cfg_path, weights = os.path.join(tmp, "cfg.yaml"), os.path.join(tmp, "weights.pt")
        cfg.to_yaml(cfg_path)
        VanGan(cfg, device=DEVICE).save_weights(weights)

        # (b) preprocess, on the host
        t0 = time.perf_counter()
        cli.main(["preprocess", "--config", cfg_path, "--imaging-raw", raw_a, "--seg-raw", raw_b,
                  "--data-dir", data, "--resize", "--preprocess", "rsom"])
        res["preprocess_s"] = time.perf_counter() - t0
        res["preprocess_mvox_per_s"] = RAW_VOLUMES * (n_raw + n_vol) / res["preprocess_s"] / 1e6
        counts = {}
        for pid in ("A", "B"):
            with open(os.path.join(data, f"data{pid}_partition.pkl"), "rb") as f:
                part = pickle.load(f)
            counts[pid] = {k: len(v) for k, v in part.items()}
            require(counts[pid] == {"training": 0, "validation": 1, "testing": 1},
                    f"partition {pid}: {counts[pid]}")
            for path in (p for v in part.values() for p in v):
                v = np.load(path)
                require(v.shape == VOLUME_SHAPE and v.dtype == np.float32,
                        f"{path}: {v.shape} {v.dtype}")
                if pid == "A":
                    require(float(v.min()) >= -1.0 and float(v.max()) <= 1.0,
                            f"{path} outside [-1, 1]")
                else:
                    name = os.path.splitext(os.path.basename(path))[0]
                    require(np.array_equal(v, segs[name]), f"{path} is not the +-1 tubes written")
        res["partitions"] = counts

        # (c) predict on the raw TIFFs: preprocessed on the host, stitched on the card
        n_pred = predict_batches(VOLUME_SHAPE, STRIDE)
        torch.cuda.synchronize()
        reset_counters(ops)
        t0 = time.perf_counter()
        cli.main(["predict", "--config", cfg_path, "--input", raw_a, "--output", pred,
                  "--weights", weights, "--stride", str(STRIDE), str(STRIDE), str(STRIDE),
                  "--resize", "--preprocess", "rsom", "--device", DEVICE])
        torch.cuda.synchronize()
        res["predict_s"] = time.perf_counter() - t0
        res["predict_mvox_per_s"] = RAW_VOLUMES * n_vol / res["predict_s"] / 1e6
        launches = {k: v for k, v in counters(ops).items() if v}
        want = {"conv3d_fwd": CONV_PATH_CALLS * RAW_VOLUMES * n_pred,
                "instnorm_fwd": IN_PATH_CALLS * RAW_VOLUMES * n_pred}
        require(launches == want, f"raw-TIFF predict launched {launches}, expected {want}")
        res["predict_launches"] = launches
        vols = {}
        for i in range(RAW_VOLUMES):
            out = read_tiff(os.path.join(pred, f"VANGAN_img{i}.tiff"))
            require(out.shape == (VOLUME_SHAPE[2], *VOLUME_SHAPE[:2], 1), f"TIFF {out.shape}")
            require(bool(np.isfinite(out).all()) and out.min() >= 0.0 and out.max() <= 255.0,
                    f"VANGAN_img{i}.tiff not finite or outside [0, 255]")
            vols[i] = np.transpose(out, (1, 2, 0, 3))  # (x, y, z, 1)
        gan = VanGan(cfg, device=DEVICE)
        gan.load_weights(weights)
        gan.gen_IS.set_use_kernels(False)
        img0 = np.load(os.path.join(pred, "preprocessed_npy", "img0.npy"))
        plain = {}
        for dtype in (torch.bfloat16, torch.float32):
            gan.gen_IS.dtype = dtype
            plain[dtype] = torch.from_numpy(stitch_subvolumes(
                gan.gen_IS_batched, img0, cfg.subvol_size, stride=(STRIDE,) * 3,
                complete=True, padFactor=0.25, save=False, batch_size=cfg.stitcher_batch,
                device=DEVICE))
        res["predict_grey_levels"] = bf16_vs_reference(torch.from_numpy(vols[0]),
                                                       plain[torch.bfloat16],
                                                       plain[torch.float32], "raw predict")
        del gan, plain

        # (d) evaluate_segmentation on the card, against the plain skeleton's scores
        truth = tubes(np.random.default_rng(SEED + 13))[..., 0]
        p = vols[0][..., 0]
        torch.cuda.synchronize()
        reset_counters(ops)
        t0 = time.perf_counter()
        scores = metrics.evaluate_segmentation(p, truth, iters=SKEL_ITERS, device=DEVICE)
        torch.cuda.synchronize()
        res["eval_s"] = time.perf_counter() - t0
        res["metric_launches"] = skel_ops.launches
        require(skel_ops.launches == 2 * (SKEL_ITERS + 1),
                f"evaluate_segmentation launched K6 {skel_ops.launches} times")
        # the same call on the plain skeleton: skeleton.soft_skel swapped for
        # morphology.soft_skel for its length
        real_skel = skel_ops.soft_skel
        skel_ops.soft_skel = morphology.soft_skel
        try:
            t0 = time.perf_counter()
            plain_scores = metrics.evaluate_segmentation(p, truth, iters=SKEL_ITERS,
                                                         device=DEVICE)
            torch.cuda.synchronize()
            res["eval_plain_s"] = time.perf_counter() - t0
        finally:
            skel_ops.soft_skel = real_skel
        require(skel_ops.launches == 2 * (SKEL_ITERS + 1), "the plain metric launched K6")
        res["eval_mvox_per_s"] = n_vol / res["eval_s"] / 1e6
        require(scores == plain_scores and all(0.0 <= v <= 1.0 for v in scores.values()),
                f"scores {scores} vs plain {plain_scores}")
        res["scores"] = scores

    # (e) K6 at whole-volume and odd shapes, bit-exact
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 14)
    inputs = {"truth": truth, "binarised_prediction": metrics.binarise_prediction(p)}
    res["skel_max_abs_err"], res["skel_ms"], res["skel_plain_ms"] = {}, {}, {}
    with torch.inference_mode():
        cases = {k: torch.from_numpy(v).to(DEVICE)[None, ..., None] for k, v in inputs.items()}
        cases["tanh_noise"] = min_max_norm(torch.tanh(torch.randn(
            (1, *VOLUME_SHAPE), device=DEVICE, generator=g)))
        cases["odd_tanh_noise"] = min_max_norm(torch.tanh(torch.randn(
            ODD_SKEL_SHAPE, device=DEVICE, generator=g)))
        cases["odd_binary"] = (torch.rand(ODD_SKEL_SHAPE, device=DEVICE, generator=g)
                               > 0.6).float()
        for tag, x in cases.items():
            got, want = skel_ops.soft_skel(x, SKEL_ITERS), morphology.soft_skel(x, SKEL_ITERS)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            require(got.shape == want.shape and err == 0.0,
                    f"soft_skel kernel vs plain on {tag} {tuple(x.shape)}: max |diff| {err:.3e}")
            res["skel_max_abs_err"][tag] = err
            res["skel_ms"][tag] = cuda_ms(lambda: skel_ops.soft_skel(x, SKEL_ITERS))
            res["skel_plain_ms"][tag] = cuda_ms(lambda: morphology.soft_skel(x, SKEL_ITERS))
    res["skel_bound"] = skel_fwd_bound(n_vol)
    print("data_eval", json.dumps(res))
    return res


def ncritic_flags(ncritic, steps):
    """The generator-update flags of ``steps`` train steps from a fresh
    VanGan, by the bookkeeping of ``vangan_tpu/vangan.py:224-230``: icritic
    from 1, the flag up at first, raised when icritic reaches ncritic and
    lowered after every step."""
    icritic, update, flags = 1, True, []
    for _ in range(steps):
        if icritic % ncritic == 0:
            update, icritic = True, 1
        else:
            icritic += 1
        flags.append(update)
        update = False
    return flags


def check_double_backward(disc_shapes, tol):
    """The second derivatives the gradient penalty takes, alone, kernel path
    against torch's double backward of the plain versions, at batch 3: the
    conv0 input gradient's (d/dgy on K1, d/dw on K3) and the critic norms'
    (d/dx, d/dgamma, d/dgy: torch ops on K4's statistics and K5's sums), in
    f32 (1e-4 x max |ref|; d/dw, a weight gradient, 1e-3) and bf16 (2e-2),
    with CUDA event times of the double backward alone (median of 5); for a
    norm also its bound in bf16: x, g and the cotangent of dx read, d/dx and
    d/dg written once (its few f32 operations an element are far below)."""
    from vangan_torch.models.layers import ConvND
    from vangan_torch.ops.conv3d import conv3d, conv3d_plain, norm_padding
    from vangan_torch.ops.instnorm import instance_norm_act, instance_norm_act_plain

    g = torch.Generator(device=DEVICE).manual_seed(SEED + 13)
    rows = []

    def rnd(shape, dtype=torch.float32):
        return torch.randn(shape, device=DEVICE, generator=g).to(dtype)

    for name, mod, in_shape in disc_shapes:
        if isinstance(mod, ConvND) and max(mod.weight.shape[:2]) >= 128:
            continue  # cuDNN's
        shape = (STEP_BATCH, *in_shape[1:])
        row = {"name": name, "shape": list(shape)}
        for dtype in (torch.float32, torch.bfloat16):
            tag = "f32" if dtype == torch.float32 else "bf16"
            if isinstance(mod, ConvND):
                w = (rnd(mod.weight.shape) * 0.1).requires_grad_()
                x = rnd(shape, dtype).requires_grad_()
                pads = norm_padding(mod.padding, mod.kernel_size, mod.strides, shape[2:])
                y_shape = conv3d_plain(x.detach(), w.detach(), None, mod.strides, pads,
                                       mod.pad_mode).shape
                gy, r = rnd(y_shape, dtype).requires_grad_(), rnd(shape)
                wrt, names = (gy, w), ("gy", "w")

                def first(plain):
                    fn = conv3d_plain if plain else conv3d
                    y = fn(x, w, None, mod.strides, pads, mod.pad_mode)
                    dx, = torch.autograd.grad(y, x, gy, create_graph=True)
                    return (dx.float() * r).sum()
            else:
                c = shape[1]
                x = (rnd(shape) * 2 + 0.5).to(dtype).requires_grad_()
                gamma = (torch.rand(c, device=DEVICE, generator=g) + 0.5).requires_grad_()
                beta = (rnd(c) * 0.3).requires_grad_()
                gy, r = rnd(shape, dtype).requires_grad_(), rnd(shape)
                p, q = rnd(c), rnd(c)
                wrt, names = (x, gamma, gy), ("x", "gamma", "gy")
                row["bound_bf16"] = bound(0, 5 * 2 * math.prod(shape), BF16_FLOP_PER_S)

                def first(plain):
                    fn = instance_norm_act_plain if plain else instance_norm_act
                    y = fn(x, gamma, beta, mod.epsilon, mod.act, mod.leaky_slope)
                    dx, dgam, dbet = torch.autograd.grad(y, (x, gamma, beta), gy,
                                                         create_graph=True)
                    return (dx.float() * r).sum() + (dgam * p).sum() + (dbet * q).sum()

            out = {}
            for plain in (False, True):
                s_ = first(plain)
                out[plain] = torch.autograd.grad(s_, wrt, retain_graph=True, allow_unused=True,
                                                 materialize_grads=True)
                row[f"{tag}_{'plain_' if plain else ''}ms"] = cuda_ms(
                    lambda: torch.autograd.grad(s_, wrt, retain_graph=True, allow_unused=True,
                                                materialize_grads=True))
                del s_
            for part, a, e in zip(names, out[False], out[True]):
                _, rel_err = errs(a, e)
                row[f"{tag}_{part}_rel_err"] = rel_err
                limit = tol[dtype] * (10 if part == "w" and dtype == torch.float32 else 1)
                require(rel_err <= limit, f"double backward at {name} {tag} d/d{part}: "
                        f"{rel_err:.3e} > {limit}")
        rows.append(row)
        print("wgan_double_backward", json.dumps(row))
    torch.cuda.empty_cache()
    return rows


def check_wgan(ops, tol, disc_shapes):
    """Phase 13: WGAN-GP training, BASELINE config 2 with wasserstein: true,
    at full width (3 x 128^3, bf16, noise sigma 0.1, dropout on)."""
    import copy

    from vangan_torch.config import VanGanConfig
    from vangan_torch.monitor import profiling
    from vangan_torch.training import step
    from vangan_torch.training.state import NETWORKS, make_train_state
    from vangan_torch.vangan import VanGan
    from vangan_torch.vangan import train as train_epoch

    cfg = VanGanConfig(SUBVOL_PATCH_SIZE=(N, N, N), BATCH_SIZE=STEP_BATCH,
                       cldice_iters=SKEL_ITERS, wasserstein=True)
    gan = VanGan(cfg, device=DEVICE)
    init = {name: copy.deepcopy(net.state_dict()) for name, net in gan.nets.items()}
    shape, real_I, real_S = step_batch()
    bf16, f32 = torch.bfloat16, torch.float32
    penalties = []
    real_gp = step.gradient_penalty

    def recorded_gp(*args, **kwargs):
        value = real_gp(*args, **kwargs)
        penalties.append(value.detach())
        return value

    def reset(kernels, dtype, at_step=0):
        """Seeded weights, fresh optimizers at step ``at_step`` (the penalty is
        on from step 1), the same draws, a fresh ncritic count."""
        for name, net in gan.nets.items():
            net.load_state_dict(init[name])
            net.dtype = dtype
        gan.set_use_kernels(kernels)
        gan.state = make_train_state(gan.nets, cfg, gan.steps_per_epoch)
        gan.state.step = at_step
        gan.generator.manual_seed(SEED + 5)
        gan.icritic, gan.updateGen = 1, True

    res = {"batch": list(shape), "noise_std": NOISE, "gp_weight": cfg.gp_weight,
           "launches": {}, "kernel_launches": {}, "losses": {}, "gradient_penalty": {}}
    step.gradient_penalty = recorded_gp
    try:
        # the main path: steps 0 (no penalty) and 1 (penalty on), bf16, on the kernels
        reset(True, bf16)
        for k in (0, 1):
            torch.cuda.synchronize()
            reset_counters(ops)
            penalties.clear()
            out = gan.distributed_train_step(real_I, real_S, NOISE, True)
            torch.cuda.synchronize()
            launches, kernel_launches = counters(ops), kernel_counters(ops)
            require(launches == WGAN_LAUNCHES[k],
                    f"wgan step {k} launched {launches}, expected {WGAN_LAUNCHES[k]}")
            require(kernel_launches == WGAN_KERNEL_LAUNCHES[k], f"wgan step {k} launched "
                    f"{kernel_launches} kernels, expected {WGAN_KERNEL_LAUNCHES[k]}")
            losses = {key: float(v) for key, v in out.items()}
            require(len(losses) == 10 and all(math.isfinite(v) for v in losses.values()),
                    f"wgan step {k}: losses not all finite: {losses}")
            gps = [float(v) for v in penalties]
            require(len(gps) == 2 * k and all(math.isfinite(v) and v > 0 for v in gps),
                    f"wgan step {k}: gradient penalties {gps}")
            res["launches"][k], res["kernel_launches"][k] = launches, kernel_launches
            res["losses"][k], res["gradient_penalty"][k] = losses, gps
        moved = {}
        for name, net in gan.nets.items():
            changed = {pn: not torch.equal(prm.detach(), init[name][pn].to(prm.device))
                       for pn, prm in net.named_parameters()}
            require(all(torch.isfinite(prm).all() for prm in net.parameters()),
                    f"wgan {name}: non-finite parameters")
            # w_dense.bias shifts every score of a critic alike: the
            # Wasserstein losses and the penalty do not see it, its gradient
            # is 0 and Adam leaves it
            frozen = [pn for pn, c in changed.items() if not c]
            require(frozen == (["w_dense.bias"] if name.startswith("disc") else []),
                    f"wgan {name}: parameters not moved in two steps: {frozen}")
            moved[name] = sum(changed.values())
        res["params_moved"] = moved

        # kernel path against plain path, the penalty on (gp_scale 10): phase 8's rules
        def grads_of(kernels, dtype, n, crop=N, perturb=0.0):
            reset(kernels, dtype, at_step=1)
            if perturb:
                with torch.no_grad():
                    pg = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
                    for net in gan.nets.values():
                        for prm in net.parameters():
                            prm.mul_(1 + perturb * torch.randn(prm.shape, device=DEVICE,
                                                               generator=pg))
            box = (slice(0, n), slice(0, crop), slice(0, crop), slice(0, crop))
            grads, r = step.compute_grads(gan.nets, cfg, gan.scales, real_I[box].contiguous(),
                                          real_S[box].contiguous(), NOISE, gan.generator,
                                          gp_scale=cfg.gp_weight)
            return ({name: torch.cat([t.float().flatten() for t in grads[name]])
                     for name in NETWORKS}, {key: float(v) for key, v in r.items()})

        res["agreement"] = path_agreement(
            "wgan_step", grads_of, signed=("gen_IS_loss", "gen_SI_loss", "D_I_loss", "D_S_loss"))
        torch.cuda.empty_cache()
    finally:
        step.gradient_penalty = real_gp

    res["double_backward"] = check_double_backward(disc_shapes, tol)
    db = {"kernel": 0.0, "plain": 0.0, "bound": 0.0}
    for row in res["double_backward"]:
        if row["name"] != "conv0":  # the norms' double backward, 2 critics a step
            db["kernel"] += 2 * row["bf16_ms"]
            db["plain"] += 2 * row["bf16_plain_ms"]
            db["bound"] += 2 * row["bound_bf16"][0]
    res["in_double_backward_ms_per_step"] = db

    # ncritic: train() over NCRITIC_STEPS steps moves the generators only at
    # the steps the JAX package's bookkeeping names
    reset(True, bf16)
    flags, gen_moved = [], []
    take_step = gan.distributed_train_step

    def recording_step(x, y, noise_std, update_gen):
        before = [prm.detach().clone() for prm in gan.gen_IS.parameters()]
        out = take_step(x, y, noise_std, update_gen)
        flags.append(bool(update_gen))
        gen_moved.append(any(not torch.equal(a, prm) for a, prm in
                             zip(before, gan.gen_IS.parameters())))
        return out

    class NoSummary:
        def scalar(self, *args, **kwargs):
            pass

    gan.distributed_train_step = recording_step
    try:
        train_epoch(iter([(real_I, real_S)] * NCRITIC_STEPS), gan, NoSummary(), epoch=0,
                    steps=NCRITIC_STEPS, training=True, noise_std=NOISE)
    finally:
        del gan.distributed_train_step
    want = ncritic_flags(cfg.ncritic, NCRITIC_STEPS)
    require(flags == want and gen_moved == want,
            f"ncritic {cfg.ncritic}: updates {flags}, generators moved {gen_moved}, "
            f"expected {want}")
    res["ncritic"] = {"ncritic": cfg.ncritic, "update_gen": flags, "gen_IS_moved": gen_moved}

    # ms per step, penalty off (step 0) and on, both paths in turns
    times = {f"{path}_gp_{gp}": [] for path in ("kernel", "plain") for gp in ("off", "on")}
    peak = {key: 0.0 for key in times}
    for gp in ("off", "on"):
        for path in ("kernel", "plain"):
            reset(path == "kernel", bf16, at_step=int(gp == "on"))
            gan.distributed_train_step(real_I, real_S, NOISE, True)
        for path in ("plain", "kernel", "kernel", "plain"):
            key = f"{path}_gp_{gp}"
            gan.set_use_kernels(path == "kernel")
            gan.state.step = int(gp == "on")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            gan.distributed_train_step(real_I, real_S, NOISE, True)
            b.record()
            b.synchronize()
            times[key].append(a.elapsed_time(b))
            peak[key] = max(peak[key], torch.cuda.max_memory_allocated() / 2**30)
    res["ms_per_step"] = {key: float(np.median(v)) for key, v in times.items()}
    res["ms_all"], res["peak_gib"] = times, peak

    # the step's phases on the kernel path, by the CUDA events of its spans
    res["phases_ms"] = {}
    for gp in ("off", "on"):
        reset(True, bf16, at_step=int(gp == "on"))
        gan.distributed_train_step(real_I, real_S, NOISE, True)
        gan.state.step = int(gp == "on")
        with profiling.recording(cuda_events=True) as spans:
            gan.distributed_train_step(real_I, real_S, NOISE, True)
        torch.cuda.synchronize()
        res["phases_ms"][gp] = {s.name.removeprefix("step."): profiling.elapsed_ms(s)
                                for s in spans if s.name.startswith("step")}
    on, off = res["phases_ms"]["on"], res["phases_ms"]["off"]
    res["gp_share"] = {
        "first_order_ms": on["gradient_penalty"],
        "backward_extra_ms": on["backward"] - off["backward"],
        "step_extra_ms": on["step"] - off["step"],
        "share_of_step": (on["step"] - off["step"]) / on["step"]}
    gan.set_use_kernels(True)
    del gan
    torch.cuda.empty_cache()
    print("wgan_step", json.dumps(res))
    return res


def twod_tubes(rng, n):
    """A seeded n x n binary image of random lines (the 2-D analog of
    ``tubes``, as ``examples/train_synthetic_torch.py``'s make_tube_image)."""
    seg = np.zeros((n, n), np.float32)
    xs, ys = np.arange(n, dtype=np.float32)[:, None], np.arange(n, dtype=np.float32)[None, :]
    for _ in range(TWOD_TUBES):
        p0 = rng.uniform(0, n, 2)
        d = rng.normal(size=2)
        d /= np.linalg.norm(d)
        px, py = xs - p0[0], ys - p0[1]
        t = px * d[0] + py * d[1]
        seg = np.maximum(seg, ((px - t * d[0]) ** 2 + (py - t * d[1]) ** 2
                               < rng.uniform(1.5, 4.0) ** 2).astype(np.float32))
    return seg


def time_twod_big_step(ops):
    """Config 2's 2-D train step at 512 x 512 (batch 3, bf16, noise sigma
    0.1, dropout on): the launches of ``TWOD_TRAIN_LAUNCHES``, ms of both
    paths in turns after a warm-up step of each, and peak memory."""
    from vangan_torch.config import VanGanConfig
    from vangan_torch.vangan import VanGan

    cfg = VanGanConfig(SUBVOL_PATCH_SIZE=(TWOD_BIG,) * 3, BATCH_SIZE=STEP_BATCH,
                       cldice_iters=SKEL_ITERS, **TWOD)
    gan = VanGan(cfg, device=DEVICE)
    shape, real_I, real_S = step_batch((TWOD_BIG, TWOD_BIG))
    torch.cuda.synchronize()
    reset_counters(ops)
    out = gan.distributed_train_step(real_I, real_S, NOISE, True)
    torch.cuda.synchronize()
    launches = counters(ops)
    require(launches == TWOD_TRAIN_LAUNCHES, f"twod_big_step: one step launched {launches}, "
            f"expected {TWOD_TRAIN_LAUNCHES}")
    require(all(math.isfinite(float(v)) for v in out.values()), "twod_big_step: losses")
    gan.set_use_kernels(False)
    gan.distributed_train_step(real_I, real_S, NOISE, True)  # the plain path's warm-up
    res = {"batch": list(shape), "launches": launches,
           **train_steps_in_turns(gan, real_I, real_S)}
    print("twod_big_step", json.dumps(res))
    return res


def check_twod_predict_and_metric(ops):
    """``predict`` through cli.main with a DIMENSIONS: 2 config on a seeded
    2048 x 2048 .npy image, stride 64 (phase 7's checks on one (h, w) page),
    then ``evaluate_segmentation`` of that prediction against seeded lines
    on the card: no skeleton kernel launch, scores equal to the CPU's."""
    from vangan_torch import cli
    from vangan_torch.config import VanGanConfig
    from vangan_torch.data.preprocess import read_tiff
    from vangan_torch.inference.stitcher import stitch_origins, stitch_subvolumes
    from vangan_torch.metrics import evaluate_segmentation
    from vangan_torch.vangan import VanGan

    conv_ops, in_ops, skel_ops = ops
    n = TWOD_IMAGE
    cfg = VanGanConfig(SUBVOL_PATCH_SIZE=(TWOD_N,) * 3, stitcher_batch=BATCH, **TWOD)
    with tempfile.TemporaryDirectory(prefix="vangan_smoke_2d_") as tmp:
        in_dir, out_dir = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        os.makedirs(in_dir)
        rng = np.random.default_rng(SEED + 14)
        img = rng.normal(100.0, 40.0, (n, n, 1)).astype(np.float32)
        np.save(os.path.join(in_dir, "img.npy"), img)
        weights, cfg_path = os.path.join(tmp, "weights.pt"), os.path.join(tmp, "cfg.yaml")
        VanGan(cfg, device=DEVICE).save_weights(weights)
        cfg.to_yaml(cfg_path)
        pad = int(0.25 * n)
        origins = stitch_origins((n + 2 * pad, n + 2 * pad, 1), (TWOD_N, TWOD_N, 1),
                                 (STRIDE, STRIDE, 1))
        n_batches = -(-len(set(origins)) // cfg.stitcher_batch)

        reset_counters(ops)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli.main(["predict", "--config", cfg_path, "--input", in_dir, "--output", out_dir,
                  "--weights", weights, "--stride", str(STRIDE), str(STRIDE), str(STRIDE),
                  "--device", DEVICE])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"conv3d_fwd": conv_ops.launches, "instnorm_fwd": in_ops.launches}
        out = read_tiff(os.path.join(out_dir, "VANGAN_img.tiff"))
        require(out.shape == (1, n, n, 1), f"twod predict: TIFF shape {out.shape}")
        out = out[0]
        require(bool(np.isfinite(out).all()) and out.min() >= 0.0 and out.max() <= 255.0,
                "twod predict: TIFF not finite or outside [0, 255]")
        require(launches == {"conv3d_fwd": CONV_PATH_CALLS * n_batches,
                             "instnorm_fwd": IN_PATH_CALLS * n_batches},
                f"twod predict launches {launches}, expected {n_batches} gen_IS batches")
        gan = VanGan(cfg, device=DEVICE)
        gan.load_weights(weights)
        gan.gen_IS.set_use_kernels(False)
        plain = {}
        for dtype in (torch.bfloat16, torch.float32):
            gan.gen_IS.dtype = dtype
            plain[dtype] = torch.from_numpy(stitch_subvolumes(
                gan.gen_IS_batched, img, cfg.subvol_size, stride=(STRIDE,) * 3, complete=True,
                padFactor=0.25, save=False, batch_size=cfg.stitcher_batch, device=DEVICE))
        close = bf16_vs_reference(torch.from_numpy(out), plain[torch.bfloat16],
                                  plain[torch.float32], "twod predict")
    predict = {"image": [n, n], "patches": len(origins), "batches": n_batches,
               "seconds": seconds, "mpix_per_s": n * n / seconds / 1e6, "launches": launches,
               "grey_levels": close}
    print("twod_predict", json.dumps(predict))

    truth = twod_tubes(np.random.default_rng(SEED + 15), n)
    pred = out[..., 0]
    skel0 = skel_ops.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = evaluate_segmentation(pred, truth, iters=SKEL_ITERS, device=DEVICE)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    require(skel_ops.launches == skel0, "twod metric: a 2-D skeleton launched K6")
    cpu = evaluate_segmentation(pred, truth, iters=SKEL_ITERS, device="cpu")
    require(scores == cpu, f"twod metric: card {scores} vs CPU {cpu}")
    metric = {"image": [n, n], "scores": scores, "seconds": seconds,
              "mpix_per_s": n * n / seconds / 1e6, "k6_launches": skel_ops.launches - skel0}
    print("twod_metric", json.dumps(metric))
    return predict, metric


def time_twod_skeleton():
    """The 2-D skeleton's torch ops (``morphology.soft_skel``, 15
    iterations) at the step's batch of 128 x 128 and 512 x 512 images:
    CUDA-event ms of the forward and of forward and backward, what a 2-D
    skeleton kernel could save of the step (two skeletons a step, one
    differentiated)."""
    from vangan_torch.ops import morphology

    g = torch.Generator(device=DEVICE).manual_seed(SEED + 16)
    res = {}
    for n in (TWOD_N, TWOD_BIG):
        x = torch.rand(STEP_BATCH, n, n, 1, device=DEVICE, generator=g)
        gy = torch.randn(x.shape, device=DEVICE, generator=g)
        xg = x.clone().requires_grad_()

        def fwd_bwd():
            torch.autograd.grad(morphology.soft_skel(xg, SKEL_ITERS), xg, gy)

        with torch.inference_mode():
            res[f"fwd_ms_{n}"] = cuda_ms(lambda: morphology.soft_skel(x, SKEL_ITERS))
        res[f"fwd_bwd_ms_{n}"] = cuda_ms(fwd_bwd)
    print("twod_skeleton", json.dumps(res))
    return res


def check_twod(ops, tol, card):
    """Phase 14: config 2 with DIMENSIONS: 2 at full width (ResU-Nets f=16
    with 4 levels, PatchGANs f=64) on 128 x 128 images."""
    from vangan_torch.config import VanGanConfig
    from vangan_torch.models.factory import build_discriminator, build_generator

    conv_ops, in_ops, skel_ops = ops
    sample = (TWOD_N, TWOD_N)
    cfg = VanGanConfig(SUBVOL_PATCH_SIZE=(TWOD_N,) * 3, **TWOD)
    g = torch.Generator().manual_seed(SEED)
    model = build_generator("resUnet", cfg, generator=g).to(DEVICE).eval()
    disc = build_discriminator(cfg, generator=g).to(DEVICE).eval()
    shapes, disc_shapes = path_shapes(model, sample), path_shapes(disc, sample)
    del model, disc
    out = {"conv_rows": check_convs("gen_IS_2d", shapes, CONV_PATH_CALLS, tol)
           + check_convs("disc_I_2d", disc_shapes, DISC_CONV_CALLS, tol),
           "in_rows": check_instnorms("gen_IS_2d", shapes, IN_PATH_CALLS, tol)
           + check_instnorms("disc_I_2d", disc_shapes, DISC_IN_CALLS, tol,
                             extra=TWOD_TINY_PLANES)}
    torch.cuda.empty_cache()
    out["test"] = check_test_step(conv_ops, in_ops, skel_ops, want=TWOD_TEST_LAUNCHES,
                                  tag="twod_test_step", sample=sample, **TWOD)
    torch.cuda.empty_cache()
    out["train"] = check_train_step(ops, TWOD_TRAIN_LAUNCHES, TWOD_TRAIN_KERNEL_LAUNCHES,
                                    tag="twod_train_step", sample=sample,
                                    spread_draws=TWOD_SPREAD_DRAWS, **TWOD)
    torch.cuda.empty_cache()
    out["big"] = time_twod_big_step(ops)
    torch.cuda.empty_cache()
    out["predict"], out["metric"] = check_twod_predict_and_metric(ops)
    out["skeleton"] = time_twod_skeleton()
    summary = {"card": card, "train_launches": out["train"]["launches"],
               "train_ms": out["train"]["kernel_ms_per_step"],
               "train_plain_ms": out["train"]["plain_ms_per_step"],
               "train_peak_gib": out["train"]["kernel_peak_gib"],
               "test_ms": out["test"]["kernel_ms_per_step"],
               "test_plain_ms": out["test"]["plain_ms_per_step"],
               "train_512_ms": out["big"]["kernel_ms_per_step"],
               "train_512_plain_ms": out["big"]["plain_ms_per_step"],
               "train_512_peak_gib": out["big"]["kernel_peak_gib"],
               "predict_mpix_per_s": out["predict"]["mpix_per_s"],
               "metric_s": out["metric"]["seconds"], "skeleton": out["skeleton"]}
    for op in ("fwd", "dgrad", "wgrad"):
        summary[f"conv_{op}_bf16_ms"] = sum(len(r["convs"]) * r[f"{op}_bf16_ms"]
                                            for r in out["conv_rows"])
        summary[f"conv_{op}_bf16_conv2d_ms"] = sum(len(r["convs"]) * r[f"{op}_bf16_library_ms"]
                                                   for r in out["conv_rows"])
    print("twod", json.dumps(summary))
    return out


def no_dropout(nets):
    """Dropout off in every network: a rank draws its own masks, so a
    comparison across processes runs without them (noise sigma 0 too)."""
    from vangan_torch.models.layers import DiscDownsample
    from vangan_torch.models.vnet import VNetConvBlock

    for net in nets.values():
        for m in net.modules():
            if isinstance(m, DiscDownsample):
                m.use_dropout = False
            elif isinstance(m, VNetConvBlock):
                m.dropout = None


def dp_batch(n, sample):
    """A seeded global batch of ``n`` samples on the host, as phase 6's:
    real_I uniform in [-1, 1], real_S binary in {-1, 1}."""
    rng = np.random.default_rng(SEED + 7)
    shape = (n, *sample, 1)
    real_I = rng.uniform(-1, 1, shape).astype(np.float32)
    real_S = np.where(rng.uniform(size=shape) > 0.7, 1.0, -1.0).astype(np.float32)
    return real_I, real_S


def dp_reset(gan, init, dtype, perturb=0.0, kernels=None, seed=None, dropout=False):
    """Seeded weights in ``dtype``, fresh optimizers, dropout off unless
    ``dropout``; with ``kernels``, that path; with ``seed``, the step's
    generator reseeded (the same draws); with ``perturb``, every weight
    scaled by (1 + perturb N(0, 1))."""
    from vangan_torch.training.state import make_train_state

    for name, net in gan.nets.items():
        net.load_state_dict(init[name])
        net.dtype = dtype
    if not dropout:
        no_dropout(gan.nets)
    if kernels is not None:
        gan.set_use_kernels(kernels)
    gan.state = make_train_state(gan.nets, gan.cfg, gan.steps_per_epoch)
    if seed is not None:
        gan.generator.manual_seed(seed)
    if perturb:
        with torch.no_grad():
            pg = torch.Generator(device=gan.device).manual_seed(SEED + 6)
            for net in gan.nets.values():
                for prm in net.parameters():
                    prm.mul_(1 + perturb * torch.randn(prm.shape, device=gan.device,
                                                       generator=pg))


def dp_grads(gan, real_I, real_S, crop, halves=False):
    """Each network's flat f32 gradient (on the host) and the losses of one
    training forward, noise sigma 0, on the rank's rows of the host global
    batch cropped to ``crop``^3, averaged over the ranks; and the running
    statistics after it. With ``halves`` (one process) the two ranks'
    arithmetic without them: each half of the batch at the rank's scales,
    the two averaged."""
    from vangan_torch.parallel import all_reduce_grads, all_reduce_mean, rows
    from vangan_torch.training import step
    from vangan_torch.training.state import NETWORKS

    n = len(real_I)
    parts = [rows(gan.group, n)]
    scales = gan.scales
    if halves:
        parts = [slice(0, n // 2), slice(n // 2, n)]
        scales = scales.for_rank(2)
    flat, losses = None, None
    for part in parts:
        box = (part,) + (slice(0, crop),) * 3
        x, y = (torch.from_numpy(np.ascontiguousarray(a[box])).to(gan.device)
                for a in (real_I, real_S))
        g, res = step.compute_grads(gan.nets, gan.cfg, scales, x, y, 0.0, gan.generator)
        f = {n: torch.cat([t.float().flatten() for t in all_reduce_grads(gan.group, g[n])])
             for n in NETWORKS}
        res = all_reduce_mean(gan.group, res)
        flat = f if flat is None else {k: flat[k] + f[k] for k in f}
        losses = res if losses is None else {k: losses[k] + res[k] for k in res}
        del g, x, y
    stats = {f"{n}.{b}": t.detach().float().cpu().clone() for n, net in gan.nets.items()
             for b, t in net.named_buffers()}
    return ({k: (v / len(parts)).cpu() for k, v in flat.items()},
            {k: float(v / len(parts)) for k, v in losses.items()}, stats)


def dp_bn_forward(gan, real_S, crop):
    """gen_SI (config 4's s2i V-Net) alone, in training, on the rank's rows
    of ``real_S`` cropped to ``crop``^3: its BatchNorm buffers after the
    call, on the host."""
    from vangan_torch.parallel import rows

    box = (rows(gan.group, len(real_S)),) + (slice(0, crop),) * 3
    x = torch.from_numpy(np.ascontiguousarray(real_S[box])).to(gan.device)
    with torch.no_grad():
        gan.gen_SI(x, True, gan.generator)
    return {b: t.float().cpu().clone() for b, t in gan.gen_SI.named_buffers()}


def predict_volume():
    """Phase 7's seeded 256^3 volume."""
    rng = np.random.default_rng(SEED + 2)
    return rng.normal(100.0, 40.0, (VOLUME,) * 3 + (1,)).astype(np.float32)


def dp_step_times(gan, real_I, real_S, steps=DP_TIMED_STEPS):
    """CUDA-event ms of ``steps`` train steps on the global batch."""
    times = []
    for _ in range(steps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        gan.distributed_train_step(real_I, real_S, NOISE, True)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def dp_rank(group, out_dir, parity=True):
    """Phase 15 on one rank of ``group`` (two sharing the card over gloo, or
    one a card over NCCL): the main path's step with its counters, the
    parameters after it (to ``out_dir``), timed steps, the all-reduce alone,
    and with ``parity`` the averaged gradients of configs 2 and 4 and the
    split stitch for the one-process comparisons."""
    import copy

    from vangan_torch.config import VanGanConfig
    from vangan_torch.inference.stitcher import stitch_subvolumes
    from vangan_torch.ops import conv3d as conv_ops
    from vangan_torch.ops import instnorm as in_ops
    from vangan_torch.ops import skeleton as skel_ops
    from vangan_torch.parallel import all_reduce_grads
    from vangan_torch.training import step
    from vangan_torch.training.state import NETWORKS
    from vangan_torch.vangan import VanGan

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ops, rank = (conv_ops, in_ops, skel_ops), group.rank
    cfg = VanGanConfig(SUBVOL_PATCH_SIZE=(N,) * 3, BATCH_SIZE=STEP_BATCH,
                       cldice_iters=SKEL_ITERS, stitcher_batch=BATCH, N_DEVICES=group.world)
    real_I, real_S = dp_batch(cfg.GLOBAL_BATCH_SIZE, (N,) * 3)
    gan = VanGan(cfg, group=group)
    init = {name: copy.deepcopy(net.state_dict()) for name, net in gan.nets.items()}

    # the main path: one bf16 step on the global batch, noise and dropout on
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters(ops)
    out = gan.distributed_train_step(real_I, real_S, NOISE, True)
    torch.cuda.synchronize()
    res = {"rank": rank, "device": str(gan.device), "launches": counters(ops),
           "kernel_launches": kernel_counters(ops),
           "losses": {k: float(v) for k, v in out.items()}}
    torch.save({n: torch.cat([p.detach().flatten() for p in gan.nets[n].parameters()]).cpu()
                for n in NETWORKS}, os.path.join(out_dir, f"params{rank}.pt"))
    res["ms_all"] = dp_step_times(gan, real_I, real_S)
    res["ms_per_step"] = float(np.median(res["ms_all"]))
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30

    # the all-reduce alone, on the gradients of one step
    x, y = (torch.from_numpy(a[rank * STEP_BATCH:(rank + 1) * STEP_BATCH]).to(gan.device)
            for a in (real_I, real_S))
    grads, _ = step.compute_grads(gan.nets, cfg, gan.scales, x, y, NOISE, gan.generator)
    del x, y
    res["grad_bytes"] = sum(t.numel() * t.element_size() for g in grads.values() for t in g)
    res["all_reduce_ms"] = cuda_ms(lambda: [all_reduce_grads(group, g) for g in grads.values()],
                                   reps=3)
    del grads
    if not parity:
        return res

    # parity with one process: seeded weights, noise 0, dropout off
    for tag, dtype, crop in (("bf16", torch.bfloat16, N), ("f32_crop", torch.float32, DP_CROP)):
        dp_reset(gan, init, dtype)
        flat, res[tag], _ = dp_grads(gan, real_I, real_S, crop)
        if group.main:
            torch.save(flat, os.path.join(out_dir, f"{tag}.pt"))
        del flat

    # the split stitch of phase 7's volume, from the seeded weights in bf16
    dp_reset(gan, init, torch.bfloat16)
    vol = predict_volume()
    conv_ops.launches = in_ops.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = stitch_subvolumes(gan.gen_IS_batched, vol, cfg.subvol_size, stride=(STRIDE,) * 3,
                            complete=True, padFactor=0.25, save=False, batch_size=BATCH,
                            device=gan.device, group=group)
    torch.cuda.synchronize()
    res["predict_s"] = time.perf_counter() - t0
    res["predict_launches"] = {"conv3d_fwd": conv_ops.launches, "instnorm_fwd": in_ops.launches}
    res["predict_is_none"] = out is None
    if group.main:
        np.save(os.path.join(out_dir, "predict.npy"), out)
    del gan, init, out
    torch.cuda.empty_cache()

    # config 4 (BatchNorm across the ranks) on the f32 crop
    gan = VanGan(VanGanConfig(SUBVOL_PATCH_SIZE=(N,) * 3, BATCH_SIZE=STEP_BATCH,
                              cldice_iters=SKEL_ITERS, **C4, **DP), group=group)
    init = {name: copy.deepcopy(net.state_dict()) for name, net in gan.nets.items()}
    dp_reset(gan, init, torch.float32)
    flat, res["config4_f32_crop"], res["config4_stats"] = dp_grads(gan, real_I, real_S, DP_CROP)
    if group.main:
        torch.save(flat, os.path.join(out_dir, "config4_f32_crop.pt"))
    dp_reset(gan, init, torch.float32)
    res["config4_bn_forward"] = dp_bn_forward(gan, real_S, DP_CROP)
    return res


def check_dp(card):
    """Phase 15: data parallelism (see the module note)."""
    import copy

    from vangan_torch import parallel
    from vangan_torch.config import VanGanConfig
    from vangan_torch.inference.stitcher import stitch_subvolumes
    from vangan_torch.training.state import NETWORKS
    from vangan_torch.vangan import VanGan

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    report = {"card": card}
    with tempfile.TemporaryDirectory(prefix="vangan_smoke_dp_") as tmp:
        # (b)-(d): two ranks sharing the card over gloo
        t0 = time.perf_counter()
        ranks = parallel.spawn(dp_rank, DP_WORLD, (tmp,), device=DEVICE, shared_card=True,
                               timeout=DP_TIMEOUT_S)
        report["gloo_ranks_s"] = time.perf_counter() - t0
        for r in ranks:
            require(r["launches"] == TRAIN_LAUNCHES, f"dp rank {r['rank']}: one step launched "
                    f"{r['launches']}, expected {TRAIN_LAUNCHES}")
            require(r["kernel_launches"] == TRAIN_KERNEL_LAUNCHES,
                    f"dp rank {r['rank']}: {r['kernel_launches']} kernels")
            require(len(r["losses"]) == 10 and all(map(math.isfinite, r["losses"].values())),
                    f"dp rank {r['rank']}: losses {r['losses']}")
            require(r["losses"] == ranks[0]["losses"], "dp: the ranks' averaged losses differ")
        p0, p1 = (torch.load(os.path.join(tmp, f"params{r}.pt")) for r in range(DP_WORLD))
        require(all(torch.equal(p0[n], p1[n]) for n in NETWORKS),
                "dp: the two ranks' parameters differ after the step")
        require(all(bool(torch.isfinite(p0[n]).all()) for n in NETWORKS),
                "dp: non-finite parameters after the step")
        del p0, p1
        require(ranks[1]["predict_is_none"] and not ranks[0]["predict_is_none"],
                "dp: the split stitch returned on the wrong rank")
        report["gloo"] = [{k: r[k] for k in ("rank", "device", "ms_per_step", "ms_all",
                                             "peak_gib", "all_reduce_ms", "grad_bytes",
                                             "predict_s", "predict_launches")}
                          for r in ranks]
        report["launches"] = ranks[0]["launches"]

        # the one-process references: the same global batch, the same contract
        cfg = VanGanConfig(SUBVOL_PATCH_SIZE=(N,) * 3, BATCH_SIZE=STEP_BATCH,
                           cldice_iters=SKEL_ITERS, stitcher_batch=BATCH, **DP)
        real_I, real_S = dp_batch(cfg.GLOBAL_BATCH_SIZE, (N,) * 3)
        gan = VanGan(cfg, device=DEVICE)
        init = {name: copy.deepcopy(net.state_dict()) for name, net in gan.nets.items()}
        agreement = {}

        def hold(tag, ref, spreads, got, got_losses, floor):
            """``got`` (the ranks' averaged gradients and losses) against
            ``ref`` (one process): each within max(SPREAD_FACTOR x the
            largest distance of a ``spreads`` run from ``ref``, ``floor``),
            each f32 loss within 1e-3."""
            rep = {"grads": {}, "losses": {}}
            for n in NETWORKS:
                d = rel_l2(got[n], ref[0][n])
                spread = max(rel_l2(o[0][n], ref[0][n]) for o in spreads.values())
                rep["grads"][n] = {"dp_vs_one": d, **{f"{k}_vs_one": rel_l2(o[0][n], ref[0][n])
                                                      for k, o in spreads.items()}}
                require(d <= max(SPREAD_FACTOR * spread, floor),
                        f"dp {tag} {n}: gradient {d:.3e} from one process, spread {spread:.3e}")
            for k, v in ref[1].items():
                d = rel_loss(got_losses[k], v)
                spread = max(rel_loss(o[1][k], v) for o in spreads.values())
                rep["losses"][k] = {"dp": got_losses[k], "one": v, "dp_vs_one": d,
                                    "spread": spread}
                lim = 1e-3 if "f32" in tag else max(SPREAD_FACTOR * spread, floor)
                require(d <= lim, f"dp {tag} {k}: loss {got_losses[k]} vs one process {v}")
            agreement[tag] = rep
            return rep

        # bf16: the one-process step's distance from its own arithmetic by
        # halves is the rounding that splitting the batch brings (a kernel's
        # or cuDNN's result may depend on the batch it runs in)
        dp_reset(gan, init, torch.bfloat16)
        one = dp_grads(gan, real_I, real_S, N)
        dp_reset(gan, init, torch.bfloat16)
        halves = dp_grads(gan, real_I, real_S, N, halves=True)
        got = torch.load(os.path.join(tmp, "bf16.pt"))
        hold("bf16", one, {"halves": halves}, got, ranks[0]["bf16"], 1e-3)
        agreement["bf16"]["dp_vs_halves"] = {n: rel_l2(got[n], halves[0][n]) for n in NETWORKS}
        del one, halves, got
        dp_reset(gan, init, torch.float32)
        one = dp_grads(gan, real_I, real_S, DP_CROP)
        dp_reset(gan, init, torch.float32)
        halves = dp_grads(gan, real_I, real_S, DP_CROP, halves=True)
        dp_reset(gan, init, torch.float32, perturb=1e-6)
        moved = dp_grads(gan, real_I, real_S, DP_CROP)
        hold("f32_crop", one, {"halves": halves, "perturbed": moved},
             torch.load(os.path.join(tmp, "f32_crop.pt")), ranks[0]["f32_crop"], 0.0)
        del one, halves, moved

        # (d) the stitch in one process
        dp_reset(gan, init, torch.bfloat16)
        want = stitch_subvolumes(gan.gen_IS_batched, predict_volume(), cfg.subvol_size,
                                 stride=(STRIDE,) * 3, complete=True, padFactor=0.25,
                                 save=False, batch_size=BATCH, device=DEVICE)
        got = np.load(os.path.join(tmp, "predict.npy"))
        diff = float(np.abs(got - want).max())
        report["predict"] = {"volume": [VOLUME] * 3, "max_abs_diff": diff,
                             "tolerance": 255 * 2.0 ** -16}
        require(got.shape == want.shape and diff <= 255 * 2.0 ** -16,
                f"dp predict: two ranks' stitch {diff} from one process's")
        del gan, init, want, got
        torch.cuda.empty_cache()

        # (c) config 4 on the f32 crop, its BatchNorm statistics too
        gan = VanGan(VanGanConfig(SUBVOL_PATCH_SIZE=(N,) * 3, BATCH_SIZE=STEP_BATCH,
                                  cldice_iters=SKEL_ITERS, **C4, **DP), device=DEVICE)
        init = {name: copy.deepcopy(net.state_dict()) for name, net in gan.nets.items()}
        dp_reset(gan, init, torch.float32)
        one = dp_grads(gan, real_I, real_S, DP_CROP)
        dp_reset(gan, init, torch.float32, perturb=1e-6)
        moved = dp_grads(gan, real_I, real_S, DP_CROP)
        hold("config4_f32_crop", one, {"perturbed": moved},
             torch.load(os.path.join(tmp, "config4_f32_crop.pt")), ranks[0]["config4_f32_crop"],
             0.0)
        stats = {}
        for name, ref in one[2].items():
            d = rel_l2(ranks[0]["config4_stats"][name], ref)
            spread = rel_l2(moved[2][name], ref)
            stats[name] = (d, spread)
            require(torch.equal(ranks[0]["config4_stats"][name], ranks[1]["config4_stats"][name]),
                    f"dp config 4 {name}: the ranks' running statistics differ")
            require(d <= max(SPREAD_FACTOR * spread, 1e-5),
                    f"dp config 4 {name}: statistic {d:.3e} from one process's, "
                    f"spread {spread:.3e}")
        require(len(stats) > 0, "dp config 4: no BatchNorm statistic")
        report["config4_stats"] = {"buffers": len(stats),
                                   "max_dp_vs_one": max(d for d, _ in stats.values()),
                                   "max_spread": max(s for _, s in stats.values())}
        # gen_SI's forward alone (its input is data, not a fake): each
        # BatchNorm's moved statistics within max(SPREAD_FACTOR x spread, 1e-5)
        dp_reset(gan, init, torch.float32)
        one = dp_bn_forward(gan, real_S, DP_CROP)
        dp_reset(gan, init, torch.float32, perturb=1e-6)
        moved = dp_bn_forward(gan, real_S, DP_CROP)
        stats = {}
        for name, ref in one.items():
            got = ranks[0]["config4_bn_forward"][name]
            require(torch.equal(got, ranks[1]["config4_bn_forward"][name]),
                    f"dp config 4 gen_SI.{name}: the ranks' statistics differ")
            stats[name] = (rel_l2(got, ref), rel_l2(moved[name], ref))
            require(stats[name][0] <= max(SPREAD_FACTOR * stats[name][1], 1e-5),
                    f"dp config 4 gen_SI.{name}: forward statistic {stats[name]}")
        report["config4_bn_forward"] = {"buffers": len(stats),
                                        "max_dp_vs_one": max(d for d, _ in stats.values()),
                                        "max_spread": max(s for _, s in stats.values())}
        del gan, init, one, moved
        torch.cuda.empty_cache()
    report["agreement"] = agreement

    # (a) world 1 over NCCL against no group, bit for bit; (f) times
    with tempfile.TemporaryDirectory(prefix="vangan_smoke_dp1_") as tmp:
        group = parallel.init_group(0, 1, "file://" + os.path.join(tmp, "store"), DEVICE)
        try:
            report["world1"] = check_world_one(group)
        finally:
            parallel.destroy(group)

    # (e) two cards over NCCL
    if torch.cuda.device_count() >= DP_WORLD:
        with tempfile.TemporaryDirectory(prefix="vangan_smoke_dpn_") as tmp:
            ranks = parallel.spawn(dp_rank, DP_WORLD, (tmp, False), device=DEVICE,
                                   timeout=DP_TIMEOUT_S)
            p0, p1 = (torch.load(os.path.join(tmp, f"params{r}.pt")) for r in range(DP_WORLD))
            require(all(torch.equal(p0[n], p1[n]) for n in NETWORKS),
                    "dp nccl: the two ranks' parameters differ after the step")
            for r in ranks:
                require(r["launches"] == TRAIN_LAUNCHES, f"dp nccl rank {r['rank']}: "
                        f"{r['launches']}")
            ms = max(r["ms_per_step"] for r in ranks)
            report["nccl"] = {"ranks": [{k: r[k] for k in ("rank", "device", "ms_per_step",
                                                          "ms_all", "peak_gib", "all_reduce_ms",
                                                          "grad_bytes")} for r in ranks],
                              "patches_per_s": DP_WORLD * STEP_BATCH / (ms / 1e3)}
    else:
        report["nccl"] = (f"not run: {torch.cuda.device_count()} card(s), "
                          f"two ranks over NCCL need {DP_WORLD}")
    report["phase_s"] = time.perf_counter() - t_phase
    print("dp", json.dumps(report))
    return report


def check_micro(ops, tol, train, card):
    """Phase 16: gradient accumulation (``micro_batches``). (a) Config 2 at
    BATCH_SIZE 3 in 3 slices: one bf16 step on the kernels must launch 3x
    phase 8's counts, move every parameter whose gradient is not exactly 0
    and give ten finite losses; the
    slices' summed gradients and losses, kernel path against plain path, by
    phase 8's f32 rules on the whole batch at 128^3 (each slice is one sample,
    so the f32 plain path fits) and its bf16 rule against f32; ms per step of
    both paths in turns and peak memory. (b) BASELINE config 5's global batch
    of 12 on this one card in 4 slices: 4x phase 8's launches, finite
    losses, ms per step, patches/s and peak memory; the step's rise above
    what it found allocated (weights, Adam's moments, the batch) must stay
    within a batch-3 step's rise, measured the same way, plus the gradient
    buffers, which live across the slices, and one incoming gradient.
    (c) Config 4 at BATCH_SIZE 3 in 3 slices on the batch cropped to 96^3
    in f32: 3x phase 10's launches; gradients and losses by
    phase 8's f32 rules, kernel against plain, and every BatchNorm
    statistic (the mean of the slices') within max(SPREAD_FACTOR x its
    spread, 1e-5) relative L2. (d) A ResU-Net and a V-Net with the options
    no factory role sets, each alone at full width, forward and backward,
    kernel against plain (``check_generator_family``)."""
    import copy

    from vangan_torch.config import VanGanConfig
    from vangan_torch.models.resunet import ResUNet3D
    from vangan_torch.models.vnet import VNet3D
    from vangan_torch.training import step
    from vangan_torch.training.state import NETWORKS
    from vangan_torch.vangan import VanGan

    f32, bf16 = torch.float32, torch.bfloat16
    report = {"card": card}

    def setup(batch, micro, sample=N, **kw):
        cfg = VanGanConfig(BATCH_SIZE=batch, micro_batches=micro, cldice_iters=SKEL_ITERS,
                           SUBVOL_PATCH_SIZE=(sample,) * 3, **kw)
        gan = VanGan(cfg, device=DEVICE)
        return gan, {name: copy.deepcopy(net.state_dict()) for name, net in gan.nets.items()}

    def reset(gan, init, kernels, dtype, perturb=0.0):
        dp_reset(gan, init, dtype, perturb, kernels=kernels, seed=SEED + 5, dropout=True)

    def main_step(gan, init, real_I, real_S, times, tag):
        """One bf16 step on the kernels, its counters read just after it."""
        reset(gan, init, True, bf16)
        torch.cuda.synchronize()
        reset_counters(ops)
        out = gan.distributed_train_step(real_I, real_S, NOISE, True)
        torch.cuda.synchronize()
        launches, kernel_launches = counters(ops), kernel_counters(ops)
        want = {k: times * v for k, v in TRAIN_LAUNCHES.items()}
        want_k = {k: times * v for k, v in TRAIN_KERNEL_LAUNCHES.items()}
        require(launches == want and kernel_launches == want_k,
                f"{tag}: one step launched {launches} ({kernel_launches} kernels), expected "
                f"{want} ({want_k})")
        losses = {k: float(v) for k, v in out.items()}
        require(len(losses) == 10 and all(math.isfinite(v) for v in losses.values()),
                f"{tag}: losses not all finite: {losses}")
        unmoved = []
        for name, net in gan.nets.items():
            for k, prm in net.named_parameters():
                require(bool(torch.isfinite(prm).all()), f"{tag} {name}.{k}: not finite")
                if torch.equal(prm.detach(), init[name][k].to(prm.device)):
                    unmoved.append((name, k))
        # a parameter stays only where its summed bf16 gradient is exactly 0:
        # a PatchGAN head's bias sums dL/dD over real and fake scores that
        # nearly cancel on one-sample slices (8e-4 in f32, 0 in bf16 on both
        # paths), so the same draws are run again for the gradients
        if unmoved:
            reset(gan, init, True, bf16)
            g, _ = step.compute_grads(gan.nets, gan.cfg, gan.scales, real_I, real_S, NOISE,
                                      gan.generator, micro=gan.cfg.micro_batches)
            for name, k in unmoved:
                i = [n for n, _ in gan.nets[name].named_parameters()].index(k)
                require(not bool(g[name][i].any()),
                        f"{tag} {name}.{k}: not moved by the step, gradient not 0")
            del g
        return {"launches": launches, "kernel_launches": kernel_launches, "losses": losses,
                "unmoved_zero_gradient": [f"{n}.{k}" for n, k in unmoved]}

    def grads_of(gan, init, real_I, real_S, kernels, dtype, perturb=0.0, crop=N):
        reset(gan, init, kernels, dtype, perturb)
        box = (slice(None),) + (slice(0, crop),) * 3
        g, res = step.compute_grads(gan.nets, gan.cfg, gan.scales,
                                    real_I[box].contiguous(), real_S[box].contiguous(), NOISE,
                                    gan.generator, micro=gan.cfg.micro_batches)
        stats = {f"{n}.{b}": t.detach().float().clone() for n, net in gan.nets.items()
                 for b, t in net.named_buffers()}
        return ({n: torch.cat([t.float().flatten() for t in g[n]]) for n in NETWORKS},
                {k: float(v) for k, v in res.items()}, stats)

    # (a) config 2, batch 3 in 3 slices: the main path first
    t0 = time.perf_counter()
    gan, init = setup(STEP_BATCH, MICRO)
    _, real_I, real_S = step_batch()
    a = main_step(gan, init, real_I, real_S, MICRO, "micro3")
    runs = {(k, d): grads_of(gan, init, real_I, real_S, k, d)
            for k, d in ((True, f32), (False, f32), (True, bf16), (False, bf16))}
    perturbed = grads_of(gan, init, real_I, real_S, False, f32, perturb=1e-6)
    a["f32"] = f32_agreement(runs[True, f32][:2], runs[False, f32][:2], [perturbed[0]])
    a["bf16"] = bf16_agreement(runs[True, bf16][0], runs[False, bf16][0], runs[False, f32][0])
    require_f32("micro3", a["f32"])
    require_bf16("micro3", a["bf16"])
    del runs, perturbed
    for path in ("kernel", "plain"):  # warm-up of each path
        reset(gan, init, path == "kernel", bf16)
        gan.distributed_train_step(real_I, real_S, NOISE, True)
    reset(gan, init, True, bf16)
    a.update(train_steps_in_turns(gan, real_I, real_S))
    a["phase8_kernel_ms_per_step"] = train["kernel_ms_per_step"]
    a["phase8_kernel_peak_gib"] = train["kernel_peak_gib"]
    a["s"] = time.perf_counter() - t0
    report["micro3_of_3"] = a
    print("micro3", json.dumps(a))
    grad_bytes = sum(p.numel() * p.element_size() for net in gan.nets.values()
                     for p in net.parameters())
    largest_grad = max(p.numel() * p.element_size() for net in gan.nets.values()
                       for p in net.parameters())
    del gan, init
    torch.cuda.empty_cache()

    # (b) the global batch of 12 on one card, in 4 slices
    def timed(gan, real_I, real_S, steps):
        """ms of warmed-up kernel-path steps, the peak, and the peak above
        what the step found allocated (weights, Adam's moments, the batch)."""
        gan.distributed_train_step(real_I, real_S, NOISE, True)  # warm-up
        times, peak, rise = [], 0.0, 0.0
        for _ in range(steps):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            times.append(cuda_ms(lambda: gan.distributed_train_step(real_I, real_S, NOISE, True),
                                 reps=1))
            peak = max(peak, torch.cuda.max_memory_allocated() / 2**30)
            rise = max(rise, (torch.cuda.max_memory_allocated() - before) / 2**30)
        return times, peak, rise

    t0 = time.perf_counter()
    gan, init = setup(MICRO_BIG_BATCH, MICRO_BIG)
    big_I, big_S = (torch.from_numpy(t).to(DEVICE) for t in dp_batch(MICRO_BIG_BATCH, (N,) * 3))
    b = main_step(gan, init, big_I, big_S, MICRO_BIG, "micro4_of_12")
    reset(gan, init, True, bf16)
    times, peak, rise = timed(gan, big_I, big_S, MICRO_TIMED_STEPS)
    del gan, init
    torch.cuda.empty_cache()
    # the step of phase 8 (3 samples, one backward), measured the same way
    gan, init = setup(STEP_BATCH, 1)
    reset(gan, init, True, bf16)
    times3, peak3, rise3 = timed(gan, big_I[:STEP_BATCH], big_S[:STEP_BATCH], 1)
    b.update({"ms_per_step": float(np.median(times)), "ms_all": times,
              "patches_per_s": MICRO_BIG_BATCH * 1e3 / float(np.median(times)),
              "peak_gib": peak, "step_rise_gib": rise, "grad_gib": grad_bytes / 2**30,
              "batch3_ms": times3[0], "batch3_peak_gib": peak3, "batch3_step_rise_gib": rise3,
              "phase8_kernel_peak_gib": train["kernel_peak_gib"],
              "phase8_patches_per_s": STEP_BATCH * 1e3 / train["kernel_ms_per_step"]})
    # above what it found allocated, the step of 4 slices of 3 may take what
    # the step of 3 takes, plus the gradient buffers, which live across the
    # slices, plus one incoming gradient: from the second slice on, autograd
    # adds each parameter's new gradient into its buffer, where the first
    # backward takes the new tensor itself (measured 4 MB above the first
    # two, NVIDIA H100 80GB HBM3, 700.00 W)
    b["largest_grad_gib"] = largest_grad / 2**30
    require(rise <= rise3 + (grad_bytes + largest_grad) / 2**30,
            f"micro4_of_12: the step rose {rise:.3f} GiB, the batch-3 step {rise3:.3f} GiB "
            f"plus {grad_bytes / 2**30:.3f} GiB of gradients and one of "
            f"{largest_grad / 2**30:.3f} GiB")
    b["s"] = time.perf_counter() - t0
    report["micro4_of_12"] = b
    print("micro4_of_12", json.dumps(b))
    del gan, init, big_I, big_S
    torch.cuda.empty_cache()

    # (c) config 4 in 3 slices, f32 on the 96^3 crop; launches as phase 10's
    t0 = time.perf_counter()
    gan, init = setup(STEP_BATCH, MICRO, **C4)
    reset_counters(ops)
    kern = grads_of(gan, init, real_I, real_S, True, f32, crop=C4_F32_CROP)
    torch.cuda.synchronize()
    c = {"launches": counters(ops)}
    want = {k: MICRO * v for k, v in C4_TRAIN_LAUNCHES.items()}
    require(c["launches"] == want, f"config4 micro3: launched {c['launches']}, expected {want}")
    plain = grads_of(gan, init, real_I, real_S, False, f32, crop=C4_F32_CROP)
    pert = grads_of(gan, init, real_I, real_S, False, f32, 1e-6, crop=C4_F32_CROP)
    c.update(f32_agreement(kern[:2], plain[:2], [pert[0]]))
    require_f32("config4_micro3", c)
    c["batch_norm"] = {}
    for key, want_t in plain[2].items():
        if "gen_SI" not in key:
            continue
        v = {"kernel_vs_plain": rel_l2(kern[2][key], want_t),
             "plain_perturbed_vs_plain": rel_l2(pert[2][key], want_t),
             "moved_abs": float((want_t - init["gen_SI"][key.split(".", 1)[1]].float().to(DEVICE))
                                .norm())}
        c["batch_norm"][key] = v
        require(v["kernel_vs_plain"] <= max(SPREAD_FACTOR * v["plain_perturbed_vs_plain"], 1e-5)
                and v["moved_abs"] > 0, f"config4 micro3 {key}: {v}")
    require(c["batch_norm"], "config4 micro3: no BatchNorm statistic")
    c["s"] = time.perf_counter() - t0
    report["config4_micro3"] = c
    print("config4_micro3", json.dumps(c))
    del gan, init, kern, plain, pert
    torch.cuda.empty_cache()

    # (d) the generators' other options, each alone at full width
    g = torch.Generator().manual_seed(SEED)
    report["resunet_options"] = check_generator_family("resunet_options", ResUNet3D(
        16, 4, upsample_mode="deconv", dropout_type="spatial", dropout=0.1,
        dropout_change_per_layer=0.1, output_activation="sigmoid", use_input_noise=True,
        generator=g), ops)
    torch.cuda.empty_cache()
    report["vnet_options"] = check_generator_family("vnet_options", VNet3D(
        use_batch_norm=False, upsample_mode="simple", dropout=0.3, dropout_type="spatial",
        filters=32, num_layers=4, addnoise=True, num_classes=2, output_activation="sigmoid",
        dropout_change_per_layer=0.05, use_dropout_on_upsampling=True, generator=g), ops,
        out_channels=2)
    torch.cuda.empty_cache()
    return report


def check_world_one(group):
    """(a): two steps of a world of 1 (no collective call) and of no group,
    from the seeded weights and noise draws: parameters and losses equal bit
    for bit; the two timed in turns; the NCCL all-reduce of a buffer of the
    gradients' bytes."""
    from vangan_torch.config import VanGanConfig
    from vangan_torch.training.state import NETWORKS
    from vangan_torch.vangan import VanGan

    cfg = VanGanConfig(SUBVOL_PATCH_SIZE=(N,) * 3, BATCH_SIZE=STEP_BATCH, cldice_iters=SKEL_ITERS)
    _, real_I, real_S = step_batch((N,) * 3)
    gans = {"bare": VanGan(cfg, device=DEVICE), "world1": VanGan(cfg, group=group)}
    losses = {k: [gan.distributed_train_step(real_I, real_S, NOISE, True) for _ in range(2)]
              for k, gan in gans.items()}
    for a, b in zip(losses["bare"], losses["world1"]):
        require(all(torch.equal(a[k], b[k]) for k in a), "dp world 1: losses differ")
    for n in NETWORKS:
        require(all(torch.equal(p, q) for p, q in zip(gans["bare"].nets[n].parameters(),
                                                      gans["world1"].nets[n].parameters())),
                f"dp world 1: {n}'s parameters differ from the step without a group")
    times = {"bare": [], "world1": []}
    for k in ("bare", "world1", "world1", "bare", "bare", "world1"):
        times[k] += dp_step_times(gans[k], real_I, real_S, 1)
    numel = sum(p.numel() for net in gans["bare"].nets.values() for p in net.parameters())
    del gans, losses
    torch.cuda.empty_cache()
    flat = torch.ones(numel, device=DEVICE)
    ms = cuda_ms(lambda: torch.distributed.all_reduce(flat, group=group.pg))
    return {"ms_per_step": {k: float(np.median(v)) for k, v in times.items()},
            "ms_all": times, "grad_bytes": 4 * numel, "nccl_all_reduce_ms": ms,
            "nccl_all_reduce_gb_per_s": 4 * numel / (ms / 1e3) / 1e9}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)

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
    other_gens = check_other_generators((conv_ops, in_ops, skel_ops), tol)
    torch.cuda.empty_cache()
    data_eval = check_data_eval((conv_ops, in_ops, skel_ops), card)
    torch.cuda.empty_cache()
    wgan = check_wgan((conv_ops, in_ops, skel_ops), tol, disc_shapes)
    torch.cuda.empty_cache()
    twod = check_twod((conv_ops, in_ops, skel_ops), tol, card)
    torch.cuda.empty_cache()
    dp = check_dp(card)
    torch.cuda.empty_cache()
    micro = check_micro((conv_ops, in_ops, skel_ops), tol, train, card)
    torch.cuda.empty_cache()
    resnet = check_resnet_step((conv_ops, in_ops, skel_ops), other_gens["resnet_convs"])

    require("jax" not in sys.modules and "vangan_tpu" not in sys.modules,
            "the port imported JAX or the JAX package")

    def summed_bound(parts):
        """The bounds of a sequence of calls, (count, (ms, kind)), added up
        and named by the kind that bounds most of the sum."""
        by = {"operations": 0.0, "bytes": 0.0}
        for count, (ms, kind) in parts:
            by[kind] += count * ms
        return {"bound_ms": sum(by.values()), "bound_by": max(by, key=by.get)}

    resnet_rows = {r["convs"][0]: r for r in other_gens["resnet_convs"]}

    def conv_entry(name, op, source, replaces):
        """Sums over one gen_IS and one disc_I call at batch 3, bf16; and the
        ResNet's 343-tap convs at batch 3 (phase 11), with their launches in
        phase 17's step."""
        total = lambda key: sum(len(r["convs"]) * r[key] for r in conv_rows)  # noqa: E731
        k = ("fwd", "dgrad", "wgrad").index(op)
        taps_343 = {conv: {"launches": counts[k], "route": resnet_rows[conv]["plan"][op]["route"],
                           "body": resnet_rows[conv]["plan"][op]["body"],
                           "tap_chunks": resnet_rows[conv]["plan"][op]["tap_chunks"],
                           "k_pairs": resnet_rows[conv]["plan"][op]["k_pairs"],
                           "max_abs_err": resnet_rows[conv][f"{op}_bf16_abs_err"],
                           "ms": resnet_rows[conv][f"{op}_bf16_ms"],
                           "plain_ms": resnet_rows[conv][f"{op}_bf16_plain_ms"],
                           "bound_ms": resnet_rows[conv]["bound"][op][0],
                           "bound_by": resnet_rows[conv]["bound"][op][1],
                           "library_ms": resnet_rows[conv][f"{op}_bf16_library_ms"]}
                    for conv, counts in RESNET_343_LAUNCHES.items()}
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": train["launches"][name],
                "config4_launches": c4["train"]["launches"][name],
                "wgan_launches": wgan["launches"][1][name],
                "twod_launches": twod["train"]["launches"][name],
                "dp_launches": dp["launches"][name],
                "micro_launches": micro["micro3_of_3"]["launches"][name],
                "resnet_launches": resnet["launches"][name],
                "max_abs_err": max(r[f"{op}_bf16_abs_err"] for r in conv_rows),
                "ms": total(f"{op}_bf16_ms"), "plain_ms": total(f"{op}_bf16_plain_ms"),
                **summed_bound([(len(r["convs"]), r["bound"][op]) for r in conv_rows]),
                "library_ms": total(f"{op}_bf16_library_ms"), "taps_343": taps_343}

    def in_entry(name, op, replaces):
        total = lambda key: sum(len(r["uses"]) * r[key] for r in in_rows)  # noqa: E731
        errs_ = [r[f"{op}_bf16_abs_err"] for r in in_rows] if op == "fwd" else [
            r[f"bwd_{part}_bf16_abs_err"] for r in in_rows for part in ("dx", "dgamma", "dbeta")]
        entry = {"name": name, "route": "cuda",
                 "source": f"vangan_torch/ops/csrc/instnorm_{op}.cu", "replaces": replaces,
                 "launches": train["launches"][name],
                 "config4_launches": c4["train"]["launches"][name],
                 "wgan_launches": wgan["launches"][1][name],
                 "twod_launches": twod["train"]["launches"][name],
                 "dp_launches": dp["launches"][name],
                 "micro_launches": micro["micro3_of_3"]["launches"][name],
                 "resnet_launches": resnet["launches"][name],
                 "max_abs_err": max(errs_),
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

    raw_predict = data_eval["predict_launches"]
    kernels = [
        dict(conv_entry("conv3d_fwd", "fwd", "vangan_torch/ops/csrc/conv3d_fwd.cu",
                        "vangan_tpu/ops/pallas/conv3d.py:577"),
             raw_predict_launches=raw_predict["conv3d_fwd"],
             resnet_tap_chunk_launches=resnet["tap_chunk_launches"]["conv3d_fwd"],
             resnet_pair_launches=resnet["tap_chunk_launches"]["conv3d_fwd_pairs"]),
        dict(conv_entry("conv3d_dgrad", "dgrad", "vangan_torch/ops/csrc/conv3d_dgrad.cu",
                        "vangan_tpu/ops/pallas/conv3d.py:904"),
             fold_launches=train["launches"]["conv3d_dgrad_fold"],
             config4_fold_launches=c4["train"]["launches"]["conv3d_dgrad_fold"],
             wgan_fold_launches=wgan["launches"][1]["conv3d_dgrad_fold"],
             twod_fold_launches=twod["train"]["launches"]["conv3d_dgrad_fold"],
             resnet_tap_launches=resnet["tap_chunk_launches"]["conv3d_dgrad_taps"]),
        dict(conv_entry("conv3d_wgrad", "wgrad", "vangan_torch/ops/csrc/conv3d_wgrad.cu",
                        "vangan_tpu/ops/pallas/conv3d.py:817"),
             resnet_tap_chunk_launches=resnet["tap_chunk_launches"]["conv3d_wgrad"],
             resnet_pair_launches=resnet["tap_chunk_launches"]["conv3d_wgrad_pairs"]),
        dict(in_entry("instnorm_fwd", "fwd", "vangan_tpu/ops/pallas/instnorm.py:309"),
             raw_predict_launches=raw_predict["instnorm_fwd"],
             kernel_launches=train["kernel_launches"]["instnorm_fwd"],
             config4_kernel_launches=c4["train"]["kernel_launches"]["instnorm_fwd"]),
        in_entry("instnorm_bwd", "bwd", "vangan_tpu/ops/pallas/instnorm.py:379"),
        {"name": "soft_skel_fwd", "route": "cuda",
         "source": "vangan_torch/ops/csrc/skeleton_fwd.cu",
         "replaces": "vangan_tpu/ops/pallas/skeleton.py:185",
         "launches": train["launches"]["soft_skel_fwd"],
         "config4_launches": c4["train"]["launches"]["soft_skel_fwd"],
         "wgan_launches": wgan["launches"][1]["soft_skel_fwd"],
         "twod_launches": twod["train"]["launches"]["soft_skel_fwd"],
         "dp_launches": dp["launches"]["soft_skel_fwd"],
         "micro_launches": micro["micro3_of_3"]["launches"]["soft_skel_fwd"],
         "resnet_launches": resnet["launches"]["soft_skel_fwd"],
         "metric_launches": data_eval["metric_launches"],
         "max_abs_err": max(skel["tanh_noise_max_abs_err"], skel["binary_faces_max_abs_err"],
                            *data_eval["skel_max_abs_err"].values()),
         "ms": skel["tanh_noise_ms"], "plain_ms": skel["tanh_noise_plain_ms"],
         "bound_ms": skel["fwd_bound"][0], "bound_by": skel["fwd_bound"][1],
         "library_ms": None},
        {"name": "soft_skel_bwd", "route": "cuda",
         "source": "vangan_torch/ops/csrc/skeleton_bwd.cu",
         "replaces": "vangan_tpu/ops/pallas/skeleton.py:274",
         "launches": train["launches"]["soft_skel_bwd"],
         "kernel_launches": train["kernel_launches"]["soft_skel_bwd"],
         "wgan_launches": wgan["launches"][1]["soft_skel_bwd"],
         "twod_launches": twod["train"]["launches"]["soft_skel_bwd"],
         "dp_launches": dp["launches"]["soft_skel_bwd"],
         "micro_launches": micro["micro3_of_3"]["launches"]["soft_skel_bwd"],
         "resnet_launches": resnet["launches"]["soft_skel_bwd"],
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
