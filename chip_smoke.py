#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vangan_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

0. the card (nvidia-smi name and power limit); CUDA must be available;
1. build the CUDA kernels from vangan_torch/ops/csrc with nvcc (sm_90a);
2. the conv3d kernel against its plain version (F.conv3d) at every conv shape
   the full-width gen_IS (17 kernel convs) and disc_I (1: conv0) give it at
   128^3, batch 1, in float32 (TF32 off, max |err| <= 1e-4 * max |y|) and
   bfloat16 (<= 2e-2 * max |y|), with CUDA event times (median of 5) of both;
3. the InstanceNorm kernel against its plain version at every (C, size) of
   the two networks (28 and 4 norms), for each activation, with the same
   tolerances and timing;
4. the soft-skeleton kernel against its plain version (morphology.soft_skel)
   at the test step's shape, 3 x 128^3, 15 iterations, on the min-max
   normalised tanh of seeded noise and on a binary volume touching every
   face: bit-exact (max |diff| == 0); CUDA event times (median of 5);
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
   plain-path stitches of the same input.

Then one JSON line of the kernels (launches counted in one test step of
phase 6, the path that runs all three; ms summed over one gen_IS forward at
batch 1 for the conv and IN kernels, one skeleton for soft_skel_fwd) and,
last, the ok line. Without CUDA, or outside the repository, it exits non-zero
before printing either.
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

N = 128          # patch edge (SUBVOL_PATCH_SIZE)
BATCH = 8        # stitcher_batch
VOLUME = 256     # predict phase volume edge
STRIDE = 64
STEP_BATCH = 3   # test step batch (BATCH_SIZE x N_DEVICES of the default config)
SKEL_ITERS = 15  # cldice_iters
SEED = 0
DEVICE = "cuda"
CONV_PATH_CALLS = 17  # kernel convs per gen_IS call (max(Ci, Co) < 128)
IN_PATH_CALLS = 28    # InstanceNorms per gen_IS call
DISC_CONV_CALLS = 1   # kernel convs per disc call (conv0; the wider ones take cuDNN)
DISC_IN_CALLS = 4     # InstanceNorms per disc call


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


def check_convs(net, shapes, expected, tol):
    from vangan_torch.models.layers import KERNEL_MAX_CHANNELS, ConvND
    from vangan_torch.ops.conv3d import conv3d, conv3d_plain, norm_padding

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
    rows = []
    for (wshape, stride, padding, pad_mode, has_bias, dims), names in groups.items():
        m = next(mm for nn_, mm, _ in shapes if nn_ == names[0])
        co, ci = wshape[:2]
        x32 = torch.randn(1, ci, *dims, device=DEVICE, generator=g)
        w = torch.randn(wshape, device=DEVICE, generator=g) * math.sqrt(2.0 / (ci * 27))
        b = torch.randn(co, device=DEVICE, generator=g) * 0.1 if has_bias else None
        pads = norm_padding(m.padding, m.kernel_size, stride, dims)
        row = {"net": net, "convs": names, "w": list(wshape), "stride": list(stride),
               "in": list(dims)}
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            with torch.inference_mode():
                kern = lambda: conv3d(x, w, b, stride, m.padding, pad_mode)  # noqa: E731
                plain = lambda: conv3d_plain(x, w, b, stride, pads, pad_mode)  # noqa: E731
                got, want = kern(), plain()
                torch.cuda.synchronize()
                abs_err, rel = errs(got, want)
                require(got.shape == want.shape, f"conv {names}: shape {got.shape} "
                        f"vs {want.shape}")
                require(rel <= tol[dtype], f"conv {names} {dtype}: rel err {rel:.3e}")
                tag = "f32" if dtype == torch.float32 else "bf16"
                row[f"{tag}_abs_err"], row[f"{tag}_rel_err"] = abs_err, rel
                row[f"{tag}_ms"], row[f"{tag}_plain_ms"] = cuda_ms(kern), cuda_ms(plain)
        rows.append(row)
        print("conv", json.dumps(row))
    return rows


def check_instnorms(net, shapes, expected, tol):
    from vangan_torch.models.layers import InstanceNorm
    from vangan_torch.ops.instnorm import instance_norm_act, instance_norm_act_plain

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
        x32 = torch.randn(1, c, *dims, device=DEVICE, generator=g) * 2 + 0.5
        gamma = torch.randn(c, device=DEVICE, generator=g) * 0.5 + 1
        beta = torch.randn(c, device=DEVICE, generator=g) * 0.2
        for act in ("none", "relu", "leaky_relu"):
            row = {"net": net, "c": c, "in": list(dims), "act": act,
                   "uses": [n for n, a in uses if a == act]}
            for dtype in (torch.float32, torch.bfloat16):
                x = x32.to(dtype)
                with torch.inference_mode():
                    kern = lambda: instance_norm_act(x, gamma, beta, 1e-3, act)  # noqa: E731
                    plain = lambda: instance_norm_act_plain(x, gamma, beta, 1e-3, act)  # noqa: E731
                    got, want = kern(), plain()
                    torch.cuda.synchronize()
                    abs_err, rel = errs(got, want)
                    require(rel <= tol[dtype], f"IN C={c} {dims} {act} {dtype}: "
                            f"rel err {rel:.3e}")
                    tag = "f32" if dtype == torch.float32 else "bf16"
                    row[f"{tag}_abs_err"], row[f"{tag}_rel_err"] = abs_err, rel
                    row[f"{tag}_ms"], row[f"{tag}_plain_ms"] = cuda_ms(kern), cuda_ms(plain)
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
    res = {"shape": list(shape), "iters": SKEL_ITERS}
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


def check_test_step(conv_ops, in_ops, skel_ops):
    from vangan_torch.config import VanGanConfig
    from vangan_torch.vangan import VanGan

    cfg = VanGanConfig(SUBVOL_PATCH_SIZE=(N, N, N), BATCH_SIZE=STEP_BATCH,
                       cldice_iters=SKEL_ITERS)
    gan = VanGan(cfg, device=DEVICE)
    rng = np.random.default_rng(SEED + 4)
    shape = (STEP_BATCH, N, N, N, 1)
    real_I = torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)).to(DEVICE)
    seg = rng.uniform(size=shape) > 0.7
    real_S = torch.from_numpy(np.where(seg, 1.0, -1.0).astype(np.float32)).to(DEVICE)

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
    disc_conv_rows = check_convs("disc_I", disc_shapes, DISC_CONV_CALLS, tol)
    in_rows = check_instnorms("gen_IS", shapes, IN_PATH_CALLS, tol)
    disc_in_rows = check_instnorms("disc_I", disc_shapes, DISC_IN_CALLS, tol)
    del disc
    skel = check_skeleton(skel_ops)
    check_generator(model, conv_ops, in_ops)
    del model
    torch.cuda.empty_cache()
    step = check_test_step(conv_ops, in_ops, skel_ops)
    torch.cuda.empty_cache()
    check_predict(conv_ops, in_ops)

    require("jax" not in sys.modules and "vangan_tpu" not in sys.modules,
            "the port imported JAX or the JAX package")
    # per gen_IS call at batch 1: each path conv / IN times its number of uses
    conv_ms = sum(len(r["convs"]) * r["bf16_ms"] for r in conv_rows)
    conv_plain_ms = sum(len(r["convs"]) * r["bf16_plain_ms"] for r in conv_rows)
    in_ms = sum(len(r["uses"]) * r["bf16_ms"] for r in in_rows)
    in_plain_ms = sum(len(r["uses"]) * r["bf16_plain_ms"] for r in in_rows)
    kernels = [
        {"name": "conv3d_fwd", "route": "cuda", "source": "vangan_torch/ops/csrc/conv3d_fwd.cu",
         "replaces": "vangan_tpu/ops/pallas/conv3d.py:577",
         "launches": step["launches"]["conv3d_fwd"],
         "max_abs_err": max(r["bf16_abs_err"] for r in conv_rows + disc_conv_rows),
         "ms": conv_ms, "plain_ms": conv_plain_ms},
        {"name": "instnorm_fwd", "route": "cuda",
         "source": "vangan_torch/ops/csrc/instnorm_fwd.cu",
         "replaces": "vangan_tpu/ops/pallas/instnorm.py:309",
         "launches": step["launches"]["instnorm_fwd"],
         "max_abs_err": max(r["bf16_abs_err"] for r in in_rows + disc_in_rows),
         "ms": in_ms, "plain_ms": in_plain_ms},
        {"name": "soft_skel_fwd", "route": "cuda",
         "source": "vangan_torch/ops/csrc/skeleton_fwd.cu",
         "replaces": "vangan_tpu/ops/pallas/skeleton.py:185",
         "launches": step["launches"]["soft_skel_fwd"],
         "max_abs_err": max(skel["tanh_noise_max_abs_err"], skel["binary_faces_max_abs_err"]),
         "ms": skel["tanh_noise_ms"], "plain_ms": skel["tanh_noise_plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
