#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vangan_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

0. the card (nvidia-smi name and power limit); CUDA must be available;
1. build the CUDA kernels from vangan_torch/ops/csrc with nvcc (sm_90a);
2. the conv3d kernel against its plain version (F.conv3d) at every conv shape
   the full-width gen_IS gives it at 128^3, batch 1, in float32 (TF32 off,
   max |err| <= 1e-4 * max |y|) and bfloat16 (<= 2e-2 * max |y|), with CUDA
   event times (median of 5) of both;
3. the InstanceNorm kernel against its plain version at every (C, size) of
   the path, for each activation, with the same tolerances and timing;
4. gen_IS (f=16, 4 levels) on a batch of 8 x 128^3 from seeded weights: one
   bf16 call must launch the conv kernel 17 times and the IN kernel 28 times;
   in f32 the kernel path must match the plain path (max |diff| <= 1e-3 on
   the tanh outputs); in bf16 the kernel path must be no further from the f32
   plain result than the bf16 plain path is (2x on the mean, 3x on the max,
   see ``bf16_vs_reference``); ms per bf16 batch of both paths;
5. the main path: ``python -m vangan_torch predict`` (through cli.main) on a
   seeded 256^3 volume with weights saved from seeded init, stride 64, uniform
   blend, padFactor 0.25; the TIFF must be (256, 256, 256, 1) z-x-y-c, finite,
   in [0, 255], every kernel must have launched once per gen_IS batch, and
   the volume must pass the bf16 check of phase 4 against plain-path stitches
   of the same input.

Then one JSON line of the kernels and, last, the ok line. Without CUDA, or
outside the repository, it exits non-zero before printing either.
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
SEED = 0
DEVICE = "cuda"
CONV_PATH_CALLS = 17  # kernel convs per gen_IS call (max(Ci, Co) < 128)
IN_PATH_CALLS = 28    # InstanceNorms per gen_IS call


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
    gen_IS call at N^3, batch 1, recorded on the plain path."""
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


def check_convs(shapes, tol):
    from vangan_torch.models.layers import KERNEL_MAX_CHANNELS, ConvND
    from vangan_torch.ops.conv3d import conv3d, conv3d_plain, norm_padding

    groups = {}
    for name, m, shape in shapes:
        if isinstance(m, ConvND) and max(m.weight.shape[:2]) < KERNEL_MAX_CHANNELS:
            key = (tuple(m.weight.shape), m.strides, str(m.padding), m.pad_mode,
                   m.bias is not None, shape[2:])
            groups.setdefault(key, []).append(name)
    n_calls = sum(len(v) for v in groups.values())
    require(n_calls == CONV_PATH_CALLS, f"{n_calls} kernel convs on the path, "
            f"expected {CONV_PATH_CALLS}")
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    rows = []
    for (wshape, stride, padding, pad_mode, has_bias, dims), names in groups.items():
        m = next(mm for nn_, mm, _ in shapes if nn_ == names[0])
        co, ci = wshape[:2]
        x32 = torch.randn(1, ci, *dims, device=DEVICE, generator=g)
        w = torch.randn(wshape, device=DEVICE, generator=g) * math.sqrt(2.0 / (ci * 27))
        b = torch.randn(co, device=DEVICE, generator=g) * 0.1 if has_bias else None
        pads = norm_padding(m.padding, m.kernel_size, stride, dims)
        row = {"convs": names, "w": list(wshape), "stride": list(stride), "in": list(dims)}
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


def check_instnorms(shapes, tol):
    from vangan_torch.models.layers import InstanceNorm
    from vangan_torch.ops.instnorm import instance_norm_act, instance_norm_act_plain

    groups = {}
    for name, m, shape in shapes:
        if isinstance(m, InstanceNorm):
            groups.setdefault((shape[1], shape[2:]), []).append((name, m.act))
    n_calls = sum(len(v) for v in groups.values())
    require(n_calls == IN_PATH_CALLS, f"{n_calls} InstanceNorms on the path, "
            f"expected {IN_PATH_CALLS}")
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    rows = []
    for (c, dims), uses in groups.items():
        x32 = torch.randn(1, c, *dims, device=DEVICE, generator=g) * 2 + 0.5
        gamma = torch.randn(c, device=DEVICE, generator=g) * 0.5 + 1
        beta = torch.randn(c, device=DEVICE, generator=g) * 0.2
        for act in ("none", "relu", "leaky_relu"):
            row = {"c": c, "in": list(dims), "act": act,
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
    from vangan_torch.models.factory import build_generator
    from vangan_torch.ops import build
    from vangan_torch.ops import conv3d as conv_ops
    from vangan_torch.ops import instnorm as in_ops

    t0 = time.perf_counter()
    build.build(verbose=True)
    build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {build.library_path()}")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    model = build_generator("resUnet", VanGanConfig(),
                            generator=torch.Generator().manual_seed(SEED)).to(DEVICE).eval()
    shapes = path_shapes(model)
    conv_rows = check_convs(shapes, tol)
    in_rows = check_instnorms(shapes, tol)
    check_generator(model, conv_ops, in_ops)
    del model
    torch.cuda.empty_cache()
    predict = check_predict(conv_ops, in_ops)

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
         "launches": predict["launches"]["conv3d_fwd"],
         "max_abs_err": max(r["bf16_abs_err"] for r in conv_rows),
         "ms": conv_ms, "plain_ms": conv_plain_ms},
        {"name": "instnorm_fwd", "route": "cuda",
         "source": "vangan_torch/ops/csrc/instnorm_fwd.cu",
         "replaces": "vangan_tpu/ops/pallas/instnorm.py:309",
         "launches": predict["launches"]["instnorm_fwd"],
         "max_abs_err": max(r["bf16_abs_err"] for r in in_rows),
         "ms": in_ms, "plain_ms": in_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
