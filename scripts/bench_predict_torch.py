#!/usr/bin/env python3
"""Time (and optionally profile) the port's sliding-window predict on one GPU.

    python scripts/bench_predict_torch.py [--size 600] [--stride 64] [--pad 0.1]
        [--blend gaussian] [--profile]

Defaults are the JAX package's inference benchmark volume (BASELINE config 3,
bench.py: a ~600^3 volume, 128^3 patches, stride 64, padFactor 0.1, Gaussian
blend, batch 8) with a full-width gen_IS (f=16, bf16) from seeded weights and a
seeded volume. It warms up on a 256^3 volume, then times the kernel path and
the plain path in turns (plain, kernel, kernel, plain) and prints one JSON
line per run with seconds, Mvox/s and peak device memory, and the card's name
and power limit. ``--profile`` adds a torch.profiler breakdown of one
kernel-path run by kernel family and the device's idle share.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vangan_torch.config import VanGanConfig  # noqa: E402
from vangan_torch.inference.stitcher import stitch_origins, stitch_subvolumes  # noqa: E402
from vangan_torch.vangan import VanGan  # noqa: E402

FAMILIES = (  # (family, substrings of the device kernel name), first match wins
    ("conv3d_fwd (ours)", ("conv3d_fwd_",)),
    ("conv3d_dgrad (ours)", ("conv3d_dgrad_",)),
    ("conv3d_wgrad (ours)", ("conv3d_wgrad_",)),
    ("instnorm_fwd (ours)", ("in_fwd_kernel",)),
    ("instnorm_bwd (ours)", ("in_bwd_",)),
    ("soft_skel_fwd (ours)", ("skel_round_kernel",)),
    ("soft_skel_bwd (ours)", ("skel_bwd_",)),
    ("pooling", ("max_pool", "pool3d")),
    ("batch norm (library)", ("batch_norm", "bn_fw", "bn_bw")),
    ("library conv (cuDNN)", ("cudnn", "conv", "xmma", "gemm", "implicit")),
    ("upsample", ("upsample",)),
    ("concat / copy", ("cat", "copy", "Memcpy", "Memset")),
    ("elementwise / reduce", ("elementwise", "reduce", "Reduce", "index", "tanh")),
)


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


def library_op_ms(prof) -> dict:
    """Device ms of the library ops that the V-Net adds, from a profile taken
    with ``record_shapes=True``: the transposed convs (forward and backward:
    the convs with a 2^3 kernel, which only the deconvs have), BatchNorm and
    max-pool, each forward and backward (``device_time_total`` of the aten
    op, its kernels included; the families above count them by kernel name,
    the transposed convs under cuDNN)."""
    ops = {"aten::native_batch_norm": "batch_norm fwd",
           "aten::native_batch_norm_backward": "batch_norm bwd",
           "aten::max_pool3d_with_indices": "max_pool fwd",
           "aten::max_pool3d_with_indices_backward": "max_pool bwd"}
    deconv = {"aten::convolution": "conv_transpose fwd",
              "aten::convolution_backward": "conv_transpose bwd"}
    out = {}
    for ev in prof.key_averages(group_by_input_shape=True):
        name = ops.get(ev.key)
        if ev.key in deconv and any(len(s) == 5 and list(s[2:]) == [2, 2, 2]
                                    for s in ev.input_shapes):
            name = deconv[ev.key]
        if name:
            out[name] = out.get(name, 0.0) + ev.device_time_total / 1e3
    return out


def run(gan, vol, args, kernels: bool) -> dict:
    gan.gen_IS.set_use_kernels(kernels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stitch_subvolumes(gan.gen_IS_batched, vol, gan.cfg.subvol_size,
                      stride=(args.stride,) * 3, complete=True, padFactor=args.pad,
                      save=False, batch_size=gan.cfg.stitcher_batch, blend=args.blend,
                      device="cuda")
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    return {"path": "kernel" if kernels else "plain", "seconds": s,
            "mvox_per_s": vol.size / s / 1e6,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def profile(gan, vol, args) -> dict:
    from torch.profiler import ProfilerActivity, profile as tprofile

    gan.gen_IS.set_use_kernels(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        stitch_subvolumes(gan.gen_IS_batched, vol, gan.cfg.subvol_size,
                          stride=(args.stride,) * 3, complete=True, padFactor=args.pad,
                          save=False, batch_size=gan.cfg.stitcher_batch, blend=args.blend,
                          device="cuda")
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_family, device_ms = {}, 0.0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3
        by_family[family(ev.key)] = by_family.get(family(ev.key), 0.0) + ms
        device_ms += ms
    return {"wall_ms": wall_ms, "device_busy_ms": device_ms,
            "idle_share": 1.0 - device_ms / wall_ms,
            "by_family_ms": dict(sorted(by_family.items(), key=lambda kv: -kv[1]))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", type=int, default=600)
    p.add_argument("--stride", type=int, default=64)
    p.add_argument("--pad", type=float, default=0.1)
    p.add_argument("--blend", default="gaussian", choices=("uniform", "gaussian"))
    p.add_argument("--profile", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_predict_torch: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    print(smi.stdout.strip())

    cfg = VanGanConfig()
    gan = VanGan(cfg, device="cuda")
    rng = np.random.default_rng(cfg.seed)
    vol = rng.normal(100.0, 40.0, (args.size,) * 3 + (1,)).astype(np.float32)
    padded = [n + 2 * int(args.pad * n) for n in vol.shape[:3]]
    origins = stitch_origins(padded, cfg.SUBVOL_PATCH_SIZE, (args.stride,) * 3)
    print(json.dumps({"volume": list(vol.shape[:3]), "padded": padded,
                      "patches": len(origins), "unique_patches": len(set(origins)),
                      "batch": cfg.stitcher_batch, "blend": args.blend}))

    warm = rng.normal(100.0, 40.0, (256,) * 3 + (1,)).astype(np.float32)
    for kernels in (True, False):
        run(gan, warm, args, kernels)
    for kernels in (False, True, True, False):
        print(json.dumps(run(gan, vol, args, kernels)))
    if args.profile:
        print(json.dumps({"profile": profile(gan, vol, args)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
