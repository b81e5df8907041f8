#!/usr/bin/env python3
"""Time the ResNet generator's kernel convs and the generator itself on one GPU.

    python scripts/bench_resnet_convs_torch.py [--root DIR] [--reps 5]

Imports ``vangan_torch`` from ``DIR`` (default: this checkout; an unpacked
parent commit, to compare two trees in one call). For each kernel conv of the
factory's ResNet generator (32 filters: the 7^3 reflect stem 1 -> 32 and
head 32 -> 1, down0 32 -> 64 3^3 stride 2, up2 64 -> 32 4^3 'same') at the
train step's batch of 3 and 128^3, bf16: K1 (forward), K2 (input gradient)
and K3 (weight gradient) on the kernels, their plain versions and the
library call (cuDNN: ``F.conv3d``, ``torch.nn.grad.conv3d_input`` /
``conv3d_weight``), CUDA-event ms (median of ``--reps`` after a warm-up),
each beside its bound (the larger of its FLOPs at 989 TFLOP/s and its bytes
at 3.35 TB/s: x, w and y each once in bf16; dW in f32) and its plan's route.
Then the generator alone, batch 1, 128^3, in training (dropout from one
seed), forward and backward of ``sum(out * gy)`` on both paths in turns
(plain, kernel, kernel, plain, plain, kernel), CUDA-event ms. Prints the
card's name and power limit, then one JSON line per conv and one for the
generator.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

BATCH, N, SEED = 3, 128, 0
HBM_BYTES_PER_S, BF16_FLOP_PER_S = 3.35e12, 989e12
# (name, Ci, Co, k, stride, padding, pad_mode)
CONVS = (("stem_conv", 1, 32, 7, 1, ((3, 3),) * 3, "reflect"),
         ("down0", 32, 64, 3, 2, ((1, 1),) * 3, "reflect"),
         ("up2", 64, 32, 4, 1, "same", "zeros"),
         ("head", 32, 1, 7, 1, ((3, 3),) * 3, "reflect"))


def cuda_ms(fn, reps):
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


def bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / BF16_FLOP_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_convs(C, reps):
    from vangan_torch.ops.pad import pad3d

    g = torch.Generator(device="cuda").manual_seed(SEED)
    bf16 = torch.bfloat16
    for name, ci, co, k, s, padding, pad_mode in CONVS:
        ks, st, dims = (k,) * 3, (s,) * 3, (N,) * 3
        pads = C.norm_padding(padding, ks, st, dims)
        out = [(n + lo + hi - k) // s + 1 for n, (lo, hi) in zip(dims, pads)]
        x = torch.randn(BATCH, ci, *dims, device="cuda", generator=g).to(bf16)
        w = torch.randn(co, ci, *ks, device="cuda", generator=g) * math.sqrt(2.0 / (ci * k ** 3))
        gy = torch.randn(BATCH, co, *out, device="cuda", generator=g).to(bf16)
        xp = pad3d(x, pads, pad_mode)
        flops = 2 * BATCH * math.prod(out) * co * ci * k ** 3
        nbytes = 2 * (BATCH * ci * N ** 3 + co * ci * k ** 3 + BATCH * co * math.prod(out))
        ops = {
            "fwd": (lambda: C.conv3d(x, w, None, st, padding, pad_mode),
                    lambda: C.conv3d_plain(x, w, None, st, pads, pad_mode),
                    lambda: F.conv3d(xp, w.to(bf16), None, st), nbytes),
            "dgrad": (lambda: C.conv3d_dgrad(gy, w, x.shape, st, pads, pad_mode),
                      lambda: C.conv3d_dgrad_plain(gy, w, x.shape, st, pads, pad_mode),
                      lambda: torch.nn.grad.conv3d_input(xp.shape, w.to(bf16), gy, st), nbytes),
            "wgrad": (lambda: C.conv3d_wgrad(x, gy, w.shape, st, pads, pad_mode),
                      lambda: C.conv3d_wgrad_plain(x, gy, w.shape, st, pads, pad_mode),
                      lambda: torch.nn.grad.conv3d_weight(xp, w.shape, gy, st),
                      nbytes + 2 * co * ci * k ** 3),
        }
        row = {"conv": name, "w": [co, ci, *ks], "stride": s, "batch": BATCH, "in": N,
               "gflop": flops / 1e9}
        with torch.inference_mode():
            for op, (kern, plain, lib, nb) in ops.items():
                kw = dict(in_dims=dims, pads=pads, pad_mode=pad_mode) if op == "dgrad" else {}
                plan = C.conv_plan(op, ci, co, ks, st, out, bf16, BATCH, **kw)
                got, want = kern(), plain()
                err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
                row[op] = {"route": plan.route, "tap_chunks": getattr(plan, "tap_chunks", 0),
                           "rel_err": err, "ms": cuda_ms(kern, reps),
                           "plain_ms": cuda_ms(plain, reps), "library_ms": cuda_ms(lib, reps),
                           "bound_ms": bound_ms(flops, nb)}
        print(json.dumps(row), flush=True)


def time_generator():
    from vangan_torch.config import VanGanConfig
    from vangan_torch.models.factory import build_generator

    rng = np.random.default_rng(SEED + 7)
    x = torch.from_numpy(rng.uniform(-1, 1, (1, N, N, N, 1)).astype(np.float32)).cuda()
    gy = torch.from_numpy(rng.normal(size=(1, N, N, N, 1)).astype(np.float32)).cuda()
    model = build_generator("resnet", VanGanConfig(),
                            generator=torch.Generator().manual_seed(SEED)).cuda()

    def run(kernels):
        model.set_use_kernels(kernels)
        model.zero_grad(set_to_none=True)
        y = model(x, True, torch.Generator(device="cuda").manual_seed(SEED + 8))
        (y * gy).sum().backward()

    times = {"kernel": [], "plain": []}
    for kernels in (True, False):  # warm-up
        run(kernels)
    for path in ("plain", "kernel", "kernel", "plain", "plain", "kernel"):
        times[path].append(cuda_ms(lambda: run(path == "kernel"), reps=1))
    print(json.dumps({"generator": "resnet", "batch": 1, "in": N,
                      "kernel_ms_fwd_bwd": float(np.median(times["kernel"])),
                      "plain_ms_fwd_bwd": float(np.median(times["plain"])),
                      "kernel_ms_all": times["kernel"], "plain_ms_all": times["plain"]}),
          flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   help="the checkout whose vangan_torch is timed")
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_resnet_convs_torch: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    print(smi.stdout.strip())
    sys.path.insert(0, os.path.abspath(args.root))
    from vangan_torch.ops import conv3d as C

    print(json.dumps({"root": os.path.abspath(args.root), "package": C.__file__}), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    time_convs(C, args.reps)
    time_generator()
    return 0


if __name__ == "__main__":
    sys.exit(main())
