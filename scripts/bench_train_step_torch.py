#!/usr/bin/env python3
"""Time (and optionally profile) the port's full-width train step on one GPU.

    python scripts/bench_train_step_torch.py [--batch 3] [--gen resUnet] [--profile]

The train step of BASELINE config 2 (``VanGan.distributed_train_step``: two
ResU-Net generators f=16 applied twice each, or with ``--gen vnet`` the
V-Nets of config 4 (the i2s one 32 filters with InstanceNorm, the s2i one 16
with BatchNorm and deconvs, spatial dropout 0.5), or ``--gen resnet`` the
ResNet generators; two PatchGAN discriminators f=64
applied three times each with noise sigma 0.1 and dropout, the full loss set
with 15-iteration clDice, one backward, clip + Adam for all four networks;
bf16, 128^3 patches) from seeded weights on a seeded batch (``real_I``
uniform in [-1, 1], ``real_S`` binary in {-1, 1}). It prints the card's name
and power limit, then one JSON line per step on the kernel path and the
plain path in turns after a warm-up step of each (plain, kernel, kernel,
plain, plain, kernel; ms per step by CUDA events, peak device memory), one
JSON line per path of CUDA-event ms per layer group of the step (generator
forward, cycle losses, discriminator forward, adversarial losses, backward,
optimizer; median of 3 steps, events recorded at the step's phase marks), and
with ``--profile`` a torch.profiler breakdown of one kernel-path step by
kernel family, with the device ms of the transposed convs, BatchNorm and
max-pool. The device's idle share is taken against the CUDA-event time of a
kernel-path step without the profiler.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_predict_torch import family, library_op_ms  # noqa: E402

from vangan_torch.config import VanGanConfig  # noqa: E402
from vangan_torch.training import step as train_step  # noqa: E402
from vangan_torch.vangan import VanGan  # noqa: E402

NOISE = 0.1
GROUPS = ("generators", "cycle_losses", "discriminators", "adversarial_losses", "backward",
          "optimizer")


def timed_step(gan, real_I, real_S, kernels: bool) -> dict:
    gan.set_use_kernels(kernels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    gan.distributed_train_step(real_I, real_S, NOISE, True)
    b.record()
    b.synchronize()
    return {"path": "kernel" if kernels else "plain", "ms_per_step": a.elapsed_time(b),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def layer_ms(gan, real_I, real_S, kernels: bool, reps: int = 3) -> dict:
    """CUDA-event ms between the step's phase marks (median of ``reps``)."""
    gan.set_use_kernels(kernels)
    runs = []
    for _ in range(reps):
        events = [("start", torch.cuda.Event(enable_timing=True))]
        events[0][1].record()

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((name, ev))

        train_step.train_step(gan.nets, gan.cfg, gan.scales, gan.state, real_I, real_S, NOISE,
                              True, gan.generator, mark=mark)
        torch.cuda.synchronize()
        runs.append({name: prev.elapsed_time(ev)
                     for (_, prev), (name, ev) in zip(events, events[1:])})
    return {"path": "kernel" if kernels else "plain",
            "layer_ms": {g: float(np.median([r[g] for r in runs])) for g in GROUPS}}


def profile(gan, real_I, real_S, step_ms: float) -> dict:
    from torch.profiler import ProfilerActivity, profile as tprofile

    gan.set_use_kernels(True)
    gan.distributed_train_step(real_I, real_S, NOISE, True)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                  record_shapes=True) as prof:
        gan.distributed_train_step(real_I, real_S, NOISE, True)
        torch.cuda.synchronize()
    by_family, device_ms = {}, 0.0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3
        by_family[family(ev.key)] = by_family.get(family(ev.key), 0.0) + ms
        device_ms += ms
    return {"step_ms": step_ms, "device_busy_ms": device_ms,
            "idle_share": 1.0 - device_ms / step_ms,
            "by_family_ms": dict(sorted(by_family.items(), key=lambda kv: -kv[1])),
            "library_op_ms": library_op_ms(prof)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=3)
    p.add_argument("--profile", action="store_true")
    p.add_argument("--gen", choices=("resUnet", "vnet", "resnet"), default="resUnet",
                   help="both generators' kind: resUnet (config 2), vnet (config 4), resnet")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_train_step_torch: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    print(smi.stdout.strip())

    cfg = VanGanConfig(BATCH_SIZE=args.batch, gen_i2s=args.gen, gen_s2i=args.gen)
    gan = VanGan(cfg, device="cuda")
    rng = np.random.default_rng(cfg.seed)
    shape = (cfg.GLOBAL_BATCH_SIZE, *cfg.SUBVOL_PATCH_SIZE, 1)
    real_I = torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)).cuda()
    seg = rng.uniform(size=shape) > 0.7
    real_S = torch.from_numpy(np.where(seg, 1.0, -1.0).astype(np.float32)).cuda()
    print(json.dumps({"batch": list(shape), "cldice_iters": cfg.cldice_iters,
                      "compute_dtype": cfg.compute_dtype, "gen": args.gen, "noise_std": NOISE}))
    for kernels in (True, False):  # warm-up (allocator, cuDNN plans, the kernel build)
        timed_step(gan, real_I, real_S, kernels)
    kernel_ms = []
    for kernels in (False, True, True, False, False, True):
        res = timed_step(gan, real_I, real_S, kernels)
        if kernels:
            kernel_ms.append(res["ms_per_step"])
        print(json.dumps(res))
    for kernels in (False, True):
        print(json.dumps(layer_ms(gan, real_I, real_S, kernels)))
    if args.profile:
        print(json.dumps({"profile": profile(gan, real_I, real_S, float(np.median(kernel_ms)))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
