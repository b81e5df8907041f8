#!/usr/bin/env python3
"""Time (and optionally profile) the port's full-width test step on one GPU.

    python scripts/bench_test_step_torch.py [--batch 3] [--gen resUnet] [--profile]

The evaluation step of BASELINE config 2 (``VanGan.distributed_test_step``:
two ResU-Net generators f=16 applied twice each, or with ``--gen vnet`` the
V-Nets of config 4, or ``--gen resnet`` the ResNet generators; two PatchGAN
discriminators f=64 applied twice each, the full loss set with 15-iteration
clDice; bf16,
128^3 patches) from seeded weights on a seeded batch (``real_I`` uniform in
[-1, 1], ``real_S`` binary in {-1, 1}). It prints the card's name and power
limit, then one JSON line per step on the kernel path and the plain path in
turns (plain, kernel, kernel, plain; ms per step by CUDA events, peak device
memory), one JSON line of CUDA-event ms per layer of the step on each path
(median of 3), and with ``--profile`` a torch.profiler breakdown of one
kernel-path step by kernel family (and the device ms of the transposed
convs, BatchNorm and max-pool). The device's idle share is taken against
the CUDA-event time of a kernel-path step without the profiler, whose start
inflates the wall time of the profiled step.
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
from vangan_torch.losses import (  # noqa: E402
    cycle_loss,
    cycle_reconstruction,
    cycle_seg_loss,
    discriminator_loss_fn,
    generator_loss_fn,
)
from vangan_torch.vangan import VanGan  # noqa: E402


def cuda_ms(fn, reps=3) -> float:
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


def step(gan, real_I, real_S, kernels: bool) -> dict:
    gan.set_use_kernels(kernels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: gan.distributed_test_step(real_I, real_S), reps=1)
    return {"path": "kernel" if kernels else "plain", "ms_per_step": ms,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def layers(gan, real_I, real_S, kernels: bool) -> dict:
    """CUDA-event ms of each layer of one step, on its own."""
    gan.set_use_kernels(kernels)
    n, sc, cfg = gan.nets, gan.scales, gan.cfg
    with torch.inference_mode():
        fake_S, fake_I = n["gen_IS"](real_I), n["gen_SI"](real_S)
        cycled_S, cycled_I = n["gen_IS"](fake_I), n["gen_SI"](fake_S)
        d_fake = n["disc_S"](fake_S)
        parts = {
            "generators (4 calls)": lambda: (n["gen_IS"](real_I), n["gen_SI"](real_S),
                                             n["gen_IS"](fake_I), n["gen_SI"](fake_S)),
            "discriminators (4 calls)": lambda: (n["disc_S"](real_S), n["disc_I"](real_I),
                                                 n["disc_S"](fake_S), n["disc_I"](fake_I)),
            "seg loss (2 skeletons, dice, clDice)": lambda: cycle_seg_loss(sc, real_S, cycled_S),
            "SSIM reconstruction": lambda: cycle_reconstruction(sc, real_I, cycled_I),
            "cycle losses (bce, mse)": lambda: (
                cycle_loss(sc, real_S, cycled_S, cfg.cycle_loss_I_type),
                cycle_loss(sc, real_I, cycled_I, cfg.cycle_loss_S_type)),
            "adversarial losses (4)": lambda: (
                generator_loss_fn(sc, d_fake), generator_loss_fn(sc, d_fake),
                discriminator_loss_fn(sc, d_fake, d_fake),
                discriminator_loss_fn(sc, d_fake, d_fake)),
        }
        out = {name: cuda_ms(fn) for name, fn in parts.items()}
    return {"path": "kernel" if kernels else "plain", "layer_ms": out}


def profile(gan, real_I, real_S, step_ms: float) -> dict:
    from torch.profiler import ProfilerActivity, profile as tprofile

    gan.set_use_kernels(True)
    gan.distributed_test_step(real_I, real_S)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                  record_shapes=True) as prof:
        gan.distributed_test_step(real_I, real_S)
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
        print("bench_test_step_torch: CUDA is not available", file=sys.stderr)
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
                      "compute_dtype": cfg.compute_dtype, "gen": args.gen}))
    kernel_ms = []
    for kernels in (False, True, True, False):
        res = step(gan, real_I, real_S, kernels)
        if kernels:
            kernel_ms.append(res["ms_per_step"])
        print(json.dumps(res))
    for kernels in (False, True):
        print(json.dumps(layers(gan, real_I, real_S, kernels)))
    if args.profile:
        print(json.dumps({"profile": profile(gan, real_I, real_S, float(np.median(kernel_ms)))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
