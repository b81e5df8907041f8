#!/usr/bin/env python3
"""Device time of each CUDA kernel of the conv input gradient (K2) and the
InstanceNorm backward (K5) at the path's bf16 shapes, batch 3, from
torch.profiler (no host time in the numbers).

    python scripts/profile_kernels_torch.py

Prints the card's name and power limit, then one JSON line per kernel conv of
gen_IS and disc_I at 128^3 (chip_smoke.N) (max(Ci, Co) < 128): the device ms per call of
``conv3d_dgrad``'s main and fold kernels; of the forward kernel (K1) running
the same stride-1 sub-convs, one launch per stride parity with taps (how the
input gradient ran before it had a kernel of its own); and of cuDNN's
``conv3d_input``. Then one line per InstanceNorm shape (relu): the
backward's kernels on its plan, beside the bound (x, g read and dx written
once at 3.35 TB/s).
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import STEP_BATCH, path_shapes  # noqa: E402

from vangan_torch.config import VanGanConfig  # noqa: E402
from vangan_torch.models.factory import build_discriminator, build_generator  # noqa: E402
from vangan_torch.models.layers import KERNEL_MAX_CHANNELS, ConvND, InstanceNorm  # noqa: E402
from vangan_torch.ops import conv3d as C  # noqa: E402
from vangan_torch.ops import instnorm as I  # noqa: E402

CUDA = torch.profiler.ProfilerActivity.CUDA


def kernel_ms(fn, reps: int = 3) -> dict:
    """Device ms per call of ``fn`` by kernel name (after a warm-up call)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(r"(\w+_kernel\w*)(<[^(]*>)?", ev.key)
            name = m.group(0) if m else ev.key[:60]
            out[name] = out.get(name, 0.0) + ev.self_device_time_total / 1e3 / reps
    return out


def convs(g):
    seen = set()
    for net, model in (("gen_IS", build_generator("resUnet", VanGanConfig(), generator=g)),
                       ("disc_I", build_discriminator(VanGanConfig(), generator=g))):
        for name, m, shape in path_shapes(model.to("cuda").eval()):
            if isinstance(m, ConvND) and max(m.weight.shape[:2]) < KERNEL_MAX_CHANNELS:
                key = (tuple(m.weight.shape), m.strides, str(m.padding), m.pad_mode, shape[2:])
                if key not in seen:
                    seen.add(key)
                    yield net, name, m, shape


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_kernels_torch: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    bf16, dev = torch.bfloat16, "cuda"
    g = torch.Generator().manual_seed(0)
    gd = torch.Generator(device=dev).manual_seed(0)
    norms = set()
    with torch.inference_mode():
        for net, name, m, shape in convs(g):
            co, ci = m.weight.shape[:2]
            k, s, dims = m.kernel_size, m.strides, shape[2:]
            pads = C.norm_padding(m.padding, k, s, dims)
            out = [(n + lo + hi - kk) // ss + 1 for n, (lo, hi), kk, ss in zip(dims, pads, k, s)]
            w = torch.randn(co, ci, *k, device=dev, generator=gd) * 0.1
            gy = torch.randn(STEP_BATCH, co, *out, device=dev, generator=gd).to(bf16)
            x_shape = (STEP_BATCH, ci, *dims)
            xp = C.padded_dims(dims, pads)
            row = {"net": net, "conv": name, "w": [co, ci, *k], "stride": list(s),
                   "in": list(dims), "k2": kernel_ms(
                       lambda: C.conv3d_dgrad(gy, w, x_shape, s, pads, m.pad_mode))}
            parities = [t for t in C.dgrad_launch_order(k, s, xp) if math.prod(t[1])]

            def k1_parities():
                for (px, py, pz), e, n in parities:
                    wsub = w[:, :, px::s[0], py::s[1], pz::s[2]].flip((2, 3, 4)).transpose(0, 1)
                    C._launch_fwd(gy, wsub, None, (1, 1, 1), [ee - 1 for ee in e], False, n,
                                  "conv3d")
            row["k1_parities"] = kernel_ms(k1_parities)
            row["cudnn"] = kernel_ms(lambda: torch.nn.grad.conv3d_input(
                (STEP_BATCH, ci, *xp), w.to(bf16), gy, s))
            for part in ("k2", "k1_parities", "cudnn"):
                row[f"{part}_ms"] = sum(row[part].values())
            print(json.dumps(row))
        for model in (build_generator("resUnet", VanGanConfig(), generator=g),
                      build_discriminator(VanGanConfig(), generator=g)):
            norms |= {(shape[1], shape[2:]) for _, m, shape in path_shapes(model.to(dev).eval())
                      if isinstance(m, InstanceNorm)}
        for c, dims in sorted(norms):
            x = torch.randn(STEP_BATCH, c, *dims, device=dev, generator=gd).to(bf16)
            gy = torch.randn(STEP_BATCH, c, *dims, device=dev, generator=gd).to(bf16)
            gamma, beta = torch.ones(c, device=dev), torch.zeros(c, device=dev)
            _, stats = I._instance_norm_act_cuda(x, gamma, beta, 1e-3, "relu", 0.2)
            n = math.prod(dims)
            row = {"c": c, "in": list(dims), "plan": vars(I.bwd_plan(n, bf16)),
                   "bound_ms": 6 * STEP_BATCH * c * n / 3.35e12 * 1e3,
                   "k5": kernel_ms(lambda: I._instance_norm_act_bwd_cuda(x, gy, stats, "relu",
                                                                        0.2))}
            row["k5_ms"] = sum(row["k5"].values())
            print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
