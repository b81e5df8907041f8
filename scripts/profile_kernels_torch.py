#!/usr/bin/env python3
"""Device time of each CUDA kernel of the conv input gradient (K2), the
InstanceNorm forward (K4) and backward (K5), and the soft-skeleton rounds
(K6, K7) at the path's shapes, batch 3, from torch.profiler (no host time in
the numbers).

    python scripts/profile_kernels_torch.py

Prints the card's name and power limit, then one JSON line per kernel conv of
gen_IS and disc_I at 128^3 (chip_smoke.N) (max(Ci, Co) < 128): the device ms per call of
``conv3d_dgrad``'s main and fold kernels; of the forward kernel (K1) running
the same stride-1 sub-convs, one launch per stride parity with taps (how the
input gradient ran before it had a kernel of its own); and of cuDNN's
``conv3d_input``. Then one line per InstanceNorm shape (relu, bf16): the
forward on its plan (``fwd_plan``: small, cluster or stream) beside
``F.instance_norm`` and its bound (x read and y written once at 3.35 TB/s),
and the backward's kernels on its plan beside its bound (x, g read and dx
written once); one f32 128^3 line for the forward's stream route. Last, one
line for the skeleton of 3 x 128^3 with 15 iterations: the forward rounds
(K6) without residuals (``k6``, the ground truth's skeleton) and with them
(``k6_keep``, the prediction's, which the backward replays), each beside the
compare bound of chip_smoke.py (``k6_bound_ms``) and its design's byte floor
(``k6_floor_ms``: 62 f32 volumes moved, 63 with residuals, at 3.35 TB/s),
and the backward rounds (K7).
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (N, SKEL_ITERS, STEP_BATCH, path_shapes, skel_fwd_bound,  # noqa: E402
                        skel_fwd_floor_ms)

from vangan_torch.config import VanGanConfig  # noqa: E402
from vangan_torch.models.factory import build_discriminator, build_generator  # noqa: E402
from vangan_torch.models.layers import KERNEL_MAX_CHANNELS, ConvND, InstanceNorm  # noqa: E402
from vangan_torch.ops import conv3d as C  # noqa: E402
from vangan_torch.ops import instnorm as I  # noqa: E402
from vangan_torch.ops import skeleton as S  # noqa: E402

CUDA = torch.profiler.ProfilerActivity.CUDA


def kernel_ms(fn, reps: int = 3, tries: int = 3) -> dict:
    """Device ms per call of ``fn`` by kernel name (after a warm-up call); a
    profile that recorded no device event is taken again, up to ``tries``."""
    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(tries):
        with torch.profiler.profile(activities=[CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                m = re.search(r"(\w+_kernel\w*)(<[^(]*>)?", ev.key)
                name = m.group(0) if m else ev.key[:60]
                out[name] = out.get(name, 0.0) + ev.self_device_time_total / 1e3 / reps
        if out:
            break
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
        for dtype, c, dims in [(bf16, c, d) for c, d in sorted(norms)] + [
                (torch.float32, 16, (N,) * 3)]:
            x = torch.randn(STEP_BATCH, c, *dims, device=dev, generator=gd).to(dtype)
            gy = torch.randn(STEP_BATCH, c, *dims, device=dev, generator=gd).to(dtype)
            gamma, beta = torch.ones(c, device=dev), torch.zeros(c, device=dev)
            _, stats = I._instance_norm_act_cuda(x, gamma, beta, 1e-3, "relu", 0.2)
            n, esize = math.prod(dims), x.element_size()
            plan = I.fwd_plan(n, dtype, n * esize % 16 == 0)
            row = {"dtype": str(dtype), "c": c, "in": list(dims), "fwd_plan": vars(plan),
                   "fwd_bound_ms": 2 * esize * STEP_BATCH * c * n / 3.35e12 * 1e3,
                   "k4": kernel_ms(lambda: I._instance_norm_act_cuda(x, gamma, beta, 1e-3,
                                                                    "relu", 0.2)),
                   "library": kernel_ms(lambda: F.instance_norm(
                       x, weight=gamma.to(dtype), bias=beta.to(dtype), eps=1e-3))}
            if dtype == bf16:
                row["bwd_plan"] = vars(I.bwd_plan(n, bf16))
                row["bwd_bound_ms"] = 6 * STEP_BATCH * c * n / 3.35e12 * 1e3
                row["k5"] = kernel_ms(lambda: I._instance_norm_act_bwd_cuda(x, gy, stats, "relu",
                                                                           0.2))
            for part in ("k4", "library", "k5"):
                if part in row:
                    row[f"{part}_ms"] = sum(row[part].values())
            print(json.dumps(row))
            del x, gy, stats
        # the skeleton: 16 forward rounds (K6), 16 backward rounds (K7)
        shape = (STEP_BATCH, N, N, N, 1)
        nvox = math.prod(shape)
        img = (torch.randperm(nvox, device=dev, generator=gd).float() / nvox).reshape(shape)
        gy = torch.randn(shape, device=dev, generator=gd)
        _, imgs, skels = S._soft_skel_cuda(img, SKEL_ITERS, keep=True)
        row = {"shape": list(shape), "iters": SKEL_ITERS,
               "k6": kernel_ms(lambda: S._soft_skel_cuda(img, SKEL_ITERS, keep=False)),
               "k6_keep": kernel_ms(lambda: S._soft_skel_cuda(img, SKEL_ITERS, keep=True)),
               "k7": kernel_ms(lambda: S._soft_skel_bwd_cuda(imgs, skels, gy, shape))}
        for part in ("k6", "k6_keep", "k7"):
            row[f"{part}_ms"] = sum(row[part].values())
        row["k6_bound_ms"] = skel_fwd_bound(nvox)[0]
        row["k6_floor_ms"] = skel_fwd_floor_ms(nvox, keep=False)
        row["k6_keep_floor_ms"] = skel_fwd_floor_ms(nvox, keep=True)
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
