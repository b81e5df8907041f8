#!/usr/bin/env python3
"""Save, or compare, the result of one seeded train step of the port.

    python scripts/step_digest_torch.py --root DIR --out FILE.pt [--batch 3] [--micro-batches 1]
    python scripts/step_digest_torch.py --compare A.pt B.pt

The first form imports ``vangan_torch`` from ``DIR`` (a checkout, e.g. this
tree or an unpacked parent commit), builds BASELINE config 2 on the GPU
(ResU-Nets f=16, PatchGANs f=64, 15-iteration clDice, bf16, 128^3) from its
seeded weights, runs one kernel-path train step (noise sigma 0.1) on the
seeded batch of ``bench_train_step_torch.py`` and saves every network's
parameters and buffers and the loss dict. The second form says whether two
such files are equal bit for bit, network by network, and exits 1 if they
are not. The card's name and power limit are printed first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

NOISE = 0.1


def run(root: str, out: str, batch: int, micro: int) -> None:
    sys.path.insert(0, os.path.abspath(root))
    from vangan_torch.config import VanGanConfig
    from vangan_torch.vangan import VanGan

    kw = {} if micro == 1 else {"micro_batches": micro}  # a parent may lack the field
    cfg = VanGanConfig(BATCH_SIZE=batch, **kw)
    gan = VanGan(cfg, device="cuda")
    rng = np.random.default_rng(cfg.seed)
    shape = (cfg.GLOBAL_BATCH_SIZE, *cfg.SUBVOL_PATCH_SIZE, 1)
    real_I = torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)).cuda()
    seg = rng.uniform(size=shape) > 0.7
    real_S = torch.from_numpy(np.where(seg, 1.0, -1.0).astype(np.float32)).cuda()
    gan.set_use_kernels(True)
    losses = gan.distributed_train_step(real_I, real_S, NOISE, True)
    torch.save({"nets": {n: {k: v.detach().cpu() for k, v in net.state_dict().items()}
                         for n, net in gan.nets.items()},
                "losses": {k: v.detach().cpu() for k, v in losses.items()}}, out)
    print(json.dumps({"saved": out, "root": root, "losses": {k: float(v)
                                                             for k, v in losses.items()}}))


def compare(a: str, b: str) -> bool:
    x, y = torch.load(a), torch.load(b)
    same = {n: x["nets"][n].keys() == y["nets"][n].keys()
            and all(torch.equal(x["nets"][n][k], y["nets"][n][k]) for k in x["nets"][n])
            for n in x["nets"]}
    same["losses"] = x["losses"].keys() == y["losses"].keys() and all(
        torch.equal(x["losses"][k], y["losses"][k]) for k in x["losses"])
    print(json.dumps({"bit_identical": same}))
    return all(same.values())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--out")
    p.add_argument("--batch", type=int, default=3)
    p.add_argument("--micro-batches", type=int, default=1)
    p.add_argument("--compare", nargs=2, metavar=("A", "B"))
    args = p.parse_args(argv)
    if args.compare:
        return 0 if compare(*args.compare) else 1
    if not torch.cuda.is_available():
        print("step_digest_torch: CUDA is not available", file=sys.stderr)
        return 1
    if not args.out:
        p.error("--out is required to run a step")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    print(smi.stdout.strip())
    run(args.root, args.out, args.batch, args.micro_batches)
    return 0


if __name__ == "__main__":
    sys.exit(main())
