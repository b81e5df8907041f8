#!/usr/bin/env python3
"""The readings that the limits of ``portbench/limits/`` are set from, at a
cell's own size, on the card: the control, and faults planted in the
reference put in the program's place.

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...]

For each seed it prints one JSON line of the numbers that ``check`` compares,
of each of these against the float32 reference:

- ``control``: the reference computed one precision below the
  configuration's: every conv's input and weight rounded to float8 e4m3 (the
  configuration computes in bfloat16);
- training cells: ``half_batch``, the steps on the first half of each batch
  (rounded up), the losses the mean over those rows;
- predict cells: the control alone (faults hold only training cells'
  numbers; ``tests/test_portbench_faults.py`` plants them in the program).

A state left unchanged reads 1 by the training comparison's measure and
needs no run. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path.pop(0)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from portbench import check, data  # noqa: E402
from portbench.generators import predict as pgen  # noqa: E402
from portbench.generators import train as tgen  # noqa: E402
from portbench.reference import stitch as ref_stitch  # noqa: E402
from portbench.reference.draws import Draws  # noqa: E402
from portbench.reference.layers import Ctx  # noqa: E402
from portbench.reference.nets import kind  # noqa: E402
from portbench.run_support import Run, no_tf32  # noqa: E402

CONTROL_DTYPE = torch.float8_e4m3fn


def load_cell(root: str, workload: str):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, config["file"])) as f:
        fields = json.load(f)["fields"]
    with open(os.path.join(root, "portbench", "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return fields, traffic


def train_readings(h: Run) -> dict:
    tr = h.traffic
    fields = {**h.fields, "BATCH_SIZE": tr["batch"], "seed": h.seed}
    pool = data.train_pool(tr["pool"], tuple(tr["patch"]), h.seed, h.device)
    n = tr["compared_steps"]
    ref = tgen.reference_readings(h, fields, pool, tr["batch"], n)
    ctl = tgen.reference_readings(h, fields, pool, tr["batch"], n, quant=CONTROL_DTYPE)
    half = tgen.reference_readings(h, fields, pool, tr["batch"], n, rows=(tr["batch"] + 1) // 2)
    return {"control": check.train_numbers(ctl, ref), "half_batch": check.train_numbers(half, ref)}


def predict_readings(h: Run) -> dict:
    from portbench.reference.step import specs
    from portbench import weights

    tr, dev = h.traffic, h.device
    vol = data.volume(tr["size"], pgen.volume_seed(h.seed, 0), dev)
    P = weights.make(specs(h.fields), h.seed, dev)["gen_IS"]
    net = kind(h.fields["gen_i2s"])
    seg = Draws(None, dev, torch.float32).segment()

    def stitched(gen):
        with no_tf32():
            return ref_stitch.stitch(gen, vol, tr["patch"], tr["stride"], tr["pad_factor"],
                                     tr["batch"], dev)

    def plain(quant=None):
        ctx = Ctx(quant=quant)
        return lambda x: net.forward(P, x, ctx, seg, False, 0.0)

    ref = stitched(plain())
    return {"control": check.predict_numbers(stitched(plain(CONTROL_DTYPE)), ref)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: CUDA is not available", file=sys.stderr)
        return 3
    fields, traffic = load_cell(ROOT, args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        h = Run(ROOT, args.workload, fields, traffic, seed, 0.0, False, torch.device("cuda"),
                t0)
        res = (train_readings if traffic["generator"] == "train" else predict_readings)(h)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **res}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
