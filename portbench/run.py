#!/usr/bin/env python3
"""Run one cell of the benchmark of ``vangan_torch`` and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell is the entry of ``BENCHMARK.json``'s
``workloads`` named ``<name>``; its configuration is the file the entry's
``config`` names, its mix ``portbench/traffic/<traffic>.json``, whose
``generator`` names the code in ``portbench/generators/`` that runs it, and
its limits ``portbench/limits/<name>.json``. With ``--trace 0`` the result holds the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, each
read by ``portbench/metrics/<metric>.py``. The last line of standard output
is the result, one JSON object; the numbers compared for ``correct`` are the
last lines of standard error.

The run fails, and prints no result, without CUDA or with fewer cards than
the cell asks for, without the program beside the benchmark, or when JAX,
flax or the JAX package has been loaded by the time the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
    sys.path.pop(0)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "vangan_tpu")


def load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def applies(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def main(argv=None, root: str = ROOT, device: str = None, out=None) -> int:
    """``device`` None: the card, after the look for one; the tests pass
    "cpu" and a ``root`` of their own."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    out = out or sys.stdout

    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"portbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    if not os.path.isdir(os.path.join(ROOT, "vangan_torch")):
        print("portbench: the program (vangan_torch/) is not beside the benchmark",
              file=sys.stderr)
        return 2

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        device = "cuda"
    dev = torch.device(device)

    from portbench import check
    from portbench.run_support import Run

    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, config["file"])) as f:
        fields = json.load(f)["fields"]
    with open(os.path.join(root, "portbench", "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    limits = check.load_limits(root, args.workload)
    generator = load_file(os.path.join(root, "portbench", "generators",
                                       traffic["generator"] + ".py"),
                          f"portbench_generator_{traffic['generator']}")
    h = Run(root, args.workload, fields, traffic, args.seed, args.seconds, bool(args.trace),
            dev, T_START)
    torch.empty(1, device=dev)  # the device's context
    h.mark("start")
    res = generator.run(h)

    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 4

    if args.trace:
        metrics = {}
        for m in bench["per_layer"]:
            if not applies(m, args.workload):
                continue
            reader = load_file(os.path.join(root, "portbench", "metrics", m["name"] + ".py"),
                               "portbench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(res.get("trace"))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {}
        for m in bench["end_to_end"]:
            if applies(m, args.workload):
                value = res["setup_s"] if m["name"] == "setup_s" else res["e2e"][m["name"]]
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    correct, checks = check.judge(res["numbers"], limits)
    correct = correct and res["failed"] == 0
    if dev.type == "cuda":
        device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
                       "memory_peak_bytes": res["memory_peak_bytes"]}
    else:
        device_info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    result = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
              "metrics": metrics, "device": device_info}
    if args.trace and res.get("trace"):
        s = res["trace"]["summary"]
        device_info["busy_s"] = s.busy_s
        device_info["window_s"] = s.window_s
        result["breakdown"] = s.breakdown(res["trace"].get("labelled"))
    result["window"] = {**res["window"], "setup_phases_s": h.phases}
    result["readings"] = {k: v for k, v in res["numbers"].items() if k not in checks}
    result["checks"] = checks
    print("setup_s by phase: " + ", ".join(f"{k} {v:.3f}" for k, v in h.phases.items()),
          file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(_finite(result)), file=out)
    out.flush()
    return 0


def _finite(x):
    """``x`` with every float that is not finite as None (strict JSON)."""
    if isinstance(x, float):
        return x if math.isfinite(x) else None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    return x


if __name__ == "__main__":
    sys.exit(main())
