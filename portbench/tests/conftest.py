"""Shared pieces of the benchmark's tests: a tiny copy of the benchmark in a
temporary directory, and a run of the harness there on the CPU.

The tiny copy holds the real ``portbench/`` files with the configurations cut
to f = 4 filters in float32, 16^3 patches and a 40^3 volume, and limits set
for the CPU, where the program's plain path and the reference agree to
rounding in float32. ``drive`` runs ``run.main`` on it in a fresh
interpreter, optionally with a fault planted in the program first.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY_FIELDS = {"gen_filters": 4, "disc_filters": 4, "compute_dtype": "float32"}
TINY_TRAIN = {"generator": "train", "batch": 3, "patch": [16, 16, 16], "pool": 8, "noise_std": 0.1,
              "compared_steps": 3, "trace_from": 2, "trace_steps": 3, "label_steps": 2}
TINY_PREDICT = {"generator": "predict", "size": 40, "volumes": 2, "warm_size": 24, "patch": 16,
                "stride": 8, "pad_factor": 0.1, "blend": "gaussian", "batch": 8}
# float32 on both sides: the first step agrees to ~1e-5; Adam's per-element
# steps carry rounding of near-zero gradients into the later steps' changes
TINY_LIMITS = {"train": {"loss": 2e-3, "loss1": 1e-3, "grad1_median": 1e-3, "grad_net": 1e-3,
                         "change_median": 0.02},
               "predict": {"max_gap": 1e-3, "rms_gap": 1e-4}}

PLANTS = {
    "unchanged": "from vangan_torch.training.state import TrainState\n"
                 "TrainState.apply = lambda self, name, grads: None\n",
    "half_batch": "import dataclasses\n"
                  "from vangan_torch.vangan import VanGan\n"
                  "_on = VanGan._on_device\n"
                  "def _half(self, b):\n"
                  "    t = _on(self, b)\n"
                  "    return t[:(len(t) + 1) // 2]\n"
                  "VanGan._on_device = _half\n"
                  "_init = VanGan.__init__\n"
                  "def _init2(self, cfg, *a, **k):\n"
                  "    _init(self, cfg, *a, **k)\n"
                  "    n = (cfg.GLOBAL_BATCH_SIZE + 1) // 2\n"
                  "    self.scales = dataclasses.replace(self.scales, global_batch_size=n)\n"
                  "VanGan.__init__ = _init2\n",
    "altered_loss": "from vangan_torch.training import step\n"
                    "_cl = step.compute_losses\n"
                    "def _alt(*a, **k):\n"
                    "    total, res = _cl(*a, **k)\n"
                    "    res['seg_loss'] = res['seg_loss'] * 1.05\n"
                    "    return total, res\n"
                    "step.compute_losses = _alt\n",
    "altered_patch": "from vangan_torch.vangan import VanGan\n"
                     "_g = VanGan.gen_IS_batched\n"
                     "_n = [0]\n"
                     "def _alt(self, x):\n"
                     "    y = _g(self, x)\n"
                     "    _n[0] += 1\n"
                     "    if _n[0] > 4:  # past the tiny warm-up volume's 4 calls\n"
                     "        y = y.clone(); y[0] += 0.1\n"
                     "    return y\n"
                     "VanGan.gen_IS_batched = _alt\n",
    "half_patches": "import torch\n"
                    "from vangan_torch.vangan import VanGan\n"
                    "_g = VanGan.gen_IS_batched\n"
                    "def _half(self, x):\n"
                    "    k = (len(x) + 1) // 2\n"
                    "    y = _g(self, x[:k])\n"
                    "    return torch.cat([y, y[:len(x) - k]])\n"
                    "VanGan.gen_IS_batched = _half\n",
}


def make_tiny(dst: str, extra_mixes: dict = None, extra_cells: list = None) -> str:
    """A tiny copy of the benchmark at ``dst``; ``extra_mixes`` (name ->
    traffic) and ``extra_cells`` (workload entries) are added as files and
    entries, with tiny limits."""
    shutil.copytree(os.path.join(REPO, "portbench"), os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        path = os.path.join(dst, c["file"])
        with open(path) as f:
            doc = json.load(f)
        doc["fields"].update(TINY_FIELDS)
        with open(path, "w") as f:
            json.dump(doc, f)
    mixes = {"train": TINY_TRAIN, "predict": TINY_PREDICT, **(extra_mixes or {})}
    for name, mix in mixes.items():
        with open(os.path.join(dst, "portbench", "traffic", name + ".json"), "w") as f:
            json.dump(mix, f)
    gen = {w["name"]: mixes[w["traffic"]]["generator"] for w in bench["workloads"]}
    for cell in extra_cells or []:  # the entries a later change adds with a cell
        bench["workloads"].append(cell)
        for m in bench["end_to_end"] + bench["per_layer"]:
            if any(gen[w] == mixes[cell["traffic"]]["generator"] for w in m.get("workloads", [])):
                m["workloads"].append(cell["name"])
    for w in bench["workloads"]:
        with open(os.path.join(dst, "portbench", "limits", w["name"] + ".json"), "w") as f:
            json.dump({"limits": TINY_LIMITS[mixes[w["traffic"]]["generator"]]}, f)
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dst


def drive(root: str, workload: str, seed: int = 3000000007, seconds: float = 0.5,
          plant: str = None, timeout: int = 600):
    """(exit code, the result's JSON or None, stderr) of one CPU run of the
    harness on ``root``, with ``PLANTS[plant]`` run first."""
    code = (f"import sys\nsys.path.insert(0, {REPO!r})\nimport torch\ntorch.set_num_threads(2)\n"
            + (PLANTS[plant] if plant else "")
            + "from portbench import run\n"
            f"sys.exit(run.main(['--workload', {workload!r}, '--seed', '{seed}', "
            f"'--seconds', '{seconds}', '--trace', '0'], root={root!r}, device='cpu'))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=timeout, cwd=root)
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None
    return proc.returncode, result, proc.stderr


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    return make_tiny(str(tmp_path_factory.mktemp("tiny")))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs an NVIDIA card (skips without one)")
