"""Runs of the harness with the timed path broken underneath come out not
correct, and so does the control (the reference one precision below the
configuration's, in the program's place)."""

import os

import pytest
import torch

from conftest import REPO, TINY_LIMITS, drive

from portbench import check, control
from portbench.run_support import Run


@pytest.mark.parametrize("plant", ["unchanged", "half_batch", "altered_loss"])
def test_a_broken_train_step_is_not_correct(tiny, plant):
    rc, result, err = drive(tiny, "resunet-train-b3", plant=plant)
    assert rc == 0, err
    assert result["correct"] is False, (plant, result["checks"])


@pytest.mark.parametrize("plant", ["altered_patch", "half_patches"])
def test_a_broken_stitch_is_not_correct(tiny, plant):
    rc, result, err = drive(tiny, "resunet-predict-600", seconds=0.1, plant=plant)
    assert rc == 0, err
    assert result["correct"] is False, (plant, result["checks"])


@pytest.mark.parametrize("workload", ["resunet-train-b3", "resnet-train-b3",
                                      "resunet-predict-600"])
def test_the_control_is_not_correct(tiny, workload):
    fields, traffic = control.load_cell(tiny, workload)
    h = Run(tiny, workload, fields, traffic, 3000000013, 0.0, False, torch.device("cpu"), 0.0)
    read = control.train_readings if traffic["generator"] == "train" else control.predict_readings
    readings = read(h)
    limits = TINY_LIMITS[traffic["generator"]]
    for name, numbers in readings.items():
        correct, checks = check.judge(numbers, limits)
        assert not correct, (name, checks)


@pytest.mark.gpu
def test_every_cell_is_correct_on_the_card():
    """On a card: each cell of BENCHMARK.json at its own size, a short window."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import json
    import subprocess
    import sys

    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        cells = [w["name"] for w in json.load(f)["workloads"]]
    for i, name in enumerate(cells):
        proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", name,
                               "--seed", str(3100000000 + i), "--seconds", "5", "--trace", "0"],
                              cwd=REPO, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert '"correct": true' in proc.stdout.strip().splitlines()[-1], proc.stderr[-2000:]
