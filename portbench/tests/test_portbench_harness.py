"""The harness finds configurations, mixes and metrics by name, and refuses
to run where it must."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import REPO, TINY_TRAIN, drive, make_tiny

from portbench import run


def test_a_mix_added_as_a_file_runs_without_editing_any_file(tmp_path):
    """A new mix and a new cell are a traffic file, a limits file and an
    entry: the harness finds the configuration, the mix, its generator and the
    cell's metrics by their names."""
    mix = dict(TINY_TRAIN, batch=2, noise_std=0.0, pool=5)
    cell = {"name": "resunet-train-b2-quiet", "config": "vangan_resunet",
            "traffic": "throwaway", "chips": 1, "why": "a mix added as a file"}
    root = make_tiny(str(tmp_path), {"throwaway": mix}, [cell])
    rc, result, err = drive(root, cell["name"])
    assert rc == 0, err
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"train_patches_per_s", "train_step_p90_ms", "setup_s"}
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == {"loss", "loss1", "grad1_median", "grad_net", "change_median"}
    assert set(result["readings"]) == {"grad1", "grad1_net_median", "change"}


def test_the_predict_cell_runs_and_reports_its_metric(tiny):
    rc, result, err = drive(tiny, "resunet-predict-600", seconds=0.1)
    assert rc == 0, err
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"predict_mvox_per_s", "setup_s"}
    assert set(result["checks"]) == {"max_gap", "rms_gap"}
    assert err.strip().splitlines()[-1].startswith("check rms_gap:")
    phases = result["window"]["setup_phases_s"]
    assert list(phases) == ["start", "program imports", "weights", "networks", "VanGan",
                            "volumes", "warm-up", "window start"]
    assert sum(phases.values()) == pytest.approx(result["metrics"]["setup_s"]["value"])


def test_metric_readers_are_found_by_name_and_read_only_their_kind(tmp_path):
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for m in bench["per_layer"]:
        reader = run.load_file(os.path.join(REPO, "portbench", "metrics", m["name"] + ".py"),
                               "reader_" + m["name"].replace(".", "_"))
        assert reader.read(None) is None
        other = "predict" if m["name"].endswith(".train") else "train"
        assert reader.read({"kind": other}) is None


def _bare_run(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300, env=env)


def test_without_cuda_the_run_fails_and_prints_no_result():
    proc = _bare_run(REPO, "--workload", "resunet-train-b3", "--seed", "5", "--seconds", "1",
                     "--trace", "0")
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_with_only_the_benchmark_files_the_run_fails_and_prints_no_result(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _bare_run(tmp_path, "--workload", "resunet-train-b3", "--seed", "5", "--seconds",
                     "1", "--trace", "0")
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("jaxtyping", "vangan_tpu_extra", "flaxen.x"):
        monkeypatch.setitem(sys.modules, name, object())
    assert run.forbidden_modules() == []
    for name in ("jax", "jax.numpy", "vangan_tpu.ops", "flax"):
        monkeypatch.setitem(sys.modules, name, object())
    assert run.forbidden_modules() == ["flax", "jax", "jax.numpy", "vangan_tpu.ops"]


def test_a_run_of_the_harness_loads_no_jax(tiny):
    code = ("import sys, io\n"
            f"sys.path.insert(0, {REPO!r})\n"
            "from portbench import run\n"
            f"rc = run.main(['--workload', 'resunet-predict-600', '--seed', '9', '--seconds', "
            f"'0.1', '--trace', '0'], root={tiny!r}, device='cpu', out=io.StringIO())\n"
            "assert rc == 0, rc\n"
            "assert not run.forbidden_modules(), run.forbidden_modules()\n"
            "assert 'vangan_torch' in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr
