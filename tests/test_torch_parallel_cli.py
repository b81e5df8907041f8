"""``python -m vangan_torch train`` with ``N_DEVICES: 2`` on the CPU: two gloo
ranks from one command.

One tiny epoch (generators f=4, discriminators f=8, 16^3 patches, 2 train
steps and 1 validation step of a global batch of 2) on the tiny partitions of
``test_torch_fit``, in a fresh interpreter (one intra-op thread, as the ranks
inherit it) joined within ``TIMEOUT_S`` seconds: rank 0 alone writes the
checkpoint, the event files and the panels, and a resume loads the
checkpoint on both ranks and continues its counts.
"""

import os
import signal
import subprocess
import sys

import torch
from test_torch_checkpoint import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_fit import _partitions

from vangan_torch.config import VanGanConfig
from vangan_torch.training.state import NETWORKS

TIMEOUT_S = 300
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(root, epochs):
    path = str(root / f"cfg{epochs}.yaml")
    VanGanConfig(N_DEVICES=2, BATCH_SIZE=1, EPOCHS=epochs, SUBVOL_PATCH_SIZE=(16, 16, 16),
                 gen_filters=4, disc_filters=8, cldice_iters=2, train_steps=2, val_steps=1,
                 PERIOD_2D_CALLBACK=2, compute_dtype="float32", stitcher_batch=4,
                 output_dir=str(root / "out")).to_yaml(path)
    return path


def _train(*argv):
    """Run the CLI in a new session; kill every process of it past the limit."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, "-m", "vangan_torch", "train", *argv],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"train with two ranks did not finish in {TIMEOUT_S} s")
    assert proc.returncode == 0, out
    return out


def test_train_cli_two_ranks_rank0_writes_and_both_resume(tmp_path):
    _partitions(tmp_path)
    data, out = str(tmp_path / "data"), tmp_path / "out"
    log = _train("--config", _cfg(tmp_path, 1), "--data-dir", data, "--device", "cpu")
    assert "train: 2 ranks on cpu" in log
    assert log.count("Saving checkpoint to") == 1  # rank 0 alone
    assert log.count("Epoch 001/001") == 1
    assert os.listdir(out / "checkpoints") == ["torch_e1.pt"]
    ck = torch.load(out / "checkpoints" / "torch_e1.pt", weights_only=True)
    assert ck["train_state"]["step"] == 2
    assert ck["train_state"]["counts"] == {n: 2 for n in NETWORKS}
    for split in ("train", "validate"):
        assert len(os.listdir(out / "TB_Logs" / split)) == 1
    assert (out / "GANMonitor" / "1_genIS.png").is_file()
    assert (out / "Args_Settings.txt").is_file()

    log = _train("--config", _cfg(tmp_path, 2), "--data-dir", data, "--device", "cpu",
                 "--resume-epoch", "1")
    assert log.count("Loaded checkpoint from") == 2  # both ranks
    ck2 = torch.load(out / "checkpoints" / "torch_e2.pt", weights_only=True)
    assert ck2["train_state"]["step"] == 4
    assert ck2["train_state"]["counts"] == {n: 4 for n in NETWORKS}
    for n in NETWORKS:
        assert any(not torch.equal(ck[n][k], ck2[n][k]) for k in ck[n]), n
        assert all(bool(torch.isfinite(v).all()) for v in ck2[n].values()), n
