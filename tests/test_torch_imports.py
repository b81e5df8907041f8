"""The port runs without JAX, and refuses to run its CUDA path without CUDA.

Each check runs in a fresh interpreter, so modules this test process already
imported (JAX among them) do not count.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(*args, cwd=REPO, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True, text=True,
                          timeout=timeout, env=env)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import vangan_torch, vangan_torch.cli, vangan_torch.vangan, vangan_torch.weights\n"
        "import vangan_torch.inference, vangan_torch.models, vangan_torch.ops.build\n"
        "import vangan_torch.ops.conv3d, vangan_torch.ops.instnorm, vangan_torch.ops.skeleton\n"
        "import vangan_torch.ops.ssim, vangan_torch.ops.norms, vangan_torch.losses\n"
        "import vangan_torch.models.discriminator, vangan_torch.training.step\n"
        "import vangan_torch.training.optimizers, vangan_torch.training.state\n"
        "import vangan_torch.device\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'vangan_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = _python("-c", code)
    assert proc.returncode == 0, proc.stderr


@pytest.fixture
def no_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")


def test_predict_without_cuda_exits_nonzero(no_cuda, tmp_path):
    proc = _python("-m", "vangan_torch", "predict", "--input", str(tmp_path),
                   "--output", str(tmp_path / "out"))
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr and "--device cpu" in proc.stderr
    assert not (tmp_path / "out").exists()


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    """VanGan and stitch_subvolumes run on the card unless asked for the CPU;
    without CUDA they raise, naming device="cpu", and do not fall back."""
    import inspect

    import numpy as np

    from vangan_torch.config import VanGanConfig
    from vangan_torch.inference.stitcher import stitch_subvolumes
    from vangan_torch.vangan import VanGan

    assert inspect.signature(VanGan).parameters["device"].default == "cuda"
    assert inspect.signature(stitch_subvolumes).parameters["device"].default == "cuda"
    cfg = VanGanConfig(gen_filters=2, disc_filters=2)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        VanGan(cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        stitch_subvolumes(lambda x: x, np.zeros((16, 16, 16, 1), np.float32),
                          (1, 16, 16, 16, 1), stride=(16, 16, 16), save=False)
    assert VanGan(cfg, device="cpu").device.type == "cpu"


def test_chip_smoke_without_cuda_exits_nonzero_with_no_result(no_cuda):
    proc = _python("chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    proc = _python("chip_smoke.py", cwd=str(tmp_path))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
