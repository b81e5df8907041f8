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
        "import vangan_torch.device, vangan_torch.checkpoint, vangan_torch.data.pipeline\n"
        "import vangan_torch.data.preprocess, vangan_torch.training.loop, vangan_torch.monitor\n"
        "import vangan_torch.monitor.tb, vangan_torch.monitor.gan_monitor\n"
        "import vangan_torch.monitor.profiling, vangan_torch.monitor.panels\n"
        "import vangan_torch.inference.mapping, vangan_torch.metrics, vangan_torch.utils\n"
        "import vangan_torch.ops.norms_np\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'vangan_tpu', 'imageio'))\n"
        "assert not bad, bad\n"
    )
    proc = _python("-c", code)
    assert proc.returncode == 0, proc.stderr


def test_preprocessing_modules_do_not_import_torch():
    """The preprocessing module, the ``rsom`` hook's module and the CLI
    import no torch, so each spawned preprocessing worker starts without it."""
    code = (
        "import sys\n"
        "import vangan_torch.data.preprocess, vangan_torch.utils, vangan_torch.ops.norms_np\n"
        "import vangan_torch.cli, vangan_torch.__main__\n"
        "assert 'torch' not in sys.modules, sorted(m for m in sys.modules if 'torch' in m)\n"
    )
    proc = _python("-c", code)
    assert proc.returncode == 0, proc.stderr


def test_preprocess_and_raw_tiff_predict_run_without_jax_or_imageio(tmp_path):
    """``preprocess`` and ``predict`` on raw TIFFs, in an interpreter where
    importing JAX, flax, imageio or the JAX package fails."""
    code = f"""
import importlib.abc, os, sys
import numpy as np
from PIL import Image

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "vangan_tpu",
                                  "imageio", "tifffile"):
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Block())
from vangan_torch import cli
from vangan_torch.config import VanGanConfig
from vangan_torch.vangan import VanGan

root = {str(tmp_path)!r}
rng = np.random.default_rng(0)
for sub, n in (("rawA", 3), ("rawB", 3)):
    os.makedirs(os.path.join(root, sub))
    for i in range(n):
        vol = (rng.integers(0, 4096, (16, 24, 24)) if sub == "rawA" else
               (rng.uniform(size=(16, 24, 24)) > 0.8) * 255).astype(np.uint16)
        pages = [Image.fromarray(p) for p in vol]
        pages[0].save(os.path.join(root, sub, f"v{{i}}.tiff"), save_all=True,
                      append_images=pages[1:])
cfg = VanGanConfig(RAW_IMG_SIZE=(24, 24, 16, 1), TARG_RAW_IMG_SIZE=(20, 20, 16, 1),
                   SYNTH_IMG_SIZE=(24, 24, 16), TARG_SYNTH_IMG_SIZE=(20, 20, 16),
                   SUBVOL_PATCH_SIZE=(16, 16, 16), gen_filters=2, disc_filters=2,
                   compute_dtype="float32", stitcher_batch=4)
cfg.to_yaml(os.path.join(root, "cfg.yaml"))
VanGan(cfg, device="cpu").save_weights(os.path.join(root, "w.pt"))
cfg_path = os.path.join(root, "cfg.yaml")
cli.main(["preprocess", "--config", cfg_path, "--imaging-raw", os.path.join(root, "rawA"),
          "--seg-raw", os.path.join(root, "rawB"), "--data-dir", os.path.join(root, "data"),
          "--resize", "--preprocess", "rsom"])
cli.main(["predict", "--config", cfg_path, "--input", os.path.join(root, "rawA"),
          "--output", os.path.join(root, "pred"), "--weights", os.path.join(root, "w.pt"),
          "--stride", "8", "8", "8", "--resize", "--preprocess", "rsom", "--device", "cpu"])
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "imageio",
                                                           "vangan_tpu"))
assert not bad, bad
"""
    proc = _python("-c", code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert sorted(os.listdir(tmp_path / "data")) == [
        "dataA_partition.pkl", "dataB_partition.pkl", "testA", "testB", "trainA", "trainB",
        "valA", "valB"]
    assert sorted(os.listdir(tmp_path / "pred")) == [
        "VANGAN_v0.tiff", "VANGAN_v1.tiff", "VANGAN_v2.tiff", "preprocessed_npy"]


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


@pytest.mark.parametrize("cmd", [["train", "--data-dir", "DATA"], ["sweep", "--input", "DATA"]])
def test_train_and_sweep_without_cuda_exit_nonzero(no_cuda, tmp_path, cmd):
    args = [a.replace("DATA", str(tmp_path)) for a in cmd]
    proc = _python("-m", "vangan_torch", *args, "--output-dir", str(tmp_path / "out"))
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
    from vangan_torch.checkpoint import load_exported
    from vangan_torch.data.pipeline import VanGanDataset

    from vangan_torch.metrics import cldice_metric, evaluate_segmentation

    for fn in (VanGanDataset, load_exported, cldice_metric, evaluate_segmentation):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    truth = np.zeros((8, 8, 8), np.float32)
    truth[2:6] = 1.0
    with pytest.raises(RuntimeError, match='device="cpu"'):
        evaluate_segmentation(truth, truth, iters=2)


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
