"""The port's ``preprocess`` subcommand, ``predict`` on raw TIFFs and the
synthetic example, against the JAX package's CLI.

``preprocess`` (through ``cli.main``) and ``vangan_tpu.cli.cmd_preprocess``
run on the same raw directories (uint16 imaging TIFFs, uint8 segmentation
TIFFs of 24 x 24 x 16 voxels) and the same YAML config: the .npy volumes
must be bit-identical and the partitions equal (paths relative to their
roots). ``predict --device cpu`` on raw TIFFs runs the port's plain path with
the JAX generator's weights (carried by ``weights.py``) against JAX's
``cmd_predict`` (host stitcher, float32): the preprocessed volumes
bit-identical, the stitched TIFFs within the stitcher's atol 1e-2 on 0-255
(``tests/test_torch_stitcher.py``).
"""

import json
import os
import pickle
import subprocess
import sys

import imageio.v3 as iio
import jax
import numpy as np
import pytest

from vangan_tpu import cli as jax_cli
from vangan_tpu.config import VanGanConfig as JaxConfig
from vangan_torch import cli
from vangan_torch.data.preprocess import read_tiff
from vangan_torch.utils import preprocess_rsom_images

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestResolvePreprocessFn:
    """The cases of ``tests/test_cli.py`` for the JAX CLI."""

    def test_none(self):
        assert cli._resolve_preprocess_fn(None) is None

    def test_rsom_builtin(self):
        assert cli._resolve_preprocess_fn("rsom") is preprocess_rsom_images

    @pytest.mark.parametrize("spec", ["vangan_torch.utils:preprocess_rsom_images",
                                      "vangan_torch.utils.preprocess_rsom_images"])
    def test_dotted_paths(self, spec):
        assert cli._resolve_preprocess_fn(spec) is preprocess_rsom_images

    @pytest.mark.parametrize("spec", ["nosuchmodule:fn", "vangan_torch.utils:nosuchfn",
                                      "garbage", "vangan_torch.utils:np"])
    def test_bad_specs(self, spec):
        with pytest.raises(SystemExit):
            cli._resolve_preprocess_fn(spec)


def _write(dirpath, n, imaging, seed):
    os.makedirs(dirpath, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        if imaging:
            vol = rng.integers(0, 4096, size=(16, 24, 24)).astype(np.uint16)
        else:
            vol = ((rng.uniform(size=(16, 24, 24)) > 0.8) * 255).astype(np.uint8)
        iio.imwrite(os.path.join(dirpath, f"v{i}.tiff"), vol)
    return str(dirpath)


def _config(tmp_path, **kw):
    """A JAX config (the port reads the fields it knows from the same YAML)."""
    cfg = JaxConfig(RAW_IMG_SIZE=(24, 24, 16, 1), TARG_RAW_IMG_SIZE=(20, 28, 18, 1),
                    SYNTH_IMG_SIZE=(24, 24, 16), TARG_SYNTH_IMG_SIZE=(20, 28, 18), seed=3,
                    output_dir=str(tmp_path / "run"), **kw)
    path = str(tmp_path / "cfg.yaml")
    cfg.to_yaml(path)
    return cfg, path


def _npys(root):
    return {os.path.relpath(os.path.join(d, f), root): np.load(os.path.join(d, f))
            for d, _, files in os.walk(root) for f in files if f.endswith(".npy")}


def _partitions(root):
    out = {}
    for pid in "AB":
        with open(os.path.join(root, f"data{pid}_partition.pkl"), "rb") as f:
            out[pid] = {k: [os.path.relpath(str(p), root) for p in v]
                        for k, v in pickle.load(f).items()}
    return out


@pytest.mark.parametrize("extra", [[], ["--resize"], ["--resize", "--preprocess", "rsom"]])
def test_preprocess_cli_matches_jax(tmp_path, extra):
    _, cfg_path = _config(tmp_path)
    raw_i = _write(tmp_path / "rawA", 3, True, 0)
    raw_s = _write(tmp_path / "rawB", 3, False, 1)
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        main(["preprocess", "--config", cfg_path, "--imaging-raw", raw_i, "--seg-raw", raw_s,
              "--data-dir", str(tmp_path / name), *extra])
    got, want = _npys(tmp_path / "port"), _npys(tmp_path / "jax")
    assert sorted(got) == sorted(want) and len(want) == 6
    for key, w in want.items():
        assert got[key].dtype == w.dtype and np.array_equal(got[key], w), key
    shape = (20, 28, 18) if extra else (24, 24, 16)
    for key, v in got.items():
        assert v.shape == (*shape, 1)
        if "B" in os.path.dirname(key):
            assert set(np.unique(v)) == {-1.0, 1.0}
    parts = _partitions(tmp_path / "port")
    assert parts == _partitions(tmp_path / "jax")
    assert {k: len(v) for k, v in parts["A"].items()} == \
        {"training": 1, "validation": 1, "testing": 1}


def test_predict_raw_tiffs_matches_jax(tmp_path):
    """``--resize --preprocess rsom``: the raw TIFFs are preprocessed into
    ``<output>/preprocessed_npy`` and segmented with the same weights."""
    from vangan_torch.config import VanGanConfig
    from vangan_torch.vangan import VanGan
    from vangan_torch.weights import load_flax_networks

    kw = dict(SUBVOL_PATCH_SIZE=(16, 16, 16), gen_filters=2, disc_filters=4,
              compute_dtype="float32", stitcher_batch=4, stitcher_device=False)
    jcfg, cfg_path = _config(tmp_path, **kw)
    raw = _write(tmp_path / "raw", 2, True, 5)
    from vangan_tpu.vangan import VanGan as JaxVanGan

    jgan = JaxVanGan(jcfg, steps_per_epoch=1)  # what cmd_predict builds: the init of cfg.seed
    gan = VanGan(VanGanConfig.from_yaml(cfg_path), device="cpu")
    load_flax_networks(gan, jax.device_get(jgan.state.params),
                       jax.device_get(jgan.state.model_state))
    weights = str(tmp_path / "w.pt")
    gan.save_weights(weights)
    del jgan, gan
    args = ["--config", cfg_path, "--input", raw, "--stride", "8", "8", "8", "--resize",
            "--preprocess", "rsom"]
    jax_cli.main(["predict", *args, "--output", str(tmp_path / "jax")])
    cli.main(["predict", *args, "--output", str(tmp_path / "port"), "--weights", weights,
              "--device", "cpu"])
    got = _npys(tmp_path / "port" / "preprocessed_npy")
    want = _npys(tmp_path / "jax" / "preprocessed_npy")
    assert sorted(got) == sorted(want) == ["v0.npy", "v1.npy"]
    for key, w in want.items():
        assert got[key].shape == (20, 28, 18, 1) and np.array_equal(got[key], w), key
    for name in ("VANGAN_v0.tiff", "VANGAN_v1.tiff"):
        ours = read_tiff(str(tmp_path / "port" / name))[..., 0]
        theirs = read_tiff(str(tmp_path / "jax" / name))[..., 0]
        assert ours.shape == theirs.shape == (18, 20, 28)  # (z, x, y)
        assert np.isfinite(ours).all() and ours.min() >= 0.0 and ours.max() <= 255.0
        np.testing.assert_allclose(ours, theirs, atol=1e-2, rtol=0)


def test_synthetic_example_runs_on_the_cpu(tmp_path):
    """``examples/train_synthetic_torch.py``: one epoch of two steps on four
    32^3 volumes, 16^3 patches, filters 4/8, clDice with 2 iterations; its
    last line holds finite Dice and clDice. With no ``--out`` it writes into
    a new directory under ``$TMPDIR``, and names the checkpoint it saved."""
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "train_synthetic_torch.py"),
         "--epochs", "1", "--patch", "16", "--volumes", "4", "--vol-shape", "32", "32", "32",
         "--filters", "4", "--disc-filters", "8", "--cldice-iters", "2",
         "--steps-per-epoch", "2", "--device", "cpu"],
        capture_output=True, text=True, timeout=600, env={**os.environ, "TMPDIR": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    for key in ("dice", "cldice"):
        assert np.isfinite(summary[key]) and 0.0 <= summary[key] <= 1.0
    assert summary["train_steps"] == 2 and summary["device"] == "cpu"
    (run,) = [p for p in tmp_path.iterdir() if p.name.startswith("vg_synthetic_torch_")]
    assert os.path.exists(run / "predictions" / "VANGAN_v0.tiff")
    assert f"*** Final checkpoint: {run / 'checkpoints' / 'torch_e1.pt'} ***" in proc.stdout


def test_synthetic_example_refuses_2d(tmp_path):
    """``--dims 2`` was refused before the 2-D mode was ported; now it runs
    the example on 2-D tube images (one epoch on the CPU) and scores each
    one-page prediction."""
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "train_synthetic_torch.py"),
         "--dims", "2", "--epochs", "1", "--patch", "16", "--volumes", "4", "--vol-shape",
         "40", "36", "--filters", "4", "--disc-filters", "8", "--cldice-iters", "2",
         "--steps-per-epoch", "2", "--device", "cpu", "--out", str(tmp_path / "run")],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    for key in ("dice", "cldice"):
        assert np.isfinite(summary[key]) and 0.0 <= summary[key] <= 1.0
    assert summary["train_steps"] == 2
    assert read_tiff(str(tmp_path / "run" / "predictions" / "VANGAN_v0.tiff")).shape == \
        (1, 40, 36, 1)
    assert os.path.exists(tmp_path / "run" / "GANMonitor" / "dataset_sample_2d.png")
