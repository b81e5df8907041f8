"""The predict slice as a whole: the port's stitcher, CLI and checkpoint
converter against the JAX package.

The JAX side is ``vangan_tpu.inference.stitcher.stitch_subvolumes`` on its
host path (``device_apply=None``) driven by a flax ResUNet3D; the port's
``stitch_subvolumes`` runs the torch ResUNet3D with the same weights (mapped by
``flax_to_torch``) on the CPU. float32 throughout; tolerance atol 1e-2 on the
0-255 output (generator outputs agree to ~1e-5, and 255 * min-max scales
them by up to ~150).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from vangan_tpu.inference import stitcher as jax_stitcher
from vangan_tpu.models.resunet import ResUNet3D as FlaxResUNet3D
from vangan_torch import cli
from vangan_torch.config import VanGanConfig
from vangan_torch.data.preprocess import read_tiff
from vangan_torch.inference import stitcher
from vangan_torch.models.resunet import ResUNet3D
from vangan_torch.ops.norms_np import min_max_norm_np
from vangan_torch.vangan import VanGan
from vangan_torch.weights import load_flax_params, torch_to_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def generators():
    """A flax ResU-Net (f=4, 2 levels) as a jitted numpy callable, and the
    port's copy of it as a torch callable."""
    fm = FlaxResUNet3D(upsample_mode="simple", dropout_type="none", filters=4,
                       num_layers=2, layout="NXCYZ", dtype=jnp.float32)
    params = fm.init(jax.random.PRNGKey(7), jnp.zeros((1, 16, 16, 16, 1)))["params"]
    fwd = jax.jit(lambda x: fm.apply({"params": params}, x))
    tm = load_flax_params(ResUNet3D(filters=4, num_layers=2, upsample_mode="simple"), params).eval()

    def torch_gen(x):
        with torch.inference_mode():
            return tm(x)

    return (lambda x: np.asarray(fwd(jnp.asarray(x)))), torch_gen


@pytest.mark.parametrize("L,k,s", [(64, 16, 8), (64, 16, 25), (100, 30, 7), (30, 30, 10),
                                   (55, 16, 16), (36, 16, 10)])
def test_origins_match_jax(L, k, s):
    shape, sub, stride = (L, L + 3, L + 5), (k, k, k), (s, s + 1, s)
    assert stitcher.stitch_origins(shape, sub, stride) == \
        jax_stitcher.stitch_origins(shape, sub, stride)


def test_gaussian_window_matches_jax():
    np.testing.assert_array_equal(stitcher.gaussian_window((16, 12, 8)),
                                  jax_stitcher._gaussian_window((16, 12, 8)))


@pytest.mark.parametrize("pads", [(0, 0, 0), (2, 3, 1), (5, 6, 4), (7, 9, 11), (3, 0, 8)],
                         ids=["none", "under", "equal", "beyond", "mixed"])
@pytest.mark.parametrize("two_d", [False, True], ids=["3d", "2d"])
def test_symmetric_pad_matches_numpy(rng, pads, two_d):
    """Widths 0, under, equal to and beyond each axis of a (5, 6, 4, 2)
    volume; the 2-D mode's (H, W, 1, C) image leaves z unpadded."""
    shape = (5, 6, 1, 2) if two_d else (5, 6, 4, 2)
    if two_d:
        pads = (*pads[:2], 0)
    vol = rng.normal(size=shape).astype(np.float32)
    want = np.pad(vol, [(p, p) for p in pads] + [(0, 0)], "symmetric")
    got = stitcher.symmetric_pad(torch.from_numpy(vol), pads).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_min_max_255_matches_numpy(rng):
    pred = (rng.normal(size=(23, 19, 17, 1)) * 40 + 7).astype(np.float32)
    want = 255 * min_max_norm_np(pred)
    got = stitcher.min_max_255_(torch.from_numpy(pred.copy())).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_a_constant_prediction_raises():
    vol = np.random.default_rng(3).uniform(size=(12, 12, 12, 1)).astype(np.float32)
    with pytest.raises(ValueError, match="max and min are equal"):
        stitcher.stitch_subvolumes(lambda p: torch.zeros_like(p), vol, (2, 8, 8, 8, 1),
                                   stride=(4, 4, 4), complete=True, save=False, device="cpu")


def test_a_reversed_view_stitches_as_its_copy():
    """A view with a negative stride (which ``torch.from_numpy`` refuses) is
    uploaded as its contiguous copy."""
    vol = np.random.default_rng(4).uniform(size=(12, 12, 12, 1)).astype(np.float32)[::-1]
    kw = dict(subvol_size=(2, 8, 8, 8, 1), stride=(4, 4, 4), complete=True, save=False,
              device="cpu")
    # exactly rounded ops: a transcendental's vector and scalar paths may differ by an ulp
    gen = lambda p: p * p - 0.5  # noqa: E731
    np.testing.assert_array_equal(stitcher.stitch_subvolumes(gen, vol, **kw),
                                  stitcher.stitch_subvolumes(gen, vol.copy(), **kw))


@pytest.mark.parametrize("blend", ["uniform", "gaussian"])
@pytest.mark.parametrize("process_img", [False, True])
def test_stitch_matches_jax(rng, generators, blend, process_img):
    """24^3 volume, 16^3 patches, padFactor 0.25 (36^3 padded), stride 10:
    the walk repeats its last origin per axis (64 origins, 27 unique), and
    batch 5 leaves a padded last batch."""
    jax_gen, torch_gen = generators
    img = (rng.normal(size=(24, 24, 24, 1)) * 30 + 100).astype(np.float32)
    kw = dict(subvol_size=(1, 16, 16, 16, 1), stride=(10, 10, 10), complete=True,
              padFactor=0.25, save=False, batch_size=5, blend=blend, process_img=process_img)
    want = jax_stitcher.stitch_subvolumes(jax_gen, img, **kw)
    got = stitcher.stitch_subvolumes(torch_gen, img, device="cpu", **kw)
    assert got.shape == want.shape == img.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=0)


def test_incomplete_stitch_is_uint8_and_matches_jax(rng, generators, tmp_path):
    jax_gen, torch_gen = generators
    img = rng.normal(size=(24, 20, 16, 1)).astype(np.float32)
    kw = dict(subvol_size=(1, 16, 16, 16, 1), stride=(8, 4, 16), complete=False,
              batch_size=8, name="t", epoch=2)
    want = jax_stitcher.stitch_subvolumes(jax_gen, img, save=False, **kw)
    got = stitcher.stitch_subvolumes(torch_gen, img, model_path=str(tmp_path), device="cpu",
                                     **kw)
    assert got.dtype == np.uint8 and got.shape == img.shape
    # uint8 truncation of values within 1e-2 can differ by one grey level
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    tiff = read_tiff(str(tmp_path / "e3_t.tiff"))  # (z, x, y, c), the reference layout
    np.testing.assert_array_equal(tiff, np.transpose(got, (2, 0, 1, 3)).astype(np.float32))


def _tiny_cfg(tmp_path):
    cfg = VanGanConfig(output_dir=str(tmp_path / "run"), SUBVOL_PATCH_SIZE=(16, 16, 16),
                       gen_filters=2, disc_filters=4, compute_dtype="float32", stitcher_batch=4,
                       seed=3)
    cfg.to_yaml(str(tmp_path / "cfg.yaml"))
    return cfg


@pytest.mark.parametrize("fake_imaging", [False, True])
def test_cli_predict_cpu_writes_reference_layout(rng, tmp_path, fake_imaging):
    cfg = _tiny_cfg(tmp_path)
    os.makedirs(tmp_path / "in")
    vol = (rng.normal(size=(20, 18, 17, 1)) * 10 + 50).astype(np.float32)
    np.save(tmp_path / "in" / "v.npy", vol)
    weights = str(tmp_path / "w.pt")
    VanGan(cfg, device="cpu").save_weights(weights)
    cli.main(["predict", "--config", str(tmp_path / "cfg.yaml"), "--input",
              str(tmp_path / "in"), "--output", str(tmp_path / "out"), "--weights", weights,
              "--stride", "8", "8", "8", "--device", "cpu",
              *(["--fake-imaging"] if fake_imaging else [])])
    import imageio.v3 as iio

    tiff = np.asarray(iio.imread(tmp_path / "out" / "VANGAN_v.tiff"))
    assert tiff.shape[:3] == (17, 20, 18)  # (z, x, y), as the JAX CLI writes it
    ours = read_tiff(str(tmp_path / "out" / "VANGAN_v.tiff"))
    assert ours.shape == (17, 20, 18, 1)
    assert np.isfinite(ours).all() and ours.min() == 0.0 and ours.max() == 255.0

    gan = VanGan(cfg, device="cpu")
    gan.load_weights(weights)
    direct = stitcher.stitch_subvolumes(
        gan.gen_SI_batched if fake_imaging else gan.gen_IS_batched, vol, cfg.subvol_size,
        stride=(8, 8, 8), complete=True, save=False, process_img=fake_imaging, batch_size=4,
        device="cpu")
    np.testing.assert_array_equal(ours, np.transpose(direct, (2, 0, 1, 3)))


def test_cli_refuses_raw_tiff_and_reports_missing_epoch(tmp_path, capsys):
    """A raw input file that is not a TIFF is refused by the reader before
    anything is segmented (valid raw TIFFs are preprocessed:
    ``test_torch_cli_preprocess.py``), and a missing epoch is reported."""
    cfg = _tiny_cfg(tmp_path)
    os.makedirs(tmp_path / "raw")
    (tmp_path / "raw" / "a.tiff").write_bytes(b"")
    with pytest.raises(OSError, match="cannot identify image file"):
        cli.main(["predict", "--config", str(tmp_path / "cfg.yaml"), "--input",
                  str(tmp_path / "raw"), "--output", str(tmp_path / "o"), "--device", "cpu"])
    assert os.listdir(tmp_path / "o") == ["preprocessed_npy"]
    assert not os.listdir(tmp_path / "o" / "preprocessed_npy")
    os.makedirs(tmp_path / "empty")
    cli.main(["predict", "--config", str(tmp_path / "cfg.yaml"), "--input",
              str(tmp_path / "empty"), "--output", str(tmp_path / "o"), "--epoch", "9",
              "--device", "cpu"])
    out = capsys.readouterr().out
    assert VanGan(cfg, device="cpu").weights_path(9) in out and "Checkpoint not found" in out


def test_checkpoint_converter_serves_jax_generators(rng, tmp_path):
    """scripts/flax_ckpt_to_torch.py reads the four networks out of an orbax
    checkpoint with the VanGanState layout (params/gen_IS, ..., params/disc_S)
    and the port then computes what flax computes."""
    cfg = _tiny_cfg(tmp_path)
    from vangan_tpu.config import VanGanConfig as JaxConfig
    from vangan_tpu.models.factory import build_discriminator as jax_build_disc
    from vangan_tpu.models.factory import build_generator as jax_build

    jcfg = JaxConfig(gen_filters=2, disc_filters=4, compute_dtype="float32", layout="NXCYZ")
    x = rng.uniform(-1, 1, size=(2, 16, 16, 16, 1)).astype(np.float32)
    models, params = {}, {}
    for i, name in enumerate(("gen_IS", "gen_SI", "disc_I", "disc_S")):
        if name.startswith("gen"):
            models[name] = jax_build("resUnet", jcfg, role="i2s" if name == "gen_IS" else "s2i")
        else:
            models[name] = jax_build_disc(jcfg)
        params[name] = models[name].init(jax.random.PRNGKey(i), jnp.asarray(x))["params"]
    ckpt = os.path.join(cfg.output_dir, "checkpoints", "checkpoint_e4")
    ocp.StandardCheckpointer().save(ckpt, {"params": params, "step": np.int32(0)})
    ocp.StandardCheckpointer().wait_until_finished()

    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "flax_ckpt_to_torch.py"),
         "--config", str(tmp_path / "cfg.yaml"), "--epoch", "4"],
        capture_output=True, text=True, timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr
    gan = VanGan(cfg, device="cpu")
    gan.load_weights(gan.weights_path(4))
    for name in ("gen_IS", "gen_SI"):
        want = np.asarray(models[name].apply({"params": params[name]}, jnp.asarray(x)))
        got = getattr(gan, f"{name}_batched")(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    for name in ("gen_IS", "gen_SI", "disc_I", "disc_S"):
        if name.startswith("disc"):
            want = np.asarray(models[name].apply({"params": params[name]}, jnp.asarray(x)))
            with torch.inference_mode():
                got = gan.nets[name](torch.from_numpy(x)).numpy()
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        back = torch_to_flax(gan.nets[name].state_dict(), gan.nets[name])
        for (_, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(params[name]),
                                  jax.tree_util.tree_leaves_with_path(back)):
            np.testing.assert_array_equal(np.asarray(a), b)
