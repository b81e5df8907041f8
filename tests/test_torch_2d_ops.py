"""The port's DIMENSIONS=2 mode against the JAX package's: config geometry,
2-D morphology, SSIM and clDice, the metrics, the feed, the stitcher, the
TIFF preprocessing, the sample panel and ``predict`` through the CLI.

Inputs are made with numpy from a seed; the JAX side runs on the CPU
through XLA, its own 2-D path (``tests/test_2d.py``), the port on its plain
torch versions (``device="cpu"``). Tolerances:

- soft erode, dilate and skeleton: rtol 1e-6 (min and max are exact; the
  skeleton's adds round alike);
- SSIM: rtol 2e-5, atol 2e-6 (``tests/test_2d.py``'s oracle tolerance);
- clDice loss: rtol 1e-6; its gradient: rtol 1e-5, atol 1e-6 * max |g|;
- Dice / clDice scores on binary images, the feed's crops and the
  preprocessed ``.npy`` files: exactly equal;
- the stitcher, uniform and Gaussian blend: atol 1e-3 on the 0-255 grid
  (an identity generator), atol 1e-2 through a flax / torch ResU-Net (its
  outputs agree to ~1e-5 and 255 * min-max scales them by up to ~150, as
  ``test_torch_stitcher.py``).
"""

import os

import imageio.v3 as iio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vangan_tpu import metrics as jax_metrics
from vangan_tpu.config import VanGanConfig as JaxConfig
from vangan_tpu.data import pipeline as jax_pipeline
from vangan_tpu.data import preprocess as jax_pre
from vangan_tpu.inference import stitcher as jax_stitcher
from vangan_tpu.losses.cldice import soft_dice_cldice_loss as jax_cldice_loss
from vangan_tpu.models.resunet import ResUNet3D as FlaxResUNet3D
from vangan_tpu.ops import morphology as jax_morph
from vangan_tpu.ops.ssim import ssim3d_loss_map as jax_ssim
from vangan_torch import cli, metrics
from vangan_torch.config import VanGanConfig
from vangan_torch.data import pipeline
from vangan_torch.data import preprocess as pre
from vangan_torch.data.preprocess import read_tiff
from vangan_torch.inference import stitcher
from vangan_torch.losses.cldice import soft_dice_cldice_loss
from vangan_torch.models.resunet import ResUNet3D
from vangan_torch.ops import morphology, skeleton
from vangan_torch.ops.ssim import ssim3d_loss_map
from vangan_torch.vangan import VanGan
from vangan_torch.weights import load_flax_params


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("patch", [(16, 16, 16), (24, 16, 8), (32, 48, 64)])
def test_config_geometry_matches_jax(dims, patch):
    """INPUT_IMG_SIZE, the patch shapes and the stitcher's subvol_size of
    both ranks: the first ``DIMENSIONS`` sizes of SUBVOL_PATCH_SIZE."""
    kw = dict(DIMENSIONS=dims, SUBVOL_PATCH_SIZE=patch, BATCH_SIZE=2, N_DEVICES=1)
    ours, theirs = VanGanConfig(**kw, stitcher_batch=5), JaxConfig(**kw)
    for name in ("INPUT_IMG_SIZE", "subvol_patch_shape", "seg_subvol_patch_shape"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert ours.subvol_size == (5, *patch[:dims], 1)
    if dims == 2:
        assert ours.INPUT_IMG_SIZE == (2, patch[0], patch[1], 1)


def _image(seed, shape=(2, 13, 11, 1), binary=False):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=shape).astype(np.float32)
    return (x > 0.6).astype(np.float32) if binary else x


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("op", ["soft_erode", "soft_dilate", "soft_open"])
def test_morphology_2d_matches_jax(op, binary):
    """The (3,1)/(1,3) erosion and 3x3 dilation on (B, H, W, C) images."""
    x = _image(0, binary=binary)
    got = getattr(morphology, op)(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jax_morph, op)(jnp.asarray(x)))
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_2d_erosion_is_not_the_depth1_volume_erosion():
    """The reason a 2-D skeleton does not run on the volume kernels: on a
    depth-1 volume the (3,3,1) window is the full 3x3 min."""
    x = torch.from_numpy(_image(1))
    image = morphology.soft_erode(x)
    volume = morphology.soft_erode(x[:, None])[:, 0]
    full = -torch.nn.functional.max_pool2d(-x.movedim(-1, 1), 3, 1, 1).movedim(1, -1)
    assert torch.equal(volume, full) and not torch.equal(image, volume)


@pytest.mark.parametrize("iters", [1, 3, 8])
@pytest.mark.parametrize("binary", [False, True])
def test_soft_skel_2d_matches_jax(iters, binary):
    x = _image(2, shape=(2, 24, 20, 1), binary=binary)
    got = morphology.soft_skel(torch.from_numpy(x), iters).numpy()
    want = np.asarray(jax_morph.soft_skel(jnp.asarray(x), iters))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_skeleton_kernel_wrapper_refuses_2d_images():
    """``ops.skeleton.soft_skel`` takes (B, X, Y, Z, C) volumes only, on the
    CPU as on the card: no silent route to the 2-D plain skeleton."""
    img = torch.from_numpy(_image(3))
    for x in (img, img[..., 0], img[None, None]):
        with pytest.raises(ValueError, match="soft_skel"):
            skeleton.soft_skel(x, 2)
    assert skeleton.soft_skel(img[:, None], 2).shape == (2, 1, 13, 11, 1)


@pytest.mark.parametrize("shape", [(1, 12, 12, 1), (2, 17, 9, 1), (3, 8, 20, 2)])
def test_ssim_2d_matches_jax(shape):
    """The blur runs over H and W only: a depth-1 axis would scale the map
    by the centre tap."""
    rng = np.random.default_rng(4)
    a, b = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    got = ssim3d_loss_map(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jax_ssim(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == shape
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
    depth1 = ssim3d_loss_map(torch.from_numpy(a[:, None]), torch.from_numpy(b[:, None]))
    assert not np.allclose(depth1[:, 0].numpy(), want, rtol=2e-5, atol=2e-6)


def test_cldice_loss_and_gradient_2d_match_jax():
    rng = np.random.default_rng(5)
    y_true = (rng.uniform(size=(2, 16, 16, 1)) > 0.7).astype(np.float32)
    y_pred = rng.uniform(size=(2, 16, 16, 1)).astype(np.float32)
    fn, jfn = soft_dice_cldice_loss(iters=3), jax_cldice_loss(iters=3)
    p = torch.from_numpy(y_pred).requires_grad_()
    loss = fn(torch.from_numpy(y_true), p)
    loss.backward()
    want, gwant = jax.value_and_grad(lambda q: jfn(jnp.asarray(y_true), q))(jnp.asarray(y_pred))
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-6)
    gwant = np.asarray(gwant)
    np.testing.assert_allclose(p.grad.numpy(), gwant, rtol=1e-5,
                               atol=1e-6 * np.abs(gwant).max())


@pytest.mark.parametrize("iters", [3, 15])
def test_dice_and_cldice_2d_equal_jax(iters):
    """Bare (H, W) images and batched (B, H, W, C) ones, on binary input."""
    rng = np.random.default_rng(6)
    truth = (rng.uniform(size=(40, 36)) > 0.8).astype(np.float32)
    pred = np.where(rng.uniform(size=truth.shape) > 0.9, 1 - truth, truth).astype(np.float32)
    got = metrics.evaluate_segmentation(pred * 255, truth * 2 - 1, iters=iters, device="cpu")
    assert got == jax_metrics.evaluate_segmentation(pred * 255, truth * 2 - 1, iters=iters)
    assert np.array_equal(metrics._skeletonize(pred, iters, "cpu"),
                          jax_metrics._skeletonize(pred, iters))
    batched = np.stack([truth, pred])[..., None]
    assert np.array_equal(metrics._skeletonize(batched, iters, "cpu"),
                          jax_metrics._skeletonize(batched, iters))


def _images(path, n, seg, seed, shape=(24, 22, 1)):
    path.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if seg:  # sparse foreground: the rejection sampler re-crops
            v = -np.ones(shape, np.float32)
            v[:3, :3] = 1.0
            v = np.where(rng.uniform(size=shape) > 0.995, 1.0, v).astype(np.float32)
        else:
            v = rng.normal(size=shape).astype(np.float32)
        np.save(path / f"v{i}.npy", v)
        out.append(str(path / f"v{i}.npy"))
    return out


@pytest.mark.parametrize("workers", [1, 2])
def test_feed_2d_crops_equal_jax(tmp_path, workers):
    """(h, w, c) crops of (H, W, C) images, flips in the (h, w) plane and the
    segmentation rejection rule: the same batches as ``vangan_tpu``'s."""
    img = _images(tmp_path / "img", 3, False, 1)
    seg = _images(tmp_path / "seg", 3, True, 2)
    parts = ({"training": img, "validation": img[:2]}, {"training": seg, "validation": seg[:2]})
    kw = dict(N_DEVICES=1, BATCH_SIZE=3, DIMENSIONS=2, SUBVOL_PATCH_SIZE=(8, 8, 8),
              DATA_WORKERS=workers)
    ours = pipeline.VanGanDataset(VanGanConfig(**kw), *parts, seed=3, device="cpu")
    theirs = jax_pipeline.VanGanDataset(JaxConfig(**kw), *parts, seed=3)
    try:
        for split in ("train", "val"):
            a, b = getattr(ours, f"{split}_batches")(2), getattr(theirs, f"{split}_batches")(2)
            for _ in range(4):
                (gi, gs), (wi, ws) = next(a), next(b)
                assert gi.shape == gs.shape == (3, 8, 8, 1)
                assert np.array_equal(gi.numpy(), np.asarray(wi))
                assert np.array_equal(gs.numpy(), np.asarray(ws))
                assert (gs.numpy().reshape(3, -1).max(axis=1) >= 0.8).all()
    finally:
        ours.close()
        theirs.close()


def test_sample_panel_2d(tmp_path):
    img = _images(tmp_path / "img", 2, False, 1)
    seg = _images(tmp_path / "seg", 2, True, 2)
    cfg = VanGanConfig(BATCH_SIZE=1, DIMENSIONS=2, SUBVOL_PATCH_SIZE=(8, 8, 8))
    ds = pipeline.VanGanDataset(cfg, {"training": img, "validation": img},
                                {"training": seg, "validation": seg}, seed=0, device="cpu")
    ds.plot_sample_dataset(str(tmp_path / "mon"))
    ds.close()
    assert os.listdir(tmp_path / "mon") == ["dataset_sample_2d.png"]


@pytest.fixture(scope="module")
def generators_2d():
    """A 2-D flax ResU-Net (f=4, 2 levels) as a jitted numpy callable, and
    the port's copy of it as a torch callable."""
    fm = FlaxResUNet3D(upsample_mode="simple", dropout_type="none", filters=4, num_layers=2,
                       layout="NXYZC", dtype=jnp.float32)
    params = fm.init(jax.random.PRNGKey(7), jnp.zeros((1, 16, 16, 1)))["params"]
    fwd = jax.jit(lambda x: fm.apply({"params": params}, x))
    tm = load_flax_params(ResUNet3D(filters=4, num_layers=2, upsample_mode="simple", dims=2),
                          params).eval()

    def torch_gen(x):
        with torch.inference_mode():
            return tm(x)

    return (lambda x: np.asarray(fwd(jnp.asarray(x)))), torch_gen


@pytest.mark.parametrize("blend", ["uniform", "gaussian"])
@pytest.mark.parametrize("process_img", [False, True])
def test_stitch_2d_matches_jax(rng, generators_2d, blend, process_img):
    """A 40 x 36 image, 16^2 patches, stride 8, padFactor 0.25, batch 5: the
    identity generator (atol 1e-3) and the ResU-Net (atol 1e-2)."""
    img = (rng.normal(size=(40, 36, 1)) * 30 + 100).astype(np.float32)
    kw = dict(subvol_size=(1, 16, 16, 1), stride=(8, 8), complete=True, padFactor=0.25,
              save=False, batch_size=5, blend=blend, process_img=process_img)
    want = jax_stitcher.stitch_subvolumes(lambda p: p, img, **kw)
    got = stitcher.stitch_subvolumes(lambda p: p, img, device="cpu", **kw)
    assert got.shape == want.shape == img.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    jax_gen, torch_gen = generators_2d
    want = jax_stitcher.stitch_subvolumes(jax_gen, img, **kw)
    got = stitcher.stitch_subvolumes(torch_gen, img, device="cpu", **kw)
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=0)


def test_incomplete_stitch_2d_writes_one_page(rng, generators_2d, tmp_path):
    jax_gen, torch_gen = generators_2d
    img = rng.normal(size=(24, 20, 1)).astype(np.float32)
    kw = dict(subvol_size=(1, 16, 16, 1), stride=(8, 4, 16), complete=False, batch_size=8,
              name="t", epoch=2)
    want = jax_stitcher.stitch_subvolumes(jax_gen, img, save=False, **kw)
    got = stitcher.stitch_subvolumes(torch_gen, img, model_path=str(tmp_path), device="cpu",
                                     **kw)
    assert got.dtype == np.uint8 and got.shape == img.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    tiff = read_tiff(str(tmp_path / "e3_t.tiff"))  # one page of h rows and w columns
    np.testing.assert_array_equal(tiff, got[None].astype(np.float32))


@pytest.mark.parametrize("domain", ["imaging", "segmentation"])
def test_preprocess_2d_npy_equal_jax(tmp_path, domain):
    """One-page TIFFs with DIMENSIONS=2: the same (H, W, 1) .npy files."""
    rng = np.random.default_rng(8)
    raw = tmp_path / "raw"
    raw.mkdir()
    for i in range(2):
        a = rng.normal(size=(20, 18)) * 40 + 100
        if domain == "segmentation":
            a = (rng.uniform(size=(20, 18)) > 0.8) * 255.0
        iio.imwrite(raw / f"v{i}.tiff", a.astype(np.float32))
    for mod, out in ((pre, tmp_path / "ours"), (jax_pre, tmp_path / "theirs")):
        out.mkdir()
        for i in range(2):
            mod._process_one((str(raw), f"v{i}.tiff", str(out), 2, domain, (20, 18, 1, 1),
                              (20, 18, 1, 1), False, None, False, None))
    for i in range(2):
        got, want = np.load(tmp_path / "ours" / f"v{i}.npy"), \
            np.load(tmp_path / "theirs" / f"v{i}.npy")
        assert got.shape == want.shape == (20, 18, 1) and np.array_equal(got, want)


def _cfg_2d(tmp_path, **kw):
    cfg = VanGanConfig(output_dir=str(tmp_path / "run"), DIMENSIONS=2,
                       SUBVOL_PATCH_SIZE=(16, 16, 16), gen_filters=2, disc_filters=4,
                       compute_dtype="float32", stitcher_batch=4, seed=3, **kw)
    cfg.to_yaml(str(tmp_path / "cfg.yaml"))
    return cfg


@pytest.mark.parametrize("fake_imaging", [False, True])
def test_cli_predict_2d_cpu(rng, tmp_path, fake_imaging):
    """``predict`` through cli.main on an (H, W, 1) .npy with a DIMENSIONS: 2
    config: one (h, w) page, equal to the stitcher's own result."""
    cfg = _cfg_2d(tmp_path)
    os.makedirs(tmp_path / "in")
    img = (rng.normal(size=(30, 26, 1)) * 10 + 50).astype(np.float32)
    np.save(tmp_path / "in" / "v.npy", img)
    weights = str(tmp_path / "w.pt")
    VanGan(cfg, device="cpu").save_weights(weights)
    cli.main(["predict", "--config", str(tmp_path / "cfg.yaml"), "--input",
              str(tmp_path / "in"), "--output", str(tmp_path / "out"), "--weights", weights,
              "--stride", "8", "8", "8", "--device", "cpu",
              *(["--fake-imaging"] if fake_imaging else [])])
    assert np.asarray(iio.imread(tmp_path / "out" / "VANGAN_v.tiff")).shape[:2] == (30, 26)
    ours = read_tiff(str(tmp_path / "out" / "VANGAN_v.tiff"))
    assert ours.shape == (1, 30, 26, 1)
    assert np.isfinite(ours).all() and ours.min() == 0.0 and ours.max() == 255.0
    gan = VanGan(cfg, device="cpu")
    gan.load_weights(weights)
    direct = stitcher.stitch_subvolumes(
        gan.gen_SI_batched if fake_imaging else gan.gen_IS_batched, img, cfg.subvol_size,
        stride=(8, 8, 8), complete=True, save=False, process_img=fake_imaging, batch_size=4,
        device="cpu")
    np.testing.assert_array_equal(ours[0], direct)


def test_cli_predict_2d_raw_tiffs(rng, tmp_path):
    """Raw one-page TIFFs: preprocessed into (H, W, 1) .npy, then segmented."""
    cfg = _cfg_2d(tmp_path)
    os.makedirs(tmp_path / "raw")
    for i in range(2):
        iio.imwrite(tmp_path / "raw" / f"r{i}.tiff",
                    (rng.normal(size=(28, 24)) * 30 + 100).astype(np.float32))
    weights = str(tmp_path / "w.pt")
    VanGan(cfg, device="cpu").save_weights(weights)
    cli.main(["predict", "--config", str(tmp_path / "cfg.yaml"), "--input",
              str(tmp_path / "raw"), "--output", str(tmp_path / "out"), "--weights", weights,
              "--stride", "8", "8", "8", "--device", "cpu"])
    for i in range(2):
        assert np.load(tmp_path / "out" / "preprocessed_npy" / f"r{i}.npy").shape == (28, 24, 1)
        assert read_tiff(str(tmp_path / "out" / f"VANGAN_r{i}.tiff")).shape == (1, 28, 24, 1)

