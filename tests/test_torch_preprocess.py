"""The port's TIFF preprocessing against the JAX package's.

Raw TIFFs of 24 x 24 x 16 voxels (16 pages of 24 x 24), written as float32,
uint8 and uint16 with imageio, go through ``vangan_tpu.data.preprocess``
(which reads them with imageio) and ``vangan_torch.data.preprocess`` (which
reads them with Pillow). Both domains, with and without a Lanczos resize to
another size and the ``rsom`` hook. Tolerance: none. The .npy volumes and the
filtered uint8 dumps must be bit-identical, and the partition pickles equal
under the same seed (paths compared relative to their roots).
"""

import os
import pickle

import imageio.v3 as iio
import numpy as np
import pytest

from vangan_tpu.data import preprocess as jax_pre
from vangan_tpu.utils import preprocess_rsom_images as jax_rsom
from vangan_torch.data import preprocess as pre
from vangan_torch.utils import preprocess_rsom_images

SHAPE_ZYX = (16, 24, 24)
TIFF_SIZE = (24, 24, 16, 1)
TARGET = (20, 28, 12, 1)  # another size in every axis: both resize passes run
DTYPES = ("float32", "uint8", "uint16")


def _volume(rng, dtype, domain):
    if domain == "segmentation":
        return ((rng.uniform(size=SHAPE_ZYX) > 0.8) * 255).astype(dtype)
    if dtype == "float32":
        return (rng.normal(size=SHAPE_ZYX) * 40 + 100).astype(np.float32)
    hi = 255 if dtype == "uint8" else 4095
    return rng.integers(0, hi + 1, size=SHAPE_ZYX).astype(dtype)


def _write_raw(dirpath, n, dtype="float32", domain="imaging", seed=0):
    os.makedirs(dirpath, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        iio.imwrite(os.path.join(dirpath, f"v{i}.tiff"), _volume(rng, dtype, domain))
    return str(dirpath)


def _npys(root):
    """{path relative to root: array} of every .npy under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".npy"):
                out[os.path.relpath(os.path.join(d, f), root)] = np.load(os.path.join(d, f))
    return out


def _assert_same_npys(got_root, want_root):
    got, want = _npys(got_root), _npys(want_root)
    assert sorted(got) == sorted(want) and want
    for key, w in want.items():
        assert got[key].dtype == w.dtype and got[key].shape == w.shape, key
        assert np.array_equal(got[key], w), key


def _task(raw, out, domain, resize, hook, filtered=None):
    return (raw, "v0.tiff", out, 3, domain, TIFF_SIZE, TARGET if resize else TIFF_SIZE, resize,
            hook, filtered is not None, filtered)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("resize", [False, True])
# the rsom hook is an imaging-domain hook (cmd_preprocess)
@pytest.mark.parametrize("domain,rsom", [("imaging", False), ("imaging", True),
                                         ("segmentation", False)])
def test_process_one_bit_identical(tmp_path, dtype, domain, resize, rsom):
    raw = _write_raw(tmp_path / "raw", 1, dtype, domain)
    for name, mod, hook in (("jax", jax_pre, jax_rsom), ("port", pre, preprocess_rsom_images)):
        out = tmp_path / name
        os.makedirs(out)
        assert mod._process_one(_task(raw, str(out), domain, resize, hook if rsom else None,
                                      str(out / "filtered"))) is None
    _assert_same_npys(tmp_path / "port", tmp_path / "jax")
    vol = np.load(tmp_path / "port" / "v0.npy")
    shape = TARGET[:3] if resize else TIFF_SIZE[:3]
    assert vol.shape == (*shape, 1) and vol.dtype == np.float32
    assert vol.min() == -1.0 and vol.max() == 1.0
    if domain == "segmentation":
        assert set(np.unique(vol)) == {-1.0, 1.0}
    # the filtered dump: uint8 pages, (z, y, x), identical
    got = iio.imread(tmp_path / "port" / "filtered" / "v0.tiff")
    want = iio.imread(tmp_path / "jax" / "filtered" / "v0.tiff")
    assert got.dtype == want.dtype == np.uint8 and got.shape == (shape[2], shape[1], shape[0])
    assert np.array_equal(got, want)


def test_segmentation_polarity_fix(tmp_path):
    """A volume whose background (the mode) is bright is inverted, in both."""
    os.makedirs(tmp_path / "raw")
    rng = np.random.default_rng(3)
    vol = np.where(rng.uniform(size=SHAPE_ZYX) > 0.2, 255, 0).astype(np.uint8)
    iio.imwrite(tmp_path / "raw" / "v0.tiff", vol)
    for name, mod in (("jax", jax_pre), ("port", pre)):
        os.makedirs(tmp_path / name)
        mod._process_one(_task(str(tmp_path / "raw"), str(tmp_path / name), "segmentation",
                               False, None))
    _assert_same_npys(tmp_path / "port", tmp_path / "jax")
    got = np.load(tmp_path / "port" / "v0.npy")[..., 0]
    # the bright 80% became background (-1)
    assert np.array_equal(got == 1.0, np.transpose(vol, (1, 2, 0)) == 0)


def test_nan_volume_is_skipped(tmp_path, capsys):
    raw = _write_raw(tmp_path / "raw", 2)
    bad = iio.imread(os.path.join(raw, "v1.tiff"))
    bad[3, 4, 5] = np.nan
    iio.imwrite(os.path.join(raw, "v1.tiff"), bad)
    for name, mod in (("jax", jax_pre), ("port", pre)):
        p = mod.DataPreprocessor(num_workers=1)
        p.process_new_data(raw, str(tmp_path / name))
        assert sorted(os.listdir(tmp_path / name)) == ["v0.npy"]
        assert "NaN detected, skipped v1.tiff" in capsys.readouterr().out
    _assert_same_npys(tmp_path / "port", tmp_path / "jax")


def _partition(path, root):
    with open(path, "rb") as f:
        part = pickle.load(f)
    return {k: [os.path.relpath(str(p), root) for p in v] for k, v in part.items()}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("domain", ["imaging", "segmentation"])
def test_preprocess_matches_jax(tmp_path, dtype, domain):
    """Ten volumes split 7/2/1 by the seed; the port's pool of two spawned
    workers against JAX's serial run."""
    raw = _write_raw(tmp_path / "raw", 10, dtype, domain, seed=1)
    hook = domain == "imaging"
    for name, mod, fn, workers in (("jax", jax_pre, jax_rsom, 1),
                                   ("port", pre, preprocess_rsom_images, 2)):
        p = mod.DataPreprocessor(
            raw_path=raw, main_dir=str(tmp_path / name), partition_id="A",
            partition_filename="dataA_partition.pkl", tiff_size=TIFF_SIZE, target_size=TARGET,
            domain=domain, num_workers=workers, seed=5)
        p.preprocess(preprocess_fn=fn if hook else None, resize=True, save_filtered=True)
    _assert_same_npys(tmp_path / "port", tmp_path / "jax")
    got = _partition(tmp_path / "port" / "dataA_partition.pkl", tmp_path / "port")
    want = _partition(tmp_path / "jax" / "dataA_partition.pkl", tmp_path / "jax")
    assert got == want
    assert [len(got[s]) for s in ("training", "validation", "testing")] == [7, 2, 1]
    for sub in ("trainA", "valA", "testA"):
        for f in os.listdir(tmp_path / "port" / "filtered" / sub):
            a = iio.imread(tmp_path / "port" / "filtered" / sub / f)
            assert a.dtype == np.uint8
            assert np.array_equal(a, iio.imread(tmp_path / "jax" / "filtered" / sub / f))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("resize", [False, True])
def test_process_new_data_matches_jax(tmp_path, dtype, resize):
    raw = _write_raw(tmp_path / "raw", 3, dtype, seed=2)
    for name, mod, fn in (("jax", jax_pre, jax_rsom), ("port", pre, preprocess_rsom_images)):
        p = mod.DataPreprocessor(partition_id="A", domain="imaging")
        p.process_new_data(raw, str(tmp_path / name), tiff_size=TIFF_SIZE, target_size=TARGET,
                           preprocess_fn=fn, resize=resize)
    _assert_same_npys(tmp_path / "port", tmp_path / "jax")


def test_split_save_and_move_dataset_match_jax(tmp_path):
    """``split_dataset``, ``save_partition`` and ``move_dataset`` with the
    same seed move the same files into the same split directories."""
    for name, mod in (("jax", jax_pre), ("port", pre)):
        raw = _write_raw(tmp_path / name / "raw", 10, seed=4)
        main = tmp_path / name / "data"
        for sub in ("trainB", "valB", "testB"):
            os.makedirs(main / sub)
        p = mod.DataPreprocessor(raw_path=raw, main_dir=str(main), partition_id="B",
                                 partition_filename="dataB_partition.pkl", seed=9)
        p.split_dataset()
        p.move_dataset()
        assert not os.listdir(raw)
        p.save_partition(str(main))
    listing = {name: {sub: sorted(os.listdir(tmp_path / name / "data" / sub))
                      for sub in ("trainB", "valB", "testB")} for name in ("jax", "port")}
    assert listing["port"] == listing["jax"]
    assert _partition(tmp_path / "port" / "data" / "dataB_partition.pkl",
                      tmp_path / "port" / "data") == \
        _partition(tmp_path / "jax" / "data" / "dataB_partition.pkl", tmp_path / "jax" / "data")
    with pytest.raises(ValueError, match="save_path"):
        pre.DataPreprocessor().save_partition()


def test_resize_volume_matches_jax(rng):
    img = (rng.normal(size=(24, 24, 16)) * 40 + 100).astype(np.float32)
    for target in ((24, 24, 12), (20, 28, 12), (30, 18, 20)):
        got = pre.resize_volume(img, target)
        assert got.shape == target and got.dtype == np.float32
        assert np.array_equal(got, jax_pre.resize_volume(img, target))


def test_write_tiff_keeps_uint8_and_reads_uint16(tmp_path):
    """The port's Pillow writer keeps uint8 pages (the filtered dump) and
    writes others as float32; its reader gives what imageio reads, as
    float32, for uint8, uint16 (``I;16``) and float32 pages."""
    rng = np.random.default_rng(0)
    for dtype in DTYPES:
        vol = _volume(rng, dtype, "imaging")
        iio.imwrite(tmp_path / f"{dtype}.tiff", vol)
        got = pre.read_tiff(str(tmp_path / f"{dtype}.tiff"))
        assert got.dtype == np.float32 and got.shape == (*SHAPE_ZYX, 1)
        assert np.array_equal(got[..., 0], vol.astype(np.float32))
    u8 = _volume(rng, "uint8", "imaging")
    pre.write_tiff(str(tmp_path / "w8.tiff"), u8)
    back = iio.imread(tmp_path / "w8.tiff")
    assert back.dtype == np.uint8 and np.array_equal(back, u8)
    pre.write_tiff(str(tmp_path / "w16.tiff"), u8.astype(np.uint16))
    assert iio.imread(tmp_path / "w16.tiff").dtype == np.float32
