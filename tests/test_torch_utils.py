"""The port's host utilities and numpy normalisations against the JAX package's.

Seeded numpy inputs go through ``vangan_tpu.utils`` / ``vangan_tpu.ops.norms``
and ``vangan_torch.utils`` / ``vangan_torch.ops.norms``. The numpy helpers
must be bit-identical (the crops with the same numpy ``Generator``), and
``replace_nan``, ``binarise`` and ``clip_images`` exactly equal on torch
tensors. ``z_score_norm_batch`` reduces in another order: rtol 1e-5, atol
1e-6 (float32). ``add_gauss_noise`` cannot match JAX's random stream: it is
held to its clip, shape, dtype and determinism for a fixed generator.
"""

import imageio.v3 as iio
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vangan_tpu import utils as jax_utils
from vangan_tpu.ops import norms as jax_norms
from vangan_torch import utils
from vangan_torch.ops import norms


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want, equal_nan=True)


@pytest.fixture
def vol(rng):
    return (rng.normal(size=(12, 10, 8, 1)) * 40 + 100).astype(np.float32)


@pytest.mark.parametrize("name", ["min_max_norm_np", "z_score_norm", "threshold_outliers"])
def test_numpy_norms_bit_identical(vol, name):
    vol = vol.copy()
    vol[1, 2, 3] = 1e4  # an outlier for threshold_outliers
    for args in ((vol,), (vol[..., 0],)) + (((vol, 2.0),) if name == "threshold_outliers" else ()):
        _same(getattr(norms, name)(*args), getattr(jax_norms, name)(*args))


def test_min_max_norm_np_raises_on_a_constant_array():
    for mod in (norms, jax_norms):
        with pytest.raises(ValueError, match="max and min are equal"):
            mod.min_max_norm_np(np.full((4, 4, 4), 3.0, np.float32))


def test_z_score_norm_of_a_constant_array_centres_it():
    a = np.full((3, 3), 2.5, np.float32)
    _same(norms.z_score_norm(a), jax_norms.z_score_norm(a))


def test_tensor_norms_match_jax(vol):
    batch = np.stack([vol, np.zeros_like(vol), -vol])  # the middle sample has std 0
    got = norms.z_score_norm_batch(torch.from_numpy(batch)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_norms.z_score_norm_batch(jnp.asarray(batch))),
                               rtol=1e-5, atol=1e-6)
    signed = batch - 100.0
    signed[0, 0, 0, 0] = 0.0  # 0 maps to +1
    for name in ("binarise", "clip_images"):
        got = getattr(norms, name)(torch.from_numpy(signed / 50)).numpy()
        _same(got, np.asarray(getattr(jax_norms, name)(jnp.asarray(signed / 50))))


def test_check_and_replace_nan(vol):
    assert not utils.check_nan(vol) and not jax_utils.check_nan(vol)
    vol = vol.copy()
    vol[0, 1, 2, 0] = vol[5, 4, 3, 0] = np.nan
    assert utils.check_nan(vol) and jax_utils.check_nan(vol)
    _same(utils.replace_nan(torch.from_numpy(vol)).numpy(),
          np.asarray(jax_utils.replace_nan(jnp.asarray(vol))))


def test_add_gauss_noise_clips_and_is_deterministic():
    img = torch.linspace(-1, 1, 4 * 5 * 6).reshape(1, 4, 5, 6, 1)
    draws = [utils.add_gauss_noise(img, 0.5, torch.Generator().manual_seed(s)) for s in (3, 3, 4)]
    for d in draws:
        assert d.shape == img.shape and d.dtype == img.dtype
        assert float(d.min()) >= -1.0 and float(d.max()) <= 1.0
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
    assert bool(((draws[0] == 1.0) | (draws[0] == -1.0)).any())  # rate 0.5 reaches the clip
    half = utils.add_gauss_noise(img.double(), 0.5, torch.Generator().manual_seed(3))
    assert half.dtype == torch.float64


@pytest.mark.parametrize("dtype", ["float32", "uint16"])
@pytest.mark.parametrize("normalise", [False, True])
def test_load_volume_bit_identical(tmp_path, rng, dtype, normalise):
    raw = (rng.uniform(size=(6, 9, 7)) * 300).astype(dtype)
    iio.imwrite(tmp_path / "v.tiff", raw)
    for datatype in ("uint8", "float32"):
        _same(utils.load_volume(str(tmp_path / "v.tiff"), datatype, normalise),
              jax_utils.load_volume(str(tmp_path / "v.tiff"), datatype, normalise))


def test_get_vacuum_and_hist_equalization_bit_identical(rng):
    arr = np.zeros((12, 10, 8, 1), np.float32)
    arr[3:7, 2:9, 1:5] = rng.uniform(size=(4, 7, 4, 1))
    _same(utils.get_vacuum(arr), jax_utils.get_vacuum(arr))
    assert utils.get_vacuum(arr).shape == (4, 7, 4, 1)
    _same(utils.get_vacuum(arr[:, :, 2], dim=2), jax_utils.get_vacuum(arr[:, :, 2], dim=2))
    img = np.round(rng.normal(size=(9, 11)) * 5).astype(np.float32)
    _same(utils.hist_equalization(img), jax_utils.hist_equalization(img))


def test_save_and_load_dict(tmp_path):
    d = {"a": np.arange(3), "b": "x"}
    utils.save_dict(d, str(tmp_path / "ours.pkl"))
    jax_utils.save_dict(d, str(tmp_path / "jax.pkl"))
    assert (tmp_path / "ours.pkl").read_bytes() == (tmp_path / "jax.pkl").read_bytes()
    back = jax_utils.load_dict(str(tmp_path / "ours.pkl"))
    assert back["b"] == "x" and np.array_equal(back["a"], d["a"])
    assert utils.load_dict(str(tmp_path / "jax.pkl"))["b"] == "x"


def test_get_sub_volume_same_generator_same_crop(vol):
    for seed in range(4):
        _same(utils.get_sub_volume(vol, (5, 4, 3), rng=np.random.default_rng(seed)),
              jax_utils.get_sub_volume(vol, (5, 4, 3), rng=np.random.default_rng(seed)))


def test_preprocess_rsom_images_bit_identical(rng):
    img = (rng.gamma(2.0, 30.0, size=(16, 12, 10))).astype(np.float32)
    img[:, :, 4] = 7.0  # a constant slice: mean-centred only
    _same(utils.preprocess_rsom_images(img), jax_utils.preprocess_rsom_images(img))
    _same(utils.preprocess_rsom_images(img.astype(np.uint16), 1.0, 99.0),
          jax_utils.preprocess_rsom_images(img.astype(np.uint16), 1.0, 99.0))


@pytest.mark.parametrize("axis", [1, 3])
@pytest.mark.parametrize("rescale", [False, True])
def test_matched_crop_bit_identical(rng, axis, rescale):
    stack = rng.normal(size=(3, 20, 18, 16, 1)).astype(np.float32)
    img_size = (3, 6, 5, 4, 1)
    for seed in range(3):
        got = utils.matched_crop(stack, 2, img_size, 1, axis, np.random.default_rng(seed), rescale)
        want = jax_utils.matched_crop(stack, 2, img_size, 1, axis, np.random.default_rng(seed),
                                      rescale)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            _same(g, w)
    with pytest.raises(ValueError, match="axis"):
        utils.matched_crop(stack, 2, img_size, 1, 2)

