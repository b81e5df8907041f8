"""The port's Dice and clDice against ``vangan_tpu.metrics``.

Seeded binary tube volumes of 32 x 30 x 28 voxels, a truth and a prediction
that misses some tubes and adds others, go through both packages with
``iters`` 5 and 15 (the port with ``device="cpu"``, where the skeleton is the
plain ``morphology.soft_skel``; JAX jits ``ops.morphology.soft_skel``). The
skeleton of a binary volume is exact in both, and both sum on the host in
the same dtypes, so the scores must be exactly equal: no tolerance.
"""

import numpy as np
import pytest

from vangan_tpu import metrics as jax_metrics
from vangan_torch import metrics

SHAPE = (32, 30, 28)


def tube_volume(rng, shape=SHAPE, n_tubes=6):
    """{0, 1} volume of straight tubes of radius 1.5-3 in random directions."""
    grid = np.stack(np.meshgrid(*[np.arange(n) for n in shape], indexing="ij"), -1)
    seg = np.zeros(shape, bool)
    for _ in range(n_tubes):
        p0 = rng.uniform(0, 1, 3) * np.asarray(shape)
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        rel = grid - p0
        off = rel - (rel @ d)[..., None] * d
        seg |= (off ** 2).sum(-1) < rng.uniform(1.5, 3.0) ** 2
    return seg.astype(np.float32)


@pytest.fixture(scope="module")
def volumes():
    rng = np.random.default_rng(11)
    truth = tube_volume(rng)
    pred = np.maximum(truth * (rng.uniform(size=SHAPE) > 0.1), tube_volume(rng, n_tubes=2))
    assert 0.02 < truth.mean() < 0.4 and not np.array_equal(pred, truth)
    return truth, pred


@pytest.mark.parametrize("iters", [5, 15])
def test_skeleton_and_scores_equal_jax(volumes, iters):
    truth, pred = volumes
    skel = metrics._skeletonize(truth, iters, device="cpu")
    want = jax_metrics._skeletonize(truth, iters)
    assert skel.dtype == want.dtype and np.array_equal(skel, want)
    assert 0 < skel.sum() < truth.sum()
    assert metrics.dice_coefficient(truth, pred) == jax_metrics.dice_coefficient(truth, pred)
    got = metrics.cldice_metric(truth, pred, iters=iters, device="cpu")
    assert got == jax_metrics.cldice_metric(truth, pred, iters=iters)
    assert 0.0 < got < 1.0
    batched = metrics._skeletonize(truth[None, ..., None], iters, device="cpu")
    assert np.array_equal(batched[0, ..., 0], skel)


@pytest.mark.parametrize("iters", [5, 15])
@pytest.mark.parametrize("signed", [False, True])
def test_evaluate_segmentation_equals_jax(volumes, iters, signed):
    """``truth`` in {-1, 1} (the preprocessed segmentation domain) or {0, 1};
    the prediction a stitched 0..255 volume, binarised at its midpoint."""
    truth, pred = volumes
    t = 2 * truth - 1 if signed else truth
    rng = np.random.default_rng(iters)
    stitched = np.where(pred > 0, rng.uniform(140, 255, SHAPE), rng.uniform(0, 110, SHAPE))
    stitched = stitched.astype(np.float32)
    got = metrics.evaluate_segmentation(stitched, t, iters=iters, device="cpu")
    want = jax_metrics.evaluate_segmentation(stitched, t, iters=iters)
    assert got == want
    assert got == metrics.evaluate_segmentation(pred, truth, iters=iters, device="cpu")
    assert np.array_equal(metrics.binarise_prediction(stitched), pred)
    assert metrics.evaluate_segmentation(truth, t, iters=iters, device="cpu") == \
        {"dice": 1.0, "cldice": 1.0}


def test_threshold_and_shape_checks(volumes):
    truth, pred = volumes
    for mod in (metrics, jax_metrics):
        assert np.array_equal(mod.binarise_prediction(pred * 200, threshold=50.0), pred)
    kw = dict(iters=5, device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        metrics.evaluate_segmentation(pred[:-1], truth, **kw)
    with pytest.raises(ValueError, match="shape mismatch"):
        jax_metrics.evaluate_segmentation(pred[:-1], truth, iters=5)
    # a bare 2-D image is the DIMENSIONS=2 mode's (tests/test_torch_2d_ops.py)
    assert metrics.cldice_metric(truth[:, :, 0], pred[:, :, 0], **kw) == \
        jax_metrics.cldice_metric(truth[:, :, 0], pred[:, :, 0], iters=5)
    with pytest.raises(ValueError, match="expected"):
        metrics.cldice_metric(truth[None, None, ..., None], pred[None, None, ..., None], **kw)
