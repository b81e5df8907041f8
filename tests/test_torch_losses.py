"""The port's losses and normalisations against the JAX package's.

Every ported function of ``vangan_torch.losses``, ``ops.norms`` and
``ops.ssim`` runs on the same seeded float32 inputs as its JAX counterpart
on the CPU (clDice on the plain skeletons of both). Tolerance: rtol 1e-5,
atol 1e-6 (float32 sums in another order; the JAX package's
``tests/test_losses.py`` lists the quirks covered here: the axis=None scale,
the Keras BCE clip, the [-1, 0, 1] Gaussian grid, per-group clDice).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vangan_tpu import losses as J
from vangan_tpu.ops import norms as jax_norms
from vangan_tpu.ops.ssim import ssim3d_loss_map as jax_ssim
from vangan_torch import losses as T
from vangan_torch.ops import norms
from vangan_torch.ops.ssim import ssim3d_loss_map

SHAPE = (4, 9, 10, 11, 1)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=1e-5, atol=1e-6)


def _scales(n_dev=2, groups=None, **kw):
    common = dict(global_batch_size=SHAPE[0], n_devices=n_dev, cldice_iters=3,
                  cldice_groups=groups, **kw)
    return J.LossScales(**common), T.LossScales(**common)


@pytest.fixture
def data():
    rng = np.random.default_rng(0)
    real = rng.uniform(-1, 1, SHAPE).astype(np.float32)
    fake = np.tanh(rng.normal(size=SHAPE)).astype(np.float32)
    seg = np.where(rng.uniform(size=SHAPE) > 0.7, 1.0, -1.0).astype(np.float32)
    logits = rng.normal(0.3, 1.2, (4, 3, 3, 3, 1)).astype(np.float32)
    return {k: (jnp.asarray(v), torch.from_numpy(v))
            for k, v in dict(real=real, fake=fake, seg=seg, logits=logits).items()}


def test_ssim3d_loss_map(data):
    a01 = [(x[0] + 1) / 2 for x in (data["real"], data["fake"])]
    t01 = [(x[1] + 1) / 2 for x in (data["real"], data["fake"])]
    _close(ssim3d_loss_map(*t01), jax_ssim(*a01))


@pytest.mark.parametrize("typ", [None, "mse", "L4", "bce"])
def test_cycle_loss(data, typ):
    js, ts = _scales()
    _close(T.cycle_loss(ts, data["real"][1], data["fake"][1], typ),
           J.cycle_loss(js, data["real"][0], data["fake"][0], typ))


def test_cycle_reconstruction(data):
    js, ts = _scales()
    _close(T.cycle_reconstruction(ts, data["real"][1], data["fake"][1]),
           J.cycle_reconstruction(js, data["real"][0], data["fake"][0]))


@pytest.mark.parametrize("groups", [1, 2])
def test_cycle_seg_loss(data, groups):
    js, ts = _scales(groups=groups)
    _close(T.cycle_seg_loss(ts, data["seg"][1], data["fake"][1]),
           J.cycle_seg_loss(js, data["seg"][0], data["fake"][0]))


@pytest.mark.parametrize("typ", [None, "cldice"])
def test_identity_loss(data, typ):
    js, ts = _scales()
    _close(T.identity_loss(ts, data["seg"][1], data["fake"][1], typ),
           J.identity_loss(js, data["seg"][0], data["fake"][0], typ))


@pytest.mark.parametrize("typ,from_logits", [(None, True), ("bce", True), ("bfce", True),
                                             ("bce", False)])
def test_adversarial_losses(data, typ, from_logits):
    js, ts = _scales()
    lj, lt = data["logits"]
    _close(T.generator_loss_fn(ts, lt, typ, from_logits),
           J.generator_loss_fn(js, lj, typ, from_logits))
    _close(T.discriminator_loss_fn(ts, lt * 0.5 + 0.2, lt, typ, from_logits),
           J.discriminator_loss_fn(js, lj * 0.5 + 0.2, lj, typ, from_logits))


def test_wasserstein_value_losses(data):
    js, ts = _scales()
    lj, lt = data["logits"]
    _close(T.wasserstein_generator_loss(ts, lt), J.wasserstein_generator_loss(js, lj))
    _close(T.wasserstein_discriminator_loss(ts, lt + 1.0, lt),
           J.wasserstein_discriminator_loss(js, lj + 1.0, lj))
    # the gradient penalty of a smooth critic, with the interpolation weights
    # JAX draws from its key (the critics: test_torch_wgan.py)
    key = jax.random.PRNGKey(3)
    alpha = torch.from_numpy(np.array(jax.random.normal(key, (SHAPE[0], 1, 1, 1, 1))))
    (rj, rt), (fj, ft) = data["real"], data["fake"]
    _close(T.gradient_penalty(ts, lambda x: (torch.tanh(2 * x) * x).sum(dim=(1, 2, 3, 4)), rt,
                              ft, alpha=alpha).detach(),
           J.gradient_penalty(js, lambda x: jnp.sum(jnp.tanh(2 * x) * x, axis=(1, 2, 3, 4)), rj,
                              fj, key))


def test_elementary_and_dice(data):
    js, ts = _scales()
    (rj, rt), (fj, ft) = data["real"], data["fake"]
    for name in ("MAE", "MSE", "L4"):
        _close(getattr(T, name)(ts, rt, ft), getattr(J, name)(js, rj, fj))
    _close(T.MSLE(ts, rt + 1.5, ft + 1.5), J.MSLE(js, rj + 1.5, fj + 1.5))
    _close(T.bce_elementwise((rt + 1) / 2, (ft + 1) / 2),
           J.bce_elementwise((rj + 1) / 2, (fj + 1) / 2))
    a, b = (rt + 1) / 2, (ft + 1) / 2
    _close(T.soft_dice(a, b), J.soft_dice((rj + 1) / 2, (fj + 1) / 2))
    _close(T.soft_clDice_loss(a, b, 3), J.soft_clDice_loss((rj + 1) / 2, (fj + 1) / 2, 3))


@pytest.mark.parametrize("axis", [None, (1, 2, 3, 4)])
def test_min_max_norm(data, axis):
    _close(norms.min_max_norm(data["fake"][1], axis), jax_norms.min_max_norm(data["fake"][0], axis))


def test_min_max_norm_constant_slice_is_nan():
    x = torch.ones(2, 3, 3, 3, 1)
    assert bool(torch.isnan(norms.min_max_norm(x, axis=(1, 2, 3, 4))).all())


def test_minmax_to_pm1_and_rescale(data):
    _close(norms.minmax_to_pm1(data["fake"][1]), jax_norms.minmax_to_pm1(data["fake"][0]))
    _close(norms.rescale_arr(data["fake"][1]), jax_norms.rescale_arr(data["fake"][0]))
    _close(norms.rescale_arr(data["fake"][1], 1.0, 2.0),
           jax_norms.rescale_arr(data["fake"][0], 1.0, 2.0))
    assert torch.equal(norms.rescale_arr(data["fake"][1], 1.0, 0.0),
                       torch.zeros_like(data["fake"][1]))
