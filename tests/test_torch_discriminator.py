"""The port's PatchGAN discriminator and its stochastic layers against the
JAX package's.

The forward runs in float32 on the CPU in eval mode: flax on the NXCYZ
layout (its CPU reference path), the port on its plain torch versions, from
one flax parameter tree mapped by ``flax_to_torch``. Tolerance: atol 1e-4 on
the patch logits (float32 sums in another order through five convs and four
InstanceNorms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vangan_tpu.config import VanGanConfig as JaxConfig
from vangan_tpu.models.discriminator import PatchGANDiscriminator3D as FlaxDisc
from vangan_tpu.models.factory import build_discriminator as jax_build_discriminator
from vangan_torch.config import VanGanConfig
from vangan_torch.models.discriminator import PatchGANDiscriminator3D
from vangan_torch.models.factory import build_discriminator
from vangan_torch.models.layers import DiscDownsample, GaussianNoise, spatial_dropout
from vangan_torch.weights import flax_to_torch, load_flax_params, torch_to_flax

STOCHASTIC = dict(use_dropout=True, use_input_noise=True, use_layer_noise=True)


def test_forward_matches_flax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, size=(2, 16, 16, 16, 1)).astype(np.float32)
    fm = FlaxDisc(filters=8, layout="NXCYZ", dtype=jnp.float32, **STOCHASTIC)
    params = fm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    # non-trivial IN affines and head bias, so their mapping is exercised
    params = jax.tree_util.tree_map(
        lambda p: p + 0.1 * jnp.asarray(rng.normal(size=p.shape), p.dtype)
        if p.ndim == 1 else p, params)
    want = np.asarray(fm.apply({"params": params}, jnp.asarray(x), train=False))

    tm = load_flax_params(PatchGANDiscriminator3D(filters=8, **STOCHASTIC), params)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2, 2, 2, 1)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_factory_leaves_match_at_full_width():
    """The factory disc at f=64: 14 flax leaves, 14 torch parameters, the same
    names and shapes."""
    fm = jax_build_discriminator(JaxConfig(compute_dtype="float32"))
    shapes = jax.eval_shape(lambda: fm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 32, 32, 32, 1))))["params"]
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    tm = build_discriminator(VanGanConfig(compute_dtype="float32"))
    sd = flax_to_torch(params, tm)
    assert len(sd) == len(tm.state_dict()) == 14
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert tm.state_dict()["down2.conv.weight"].shape == (512, 256, 4, 4, 4)


def test_weight_mapping_round_trips():
    fm = FlaxDisc(filters=8, layout="NXCYZ", dtype=jnp.float32)
    params = fm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 16, 1)))["params"]
    tm = PatchGANDiscriminator3D(filters=8)
    back = torch_to_flax(flax_to_torch(params, tm), tm)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [jax.tree_util.keystr(p) for p, _ in flat_a] == \
        [jax.tree_util.keystr(p) for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_noise_identity_in_eval_or_at_zero_sigma_and_seeded_in_training():
    x = torch.randn(2, 3, 4, 4, 4)
    noise = GaussianNoise(0.1)
    assert noise(x) is x  # eval
    assert noise(x, train=True, stddev=0.0) is x
    a = noise(x, train=True, stddev=0.5, generator=torch.Generator().manual_seed(1))
    b = noise(x, train=True, stddev=0.5, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, x)
    assert abs(float((a - x).std()) - 0.5) < 0.1
    with pytest.raises(ValueError, match="generator"):
        noise(x, train=True)


def test_spatial_dropout_drops_whole_channels():
    x = torch.rand(4, 16, 3, 3, 3) + 1.0
    rate = 0.25
    assert spatial_dropout(x, rate) is x  # eval
    y = spatial_dropout(x, rate, train=True, generator=torch.Generator().manual_seed(2))
    dropped = (y == 0).flatten(2).all(dim=2)
    kept = torch.isclose(y, x / (1 - rate)).flatten(2).all(dim=2)
    assert bool((dropped ^ kept).all())  # each (b, c) channel wholly dropped or scaled
    assert 0 < int(dropped.sum()) < dropped.numel()


def test_disc_in_training_is_seeded_and_differs_from_eval():
    disc = PatchGANDiscriminator3D(filters=4, **STOCHASTIC)
    x = torch.rand(1, 16, 16, 16, 1)
    with torch.no_grad():
        a = disc(x, train=True, noise_std=0.1, generator=torch.Generator().manual_seed(3))
        b = disc(x, train=True, noise_std=0.1, generator=torch.Generator().manual_seed(3))
        c = disc(x)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_downsample_same_padding_is_tf_same():
    """Stride 1 'same' with a 4^3 kernel pads (1, 2): the output keeps the size."""
    block = DiscDownsample(2, 3, 4, 1, "same")
    assert block(torch.rand(1, 2, 5, 6, 7)).shape == (1, 3, 5, 6, 7)


@pytest.mark.parametrize("kwargs", [{"use_SN": True}, {"wasserstein": True}])
def test_unported_options_raise(kwargs):
    """Spectral norm and the Wasserstein head are ported (test_torch_wgan.py);
    a Wasserstein head without the patch size its Dense needs raises, and the
    config refuses a rank other than 2 or 3 (the 2-D mode is ported:
    test_torch_2d_*.py)."""
    if "wasserstein" in kwargs:
        with pytest.raises(ValueError, match="patch_size"):
            PatchGANDiscriminator3D(filters=4, **kwargs)
        assert VanGanConfig(**kwargs).wasserstein
    disc = PatchGANDiscriminator3D(filters=4, patch_size=(16, 16, 16), **kwargs)
    out = disc(torch.rand(1, 16, 16, 16, 1))
    assert out.shape == ((1, 1) if "wasserstein" in kwargs else (1, 2, 2, 2, 1))
    assert VanGanConfig(DIMENSIONS=2).INPUT_IMG_SIZE == (3, 128, 128, 1)
    with pytest.raises(ValueError, match="DIMENSIONS"):
        VanGanConfig(DIMENSIONS=4)
