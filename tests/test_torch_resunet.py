"""The port's ResU-Net generator against the flax ResUNet3D.

Both run in float32 on the CPU: flax on the NXCYZ layout (its CPU reference
path: XLA convs and the jnp InstanceNorm), the port on its plain torch
versions, from one flax parameter tree mapped by ``flax_to_torch``.
Tolerance: atol 1e-4 on the tanh outputs (f32 sums in another order through
~16 conv/norm layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vangan_tpu.config import VanGanConfig as JaxConfig
from vangan_tpu.models.factory import build_generator as jax_build_generator
from vangan_tpu.models.resunet import ResUNet3D as FlaxResUNet3D
from vangan_torch.config import VanGanConfig
from vangan_torch.models.factory import build_generator
from vangan_torch.models.resunet import ResUNet3D
from vangan_torch.weights import flax_to_torch, load_flax_params, torch_to_flax


def _flax_model(filters=4, num_layers=2):
    return FlaxResUNet3D(upsample_mode="simple", dropout_type="none", filters=filters,
                         num_layers=num_layers, output_activation="tanh",
                         layout="NXCYZ", dtype=jnp.float32)


def test_forward_matches_flax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, size=(2, 16, 16, 16, 1)).astype(np.float32)
    fm = _flax_model()
    params = fm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    # non-trivial IN affine and conv biases, so their mapping is exercised
    params = jax.tree_util.tree_map(
        lambda p: p + 0.1 * jnp.asarray(rng.normal(size=p.shape), p.dtype)
        if p.ndim == 1 else p, params)
    want = np.asarray(fm.apply({"params": params}, jnp.asarray(x)))

    tm = load_flax_params(ResUNet3D(filters=4, num_layers=2), params)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_weight_mapping_round_trips():
    fm = _flax_model()
    params = fm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 16, 1)))["params"]
    tm = ResUNet3D(filters=4, num_layers=2)
    back = torch_to_flax(flax_to_torch(params, tm), tm)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [jax.tree_util.keystr(p) for p, _ in flat_a] == \
        [jax.tree_util.keystr(p) for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_factory_leaf_count_matches():
    """The factory gen_IS at f=4: 97 flax leaves, 97 torch parameters, same
    names and shapes (dead conv biases left out on both sides)."""
    fm = jax_build_generator("resUnet", JaxConfig(gen_filters=4, compute_dtype="float32"))
    shapes = jax.eval_shape(lambda: fm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 32, 32, 32, 1))))["params"]
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    tm = build_generator("resUnet", VanGanConfig(gen_filters=4, compute_dtype="float32"))
    sd = flax_to_torch(params, tm)
    assert len(sd) == len(tm.state_dict()) == 97
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    load_flax_params(tm, params)


def test_seeded_init_is_deterministic():
    cfg = VanGanConfig(gen_filters=4)
    a = build_generator("resUnet", cfg, generator=torch.Generator().manual_seed(3))
    b = build_generator("resUnet", cfg, generator=torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb
        assert torch.equal(va, vb)
    assert a.dtype == torch.bfloat16  # the config's compute dtype


@pytest.mark.parametrize("kwargs", [{"upsample_mode": "deconv"},
                                    {"use_attention_gate": True}])
def test_unported_options_raise(kwargs):
    """The two options that raised before they were ported now build and
    match flax (atol 1e-4, as above); ``test_torch_generators.py`` also
    runs them in training and together."""
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, size=(2, 16, 16, 16, 1)).astype(np.float32)
    fm = FlaxResUNet3D(**{"upsample_mode": "simple", **kwargs}, dropout_type="none", filters=4,
                       num_layers=2, output_activation="tanh", layout="NXCYZ",
                       dtype=jnp.float32)
    params = fm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    want = np.asarray(fm.apply({"params": params}, jnp.asarray(x)))
    tm = ResUNet3D(filters=4, num_layers=2, **kwargs)
    load_flax_params(tm, params)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_other_generator_families_raise():
    """The other families build now, and run; only the V-Net's ``addnoise``
    still raises, naming ROADMAP."""
    from vangan_torch.models.vnet import VNet3D

    cfg = VanGanConfig(gen_filters=2, compute_dtype="float32")
    x = torch.zeros(1, 16, 16, 16, 1)
    for kind in ("resnet", "vnet"):
        for role in ("i2s", "s2i"):
            with torch.inference_mode():
                y = build_generator(kind, cfg, role=role)(x)
            assert y.shape == x.shape and bool(torch.isfinite(y).all())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        VNet3D(addnoise=True)


def test_config_defaults_match_jax_config():
    """The port's config is a copy of the JAX config's fields it reads."""
    ours, theirs = VanGanConfig(), JaxConfig()
    for f in ours.__dataclass_fields__:
        assert getattr(ours, f) == getattr(theirs, f), f
    assert ours.subvol_size[1:] == theirs.INPUT_IMG_SIZE[1:]
