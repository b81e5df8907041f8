"""The port's 2-D networks (``dims=2``, the DIMENSIONS=2 mode: depth-1
volumes inside) against the flax package's, which infers the rank from its
(B, H, W, C) input and runs channels-last (NXYZC, its XLA path).

Both run on the CPU from one flax variable tree (perturbed 1-D leaves;
non-trivial ``batch_stats`` for the s2i V-Net) mapped by ``weights.py``.
Tolerances as the 3-D tests of the same modules: generators as
``test_torch_vnet.py`` and ``test_torch_generators.py`` (the port in float64
within atol 1e-6 and in float32 within atol 1e-4 of flax in float64, the
witness ``test_torch_vnet.flax_float64_apply``; in float32 within atol 2e-3
of flax in float32; moved ``batch_stats`` rtol 1e-4, atol 1e-6); the
PatchGAN's logits atol 1e-4 (``test_torch_discriminator.py``); the
Wasserstein critic within 1e-5 * max |JAX| (``test_torch_wgan.py``); the
weight maps exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_vnet import _assert_output, _assert_stats, _perturbed, _stats, flax_float64_apply

from vangan_tpu.config import VanGanConfig as JaxConfig
from vangan_tpu.models.discriminator import PatchGANDiscriminator3D as FlaxDisc
from vangan_tpu.models.factory import build_discriminator as jax_build_discriminator
from vangan_tpu.models.factory import build_generator as jax_build_generator
from vangan_tpu.models.resnet_generator import ResNetGenerator3D as FlaxResNet
from vangan_tpu.models.resunet import ResUNet3D as FlaxResUNet3D
from vangan_tpu.models.vnet import VNet3D as FlaxVNet3D
from vangan_torch.config import VanGanConfig
from vangan_torch.models.discriminator import PatchGANDiscriminator3D, head_dims
from vangan_torch.models.factory import build_discriminator, build_generator
from vangan_torch.models.layers import ConvND, ConvTranspose, spatial_dropout
from vangan_torch.models.resnet_generator import ResNetGenerator3D
from vangan_torch.models.resunet import ResUNet3D
from vangan_torch.models.vnet import VNet3D
from vangan_torch.weights import flax_to_torch, load_flax_params, torch_to_flax_variables

SHAPE = (2, 16, 16, 1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(kind, option):
    """(flax module, port module) of one 2-D generator at f=4, 2 levels."""
    if kind == "resUnet":
        kw = {"upsample_mode": "simple", **option}
        return (FlaxResUNet3D(dropout_type="none", filters=4, num_layers=2,
                              output_activation="tanh", layout="NXYZC", dtype=jnp.float32, **kw),
                ResUNet3D(filters=4, num_layers=2, dims=2, **kw))
    if kind == "vnet":
        i2s = option["role"] == "i2s"
        kw = dict(use_batch_norm=not i2s, upsample_mode="simple" if i2s else "deconv",
                  dropout=0.0, dropout_type="spatial", filters=8 if i2s else 4, num_layers=2,
                  use_attention_gate=option.get("attention", False))
        return (FlaxVNet3D(**kw, output_activation="tanh", layout="NXYZC", dtype=jnp.float32),
                VNet3D(**kw, output_activation="tanh", dims=2))
    kw = dict(filters=4, num_downsampling_blocks=2, num_residual_blocks=2,
              num_upsample_blocks=2, stem_dropout=0.0, downsample_dropout=0.0)
    return FlaxResNet(**kw, layout="NXYZC", dtype=jnp.float32), ResNetGenerator3D(**kw, dims=2)


GENERATORS = [("resUnet", {}), ("resUnet", {"upsample_mode": "deconv"}),
              ("resUnet", {"use_attention_gate": True}),
              ("vnet", {"role": "i2s"}), ("vnet", {"role": "s2i"}),
              ("vnet", {"role": "s2i", "attention": True}), ("resnet", {})]


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("kind,option", GENERATORS)
def test_generator_2d_matches_flax(kind, option, train):
    """Each generator on (B, H, W, 1) images, eval and train (batch
    statistics, no dropout); the s2i V-Net's moved ``batch_stats`` too."""
    rng = np.random.default_rng(0)
    fm, tm = _pair(kind, option)
    x = rng.uniform(-1, 1, size=SHAPE).astype(np.float32)
    variables = dict(fm.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    variables["params"] = _perturbed(variables["params"], rng)
    if "batch_stats" in variables:
        variables["batch_stats"] = _stats(variables["batch_stats"], rng)
    load_flax_params(tm, variables["params"], variables.get("batch_stats"))
    want, updates = fm.apply(variables, jnp.asarray(x), train=train, mutable=["batch_stats"])
    want64, stats64 = flax_float64_apply(fm, variables, x, train)
    _assert_output(tm, x, np.asarray(want), want64, train=train)
    if train and "batch_stats" in variables:
        got_stats = torch_to_flax_variables(tm.state_dict(), tm)["batch_stats"]
        _assert_stats(got_stats, jax.tree_util.tree_map(np.asarray, updates["batch_stats"]))
        _assert_stats(got_stats, stats64)


@pytest.mark.parametrize("role", ["i2s", "s2i"])
@pytest.mark.parametrize("kind", ["resUnet", "vnet", "resnet"])
def test_factory_2d_names_and_shapes_match(kind, role):
    """Every kind x role of the factory with DIMENSIONS: 2 at f=4: flax's
    (kh, kw, Ci, Co) kernels as (Co, Ci, 1, kh, kw) weights (transposed
    convs (Ci, Co, 1, kh, kw)), the same names, and back exactly."""
    fm = jax_build_generator(kind, JaxConfig(gen_filters=4, compute_dtype="float32",
                                             DIMENSIONS=2), role=role)
    variables = jax.eval_shape(lambda: fm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1))))
    rng = np.random.default_rng(1)
    rand = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda s: rng.normal(size=s.shape).astype(np.float32), tree)
    params = rand(variables["params"])
    stats = rand(variables["batch_stats"]) if "batch_stats" in variables else None
    tm = build_generator(kind, VanGanConfig(gen_filters=4, compute_dtype="float32",
                                            DIMENSIONS=2), role=role)
    assert tm.dims == 2
    sd = flax_to_torch(params, tm, stats)
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    for name, m in tm.named_modules():
        if isinstance(m, (ConvND, ConvTranspose)):
            assert m.weight.shape[2] == 1 and m.strides[0] == 1, name
    load_flax_params(tm, params, stats)
    back = torch_to_flax_variables(tm.state_dict(), tm)
    for tree, want in (("params", params), ("batch_stats", stats)):
        if want is None:
            continue
        got = jax.tree_util.tree_leaves_with_path(back[tree])
        ref = jax.tree_util.tree_leaves_with_path(want)
        assert [jax.tree_util.keystr(p) for p, _ in got] == \
            [jax.tree_util.keystr(p) for p, _ in ref]
        for (_, a), (_, b) in zip(got, ref):
            assert np.array_equal(a, b)


def test_patchgan_2d_matches_flax():
    """The LSGAN PatchGAN on (B, H, W, 1): 4x4 convs, 3 stride-2 levels."""
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, size=(2, 32, 32, 1)).astype(np.float32)
    stochastic = dict(use_dropout=True, use_input_noise=True, use_layer_noise=True)
    fm = FlaxDisc(filters=8, layout="NXYZC", dtype=jnp.float32, **stochastic)
    params = _perturbed(fm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"], rng)
    want = np.asarray(fm.apply({"params": params}, jnp.asarray(x), train=False))
    tm = load_flax_params(PatchGANDiscriminator3D(filters=8, dims=2, **stochastic), params)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 4, 4, 1)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("patch", [(16, 16, 16), (16, 24, 8)])
def test_wasserstein_head_2d_is_sized_by_the_image(patch):
    """The critic's ``w_dense`` width comes from SUBVOL_PATCH_SIZE[:2] in
    2-D (not [:3]); the factory's critic against flax's, eval."""
    cfg_kw = dict(DIMENSIONS=2, SUBVOL_PATCH_SIZE=patch, disc_filters=8, wasserstein=True,
                  compute_dtype="float32")
    tm = build_discriminator(VanGanConfig(**cfg_kw))
    width = int(np.prod(head_dims(patch, 3, 2)))
    assert tm.w_dense.weight.shape == (1, width) and width == (patch[0] // 8) * (patch[1] // 8)
    fm = jax_build_discriminator(JaxConfig(**cfg_kw))
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, size=(2, *patch[:2], 1)).astype(np.float32)
    params = _perturbed(fm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"], rng)
    assert params["w_dense"]["kernel"].shape == (width, 1)
    want = np.asarray(fm.apply({"params": params}, jnp.asarray(x), train=False))
    load_flax_params(tm, params)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_spatial_dropout_2d_drops_whole_channels():
    """On a depth-1 volume a dropped (b, c) channel is its whole H x W
    plane, as flax's dropout broadcast over (H, W)."""
    x = torch.ones(3, 6, 1, 5, 7)
    y = spatial_dropout(x, 0.5, train=True, generator=torch.Generator().manual_seed(0))
    per_channel = y.reshape(3, 6, -1)
    assert torch.all(per_channel == per_channel[..., :1])
    assert set(per_channel[..., 0].unique().tolist()) == {0.0, 2.0}


def test_2d_models_refuse_volumes():
    tm = ResUNet3D(filters=2, num_layers=1, dims=2)
    with pytest.raises(ValueError, match=r"\(B, H, W, 1\)"):
        tm(torch.zeros(1, 8, 8, 8, 1))
    with pytest.raises(ValueError, match=r"\(B, X, Y, Z, 1\)"):
        ResUNet3D(filters=2, num_layers=1)(torch.zeros(1, 8, 8, 1))
