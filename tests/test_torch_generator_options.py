"""The generators' options that no factory role sets, against the flax package.

``ResUNet3D``'s ``use_input_noise``, ``dropout_type``, ``dropout``,
``dropout_change_per_layer`` and ``output_activation``, and ``VNet3D``'s
``num_classes``, ``output_activation``, ``dropout_change_per_layer``,
``use_dropout_on_upsampling`` and ``addnoise``, at f=4 with 2 levels on
16^3, from one flax variable tree (perturbed 1-D leaves, non-trivial
``batch_stats``) mapped by ``weights.flax_to_torch``; the port on its plain
torch versions on the CPU. Forwards are compared where no draw differs:
in eval, or with the draw injected (the V-Net's eval noise: JAX's own
``normal(PRNGKey(0), shape)``, through ``VNet3D.standard_normal``). Each
training draw (the input noise, each dropout mask) is tested alone against
the same draws replayed from the call's generator, and the dropout rates of
every block against the rates flax's modules are built with.

Tolerances, ``test_torch_vnet.py``'s: the port in float32 within atol 2e-3
of flax in float32, and in float64 within atol 1e-6 of the float64 witness
(``test_torch_vnet.flax_float64``); a replayed draw exactly.
"""

import copy
import hashlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_vnet import _perturbed, _stats, flax_float64, flax_float64_apply

import vangan_tpu.models.vnet as jax_vnet
from vangan_tpu.models.resunet import ResUNet3D as FlaxResUNet3D
from vangan_tpu.models.vnet import VNet3D as FlaxVNet3D
from vangan_torch.config import VanGanConfig
from vangan_torch.models.factory import build_generator
from vangan_torch.models.layers import ResUNetResidualBlock
from vangan_torch.models.resunet import ResUNet3D
from vangan_torch.models.vnet import VNet3D
from vangan_torch.weights import flax_to_torch, load_flax_params, torch_to_flax_variables

ATOL_F64, ATOL_JAX = 1e-6, 2e-3
SHAPE = (2, 16, 16, 16, 1)


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(fm, tm, rng, stats=False):
    x = rng.uniform(-1, 1, size=SHAPE).astype(np.float32)
    variables = dict(fm.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    variables["params"] = _perturbed(variables["params"], rng)
    if stats and "batch_stats" in variables:
        variables["batch_stats"] = _stats(variables["batch_stats"], rng)
    load_flax_params(tm, variables["params"], variables.get("batch_stats"))
    return variables, x


def _port(tm, x, dtype=torch.float32):
    t = copy.deepcopy(tm).to(dtype)
    t.dtype = dtype
    with torch.no_grad():
        return t(torch.from_numpy(x).to(dtype)).numpy()


def _assert_eval(fm, tm, variables, x):
    """The port's eval forward in float32 against flax's, in float64 against
    the witness."""
    want = np.asarray(fm.apply(variables, jnp.asarray(x)))
    want64 = flax_float64_apply(fm, variables, x)[0]
    got = _port(tm, x)
    assert got.shape == want.shape == want64.shape
    np.testing.assert_allclose(got, want, atol=ATOL_JAX, rtol=0)
    np.testing.assert_allclose(_port(tm, x, torch.float64), want64, atol=ATOL_F64, rtol=0)
    return got


RESUNET_OPTIONS = [
    {"output_activation": "sigmoid"},
    {"output_activation": None},
    {"use_input_noise": True},
    {"dropout_type": "spatial", "dropout": 0.3, "dropout_change_per_layer": 0.1},
    {"dropout_type": "standard", "dropout": 0.2, "upsample_mode": "deconv"},
]


@pytest.mark.parametrize("option", RESUNET_OPTIONS)
def test_resunet_options_match_flax_in_eval(option):
    kw = {"upsample_mode": "simple", **option}
    fm = FlaxResUNet3D(filters=4, num_layers=2, layout="NXCYZ", dtype=jnp.float32, **kw)
    tm = ResUNet3D(filters=4, num_layers=2, **kw)
    variables, x = _load(fm, tm, np.random.default_rng(0))
    _assert_eval(fm, tm, variables, x)


def test_resunet_input_noise_is_the_call_generators_draw():
    """In training: flax's network without the noise on ``x + 0.2 N``, N the
    call generator's ``randn`` of the input's shape."""
    kw = dict(upsample_mode="simple", filters=4, num_layers=2)
    fm = FlaxResUNet3D(layout="NXCYZ", dtype=jnp.float32, **kw)
    tm = ResUNet3D(use_input_noise=True, **kw)
    variables, x = _load(fm, tm, np.random.default_rng(1))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), True, torch.Generator().manual_seed(5)).numpy()
    noise = torch.randn(SHAPE, generator=torch.Generator().manual_seed(5)).numpy()
    want = np.asarray(fm.apply(variables, jnp.asarray(x + 0.2 * noise)))
    np.testing.assert_allclose(got, want, atol=ATOL_JAX, rtol=0)
    with torch.no_grad():
        assert not np.allclose(tm(torch.from_numpy(x)).numpy(), got, atol=1e-3)


def test_resunet_encoder_dropout_rates_follow_flax():
    """Encoder block e drops at ``dropout + (e - 1) change`` (resunet.py:67-76),
    the decoder blocks not at all."""
    tm = ResUNet3D(filters=4, num_layers=3, dropout_type="spatial", dropout=0.1,
                   dropout_change_per_layer=0.15)
    for e, want in ((1, 0.1), (2, 0.25), (3, 0.4)):
        assert getattr(tm, f"enc{e}").dropout.keywords["rate"] == pytest.approx(want)
    assert all(getattr(tm, f"dec{d}").dropout is None for d in range(3))
    assert all(getattr(ResUNet3D(filters=4, num_layers=3), f"enc{e}").dropout is None
               for e in (1, 2, 3))


@pytest.mark.parametrize("dropout_type", ["spatial", "standard"])
def test_residual_block_dropout_mask(dropout_type):
    """A block in training: its eval output times the replayed keep mask /
    (1 - rate), the mask over (B, C) for spatial dropout, per element for
    standard (flax ``nn.Dropout`` with and without broadcast dims)."""
    torch.manual_seed(0)
    block = ResUNetResidualBlock(2, 4, strides=2, dropout_type=dropout_type, dropout=0.4)
    x = torch.randn(2, 2, 8, 8, 8)
    with torch.no_grad():
        ref = block(x)
        got = block(x, True, torch.Generator().manual_seed(3))
    shape = (2, 4, 1, 1, 1) if dropout_type == "spatial" else ref.shape
    keep = torch.rand(shape, generator=torch.Generator().manual_seed(3)) < 0.6
    torch.testing.assert_close(got, torch.where(keep, ref / 0.6, torch.zeros(())), rtol=0,
                               atol=0)
    assert 0 < int(keep.sum()) < keep.numel()


def test_output_activation_and_dropout_type_raise_on_unknown_names():
    with pytest.raises(ValueError, match="output activation"):
        ResUNet3D(filters=2, num_layers=1, output_activation="relu")
    with pytest.raises(ValueError, match="output activation"):
        VNet3D(filters=2, num_layers=1, output_activation="softmax")
    with pytest.raises(ValueError, match="dropout_type"):
        ResUNet3D(filters=2, num_layers=1, dropout_type="gaussian")


def _vnet_kw(role, **kw):
    i2s = role == "i2s"
    return {**dict(use_batch_norm=not i2s, upsample_mode="simple" if i2s else "deconv",
                   dropout=0.0, dropout_type="spatial", filters=8 if i2s else 4,
                   num_layers=2), **kw}


VNET_OPTIONS = [
    {"num_classes": 2, "output_activation": "sigmoid"},
    {"num_classes": 3, "output_activation": None},
    {"output_activation": "tanh", "dropout": 0.2, "dropout_change_per_layer": 0.1,
     "use_dropout_on_upsampling": True},
]


@pytest.mark.parametrize("role", ["i2s", "s2i"])
@pytest.mark.parametrize("option", VNET_OPTIONS)
def test_vnet_options_match_flax_in_eval(role, option):
    kw = _vnet_kw(role, **option)
    fm = FlaxVNet3D(**kw, layout="NXCYZ", dtype=jnp.float32)
    tm = VNet3D(**kw)
    variables, x = _load(fm, tm, np.random.default_rng(2), stats=True)
    got = _assert_eval(fm, tm, variables, x)
    assert got.shape == (*SHAPE[:-1], kw.get("num_classes", 1))


def test_vnet_default_activation_is_sigmoid_as_flax():
    fm = FlaxVNet3D(**_vnet_kw("s2i"), layout="NXCYZ", dtype=jnp.float32)
    tm = VNet3D(**_vnet_kw("s2i"))
    variables, x = _load(fm, tm, np.random.default_rng(3), stats=True)
    got = _assert_eval(fm, tm, variables, x)
    assert got.min() >= 0.0 and got.max() <= 1.0


@pytest.mark.parametrize("upsampling", [False, True])
def test_vnet_dropout_rates_follow_flax(upsampling):
    """Every block's dropout rate, in block order, as flax's modules are
    built with (``make_dropout`` recorded through one training apply): the
    encoder's grow by the change, the bottleneck's is the last, and the
    decoder's start from it and drop by the change before each up block, or
    are 0 (vnet.py:137-149)."""
    kw = _vnet_kw("s2i", num_layers=3, dropout=0.2, dropout_change_per_layer=0.1,
                  use_dropout_on_upsampling=upsampling)
    rates = []
    real = jax_vnet.make_dropout

    def record(dropout_type, rate, **k):
        rates.append(rate)
        return real(dropout_type, rate, **k)

    fm = FlaxVNet3D(**kw, layout="NXCYZ", dtype=jnp.float32)
    x = jnp.zeros((1, 16, 16, 16, 1))
    variables = fm.init(jax.random.PRNGKey(0), x)
    with mock.patch.object(jax_vnet, "make_dropout", record):
        fm.apply(variables, x, train=True, mutable=["batch_stats"],
                 rngs={"dropout": jax.random.PRNGKey(1)})
    tm = VNet3D(**kw)
    blocks = [f"down{i}" for i in range(3)] + ["bottleneck"] + [f"up{i}" for i in range(3)]
    got = [getattr(tm, b).dropout.keywords["rate"] for b in blocks
           if getattr(tm, b).dropout is not None]
    assert len(got) == len(rates) == (7 if upsampling else 4)
    np.testing.assert_allclose(got, rates, rtol=1e-6)


def _jax_normal(shape, dtype):
    return np.array(jax.random.normal(jax.random.PRNGKey(0), shape, dtype))


@pytest.mark.parametrize("role", ["i2s", "s2i"])
def test_vnet_addnoise_matches_flax_with_its_eval_noise(role):
    """The noise branch in eval, given JAX's own eval draw
    (``normal(PRNGKey(0), shape)``, in float32 for flax and in float64 for the
    witness)."""
    kw = _vnet_kw(role, addnoise=True, output_activation="tanh")
    fm = FlaxVNet3D(**kw, layout="NXCYZ", dtype=jnp.float32)
    tm = VNet3D(**kw)
    variables, x = _load(fm, tm, np.random.default_rng(4), stats=True)
    want = np.asarray(fm.apply(variables, jnp.asarray(x)))
    with flax_float64():
        n64 = _jax_normal(SHAPE, jnp.float64)
    want64 = flax_float64_apply(fm, variables, x)[0]
    for dtype, noise, ref, atol in ((torch.float32, _jax_normal(SHAPE, jnp.float32), want,
                                     ATOL_JAX), (torch.float64, n64, want64, ATOL_F64)):
        inject = lambda self, t, train, generator, n=noise: torch.from_numpy(n).to(t.dtype)  # noqa: E731
        with mock.patch.object(VNet3D, "standard_normal", inject):
            np.testing.assert_allclose(_port(tm, x, dtype), ref, atol=atol, rtol=0)


def test_vnet_addnoise_draws():
    """Training draws from the call's generator; eval draws one fixed tensor
    per shape, from a generator seeded 0 (JAX: ``PRNGKey(0)``)."""
    tm = VNet3D(filters=2, num_layers=1, addnoise=True)
    x = torch.rand(1, 8, 8, 8, 1)
    got = tm.standard_normal(x, True, torch.Generator().manual_seed(9))
    torch.testing.assert_close(got, torch.randn(x.shape,
                                                generator=torch.Generator().manual_seed(9)))
    fixed = torch.randn(x.shape, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(tm.standard_normal(x, False, None), fixed)
    torch.testing.assert_close(tm.standard_normal(x, False, torch.Generator()), fixed)
    with pytest.raises(ValueError, match="generator"):
        tm.standard_normal(x, True, None)
    with torch.no_grad():
        y_train = tm(x, True, torch.Generator().manual_seed(9))
        assert torch.equal(tm(x), tm(x)) and not torch.equal(tm(x), y_train)


def test_vnet_num_classes_weight_map_round_trips():
    fm = FlaxVNet3D(**_vnet_kw("s2i", num_classes=2), layout="NXCYZ", dtype=jnp.float32)
    tm = VNet3D(**_vnet_kw("s2i", num_classes=2))
    variables, _ = _load(fm, tm, np.random.default_rng(5), stats=True)
    assert tuple(tm.head.weight.shape[:2]) == (2, 4)
    back = torch_to_flax_variables(flax_to_torch(variables["params"], tm,
                                                 variables["batch_stats"]), tm)
    for tree in ("params", "batch_stats"):
        want = jax.tree_util.tree_leaves_with_path(variables[tree])
        got = dict(jax.tree_util.tree_leaves_with_path(back[tree]))
        assert len(got) == len(want)
        for path, w in want:
            np.testing.assert_array_equal(got[path], np.asarray(w))


# sha256 of the factory's state_dict names and shapes (gen_filters 4), as the
# parent of these options built them: the factory sets every option
# explicitly, so its networks did not change
FACTORY_DIGESTS = {
    (3, "resUnet"): ("4fe4a9672c5c7cf7", "4fe4a9672c5c7cf7"),
    (3, "vnet"): ("edeff1748296b951", "3c78f9a0daac5a12"),
    (3, "resnet"): ("18b038978765a215", "18b038978765a215"),
    (2, "resUnet"): ("e38fbc14fbaec31d", "e38fbc14fbaec31d"),
    (2, "vnet"): ("4f2b7bbcd23d776c", "c8794ac3d2c085a6"),
    (2, "resnet"): ("53ab5dcf1c1d725e", "53ab5dcf1c1d725e"),
}


@pytest.mark.parametrize("dims,kind", sorted(FACTORY_DIGESTS))
def test_factory_networks_keep_their_names_and_shapes(dims, kind):
    cfg = VanGanConfig(gen_filters=4, DIMENSIONS=dims, SUBVOL_PATCH_SIZE=(32, 32, 32))
    for role, want in zip(("i2s", "s2i"), FACTORY_DIGESTS[dims, kind]):
        m = build_generator(kind, cfg, role=role)
        items = [f"{n}:{tuple(t.shape)}" for n, t in m.state_dict().items()]
        assert hashlib.sha256("\n".join(items).encode()).hexdigest()[:16] == want, (kind, role)
