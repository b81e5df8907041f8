"""The port's V-Net and its new building blocks against the flax package.

The flax side runs on its CPU path (the NXCYZ layout: XLA convs and the jnp
InstanceNorm), the port on its plain torch versions, from one flax variable
tree (params with perturbed 1-D leaves, and non-trivial ``batch_stats``)
mapped by ``weights.flax_to_torch``. Inputs are made with numpy from a seed.

The witness is flax in float64: the same flax module with JAX's 64-bit mode
on, its compute dtype float64 and its InstanceNorm's statistics in float64
(``flax_float64``: the flax InstanceNorm keeps its statistics in float32
whatever the input, so the test swaps in the same formula in float64). It
shares no code with the port. Tolerances:

- outputs: the port in float64 within atol 1e-6 of the witness (both cast
  to float32 before the tanh; measured <= 2.4e-7), the port in float32
  within atol 1e-4 of it (measured <= 5.6e-5), and within atol 2e-3 of
  flax in float32. Flax's own float32 run is up to 6.3e-4 from its float64
  one here, and 2.8e-1 at the factory's depth
  (``test_flax_float32_is_the_less_precise_side``): its float32
  InstanceNorm statistics are less precise than torch's (the variance of a
  4096-voxel plane 1.1e-5 off, relative), and the V-Net's norms of ReLU'd,
  low-variance planes amplify that;
- updated ``batch_stats``: rtol 1e-4 and atol 1e-6, against the witness and
  against flax in float32 (measured 1.3e-5 and 1.9e-5 relative). Flax
  computes E[x^2] - E[x]^2 (``use_fast_variance``);
- ``ConvTranspose``, ``BatchNorm`` and the attention gate alone, values and
  gradients: rtol 1e-5, atol 1e-6 (of the largest gradient, for the
  gradients; one layer, f32);
- ``max_pool_2x`` on tied windows: equal, values and gradients (a tied
  window's gradient goes to its first element in X, Y, Z order on both).
"""

import contextlib
import copy
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vangan_tpu.models.layers as jax_layers
from vangan_tpu.models.layers import AttentionGate as FlaxAttentionGate
from vangan_tpu.models.vnet import VNet3D as FlaxVNet3D
from vangan_tpu.models.vnet import max_pool_2x as jax_max_pool_2x
from vangan_torch.models.layers import AttentionGate, BatchNorm, ConvTranspose, max_pool_2x
from vangan_torch.models.vnet import VNet3D
from vangan_torch.weights import flax_to_torch, load_flax_params, torch_to_flax_variables

ATOL_F64, ATOL_F32, ATOL_JAX = 1e-6, 1e-4, 2e-3


def _instance_norm_f64(x, gamma, beta, *, eps=1e-3, act="none", alpha=0.2, layout="NXYZC",
                       dtype=None):
    """``vangan_tpu.models.layers.apply_instance_norm`` with its statistics
    and affine in float64, output in the input's dtype."""
    cax = jax_layers.channel_axis(layout) % x.ndim
    shape = [1] * x.ndim
    shape[cax] = x.shape[cax]
    axes = jax_layers.spatial_axes(layout, x.ndim)
    xd = x.astype(jnp.float64)
    xc = xd - jnp.mean(xd, axis=axes, keepdims=True)
    inv = jax.lax.rsqrt(jnp.mean(xc * xc, axis=axes, keepdims=True) + eps)
    y = xc * inv * gamma.astype(jnp.float64).reshape(shape) + \
        beta.astype(jnp.float64).reshape(shape)
    if act == "relu":
        y = jnp.maximum(y, 0.0)
    elif act == "leaky_relu":
        y = jnp.where(y >= 0, y, alpha * y)
    return y.astype(dtype or x.dtype)


@contextlib.contextmanager
def flax_float64():
    """JAX in 64-bit mode, with the flax InstanceNorm's statistics in float64."""
    with jax.enable_x64(True), mock.patch.object(jax_layers, "apply_instance_norm",
                                                 _instance_norm_f64):
        yield


def flax_float64_apply(fm, variables, x, train=False):
    """The witness: (output, updated ``batch_stats``) of the flax module
    ``fm`` computing in float64, as float64 numpy arrays."""
    with flax_float64():
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), dict(variables))
        out, updates = fm.clone(dtype=jnp.float64).apply(
            v64, jnp.asarray(x, jnp.float64), train=train, mutable=["batch_stats"])
        return (np.asarray(out, np.float64),
                jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                       dict(updates).get("batch_stats", {})))


def _port_float64(tm, x, train=False):
    t64 = copy.deepcopy(tm).double()
    t64.dtype = torch.float64
    with torch.no_grad():
        return t64(torch.from_numpy(x).double(), train, torch.Generator()).numpy()


def _assert_output(tm, x, want, want64, train=False):
    """The port (``tm`` on ``x``) in float32 and float64 against the witness
    ``want64`` and, in float32, against flax's float32 ``want`` (see the
    module note)."""
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train, torch.Generator()).numpy()
    assert got.shape == want.shape == want64.shape == x.shape
    np.testing.assert_allclose(_port_float64(tm, x, train), want64, atol=ATOL_F64, rtol=0)
    np.testing.assert_allclose(got, want64, atol=ATOL_F32, rtol=0)
    np.testing.assert_allclose(got, want, atol=ATOL_JAX, rtol=0)


def _roles(role, **kw):
    """The factory's per-role V-Net settings (models/factory.py), at f=4 with
    2 levels and no dropout."""
    i2s = role == "i2s"
    return {**dict(use_batch_norm=not i2s, upsample_mode="simple" if i2s else "deconv",
                   dropout=0.0, dropout_type="spatial", filters=8 if i2s else 4,
                   num_layers=2), **kw}


def _perturbed(tree, rng, scale=0.1):
    return jax.tree_util.tree_map(
        lambda p: p + scale * jnp.asarray(rng.normal(size=p.shape), p.dtype)
        if p.ndim == 1 else p, tree)


def _stats(tree, rng):
    """Non-trivial running statistics: mean ~ N(0, 0.1), var in [0.5, 1.5]."""
    return {k: _stats(v, rng) if isinstance(v, dict) else (
        jnp.asarray(rng.normal(size=v.shape) * 0.1, jnp.float32) if k == "mean"
        else jnp.asarray(rng.uniform(0.5, 1.5, size=v.shape), jnp.float32))
        for k, v in tree.items()}


def _models(role, rng, attention=False, shape=(2, 16, 16, 16, 1), **kw):
    kw = _roles(role, use_attention_gate=attention, **kw)
    fm = FlaxVNet3D(**kw, output_activation="tanh", layout="NXCYZ", dtype=jnp.float32)
    x = rng.uniform(-1, 1, size=shape).astype(np.float32)
    variables = dict(fm.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    variables["params"] = _perturbed(variables["params"], rng)
    if "batch_stats" in variables:
        variables["batch_stats"] = _stats(variables["batch_stats"], rng)
    tm = VNet3D(**kw)
    load_flax_params(tm, variables["params"], variables.get("batch_stats"))
    return fm, tm, variables, x


@pytest.mark.parametrize("attention", [False, True])
@pytest.mark.parametrize("role", ["i2s", "s2i"])
def test_vnet_eval_matches_flax(role, attention):
    rng = np.random.default_rng(0)
    fm, tm, variables, x = _models(role, rng, attention)
    _assert_output(tm, x, np.asarray(fm.apply(variables, jnp.asarray(x), train=False)),
                   flax_float64_apply(fm, variables, x)[0])


@pytest.mark.parametrize("role", ["i2s", "s2i"])
def test_vnet_train_matches_flax_with_batch_stats(role):
    """Train mode (batch statistics; dropout 0): the output, and the
    running statistics flax's ``mutable=["batch_stats"]`` returns."""
    rng = np.random.default_rng(1)
    fm, tm, variables, x = _models(role, rng)
    want, updates = fm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    want64, stats64 = flax_float64_apply(fm, variables, x, train=True)
    _assert_output(tm, x, np.asarray(want), want64, train=True)
    got_stats = torch_to_flax_variables(tm.state_dict(), tm).get("batch_stats", {})
    want_stats = jax.tree_util.tree_map(np.asarray, dict(updates).get("batch_stats", {}))
    assert (role == "s2i") == bool(want_stats)
    _assert_stats(got_stats, want_stats)
    _assert_stats(got_stats, stats64)
    # and they moved: the step's statistics differ from the stored ones
    before = torch_to_flax_variables(flax_to_torch(variables["params"], tm,
                                                   variables.get("batch_stats")), tm)
    moved = [not np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(before.get("batch_stats", {})),
        jax.tree_util.tree_leaves(got_stats))]
    assert all(moved)


def _leaves(tree):
    return {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_stats(got, want):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=1e-4, atol=1e-6, err_msg=key)


def test_vnet_eval_uses_the_running_statistics():
    """Without ``train`` the BatchNorm V-Net neither reads the batch's
    statistics nor moves its buffers: one sample gives the same output
    alone and within a batch."""
    rng = np.random.default_rng(2)
    _, tm, _, x = _models("s2i", rng)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    with torch.inference_mode():
        both = tm(torch.from_numpy(x))
        one = tm(torch.from_numpy(x[:1]))
    np.testing.assert_allclose(one.numpy(), both[:1].numpy(), atol=1e-5, rtol=0)
    assert all(torch.equal(before[k], v) for k, v in tm.state_dict().items())


def test_batchnorm_matches_flax_with_gradient():
    """One BatchNorm in training: output, the input and parameter gradients
    (jax.vjp), and the moved statistics."""
    rng = np.random.default_rng(3)
    x = np.maximum(rng.normal(0.3, 1.0, size=(2, 5, 6, 7, 8)), 0).astype(np.float32)
    gy = rng.normal(size=x.shape).astype(np.float32)
    fm = fnn.BatchNorm(use_running_average=False, axis=1, epsilon=1e-3)
    variables = fm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = _perturbed(variables["params"], rng, 0.5)
    stats = _stats(variables["batch_stats"], rng)

    def f(p, a):
        return fm.apply({"params": p, "batch_stats": stats}, a, mutable=["batch_stats"])

    y, pull = jax.vjp(lambda p, a: f(p, a)[0], params, jnp.asarray(x))
    _, upd = f(params, jnp.asarray(x))
    gp, gx = pull(jnp.asarray(gy))
    bn = BatchNorm(5)
    bn.load_state_dict(flax_to_torch(params, bn, stats))
    xt = torch.from_numpy(x).requires_grad_()
    out = bn(xt, train=True)
    out.backward(torch.from_numpy(gy))
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-5,
                               atol=1e-6 * float(np.abs(gx).max()))
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(gp["scale"]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(gp["bias"]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(upd["batch_stats"]["mean"]), **tol)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(upd["batch_stats"]["var"]), **tol)


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_conv_transpose_matches_flax(padding):
    """flax ``nn.ConvTranspose`` (k = s = 2) and the port's, from one kernel
    mapped with its spatial flip: values, and the input, kernel and bias
    gradients (the kernel's mapped back by ``torch_to_flax_variables``)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 6, 7, 3)).astype(np.float32)  # NXYZC
    fm = fnn.ConvTranspose(features=4, kernel_size=(2, 2, 2), strides=(2, 2, 2),
                           padding=padding)
    params = _perturbed(fm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    y, pull = jax.vjp(lambda p, a: fm.apply({"params": p}, a), params, jnp.asarray(x))
    gy = rng.normal(size=y.shape).astype(np.float32)
    gp, gx = pull(jnp.asarray(gy))
    tm = ConvTranspose(3, 4, 2, 2)
    tm.load_state_dict(flax_to_torch(params, tm))
    xt = torch.from_numpy(np.transpose(x, (0, 4, 1, 2, 3))).requires_grad_()
    out = tm(xt)
    out.backward(torch.from_numpy(np.transpose(gy, (0, 4, 1, 2, 3))))
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.transpose(out.detach().numpy(), (0, 2, 3, 4, 1)),
                               np.asarray(y), **tol)
    np.testing.assert_allclose(np.transpose(xt.grad.numpy(), (0, 2, 3, 4, 1)), np.asarray(gx),
                               rtol=1e-5, atol=1e-5)
    got = torch_to_flax_variables({"weight": tm.weight.grad, "bias": tm.bias.grad}, tm)
    for leaf in ("kernel", "bias"):
        want = np.asarray(gp[leaf])
        np.testing.assert_allclose(got["params"][leaf], want, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(want).max()), err_msg=leaf)


def test_conv_transpose_without_the_flip_differs():
    """The flip matters: mapped as a conv kernel (transpose only) the
    output is another function."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, 4, 4, 4, 2)).astype(np.float32)
    fm = fnn.ConvTranspose(features=3, kernel_size=(2, 2, 2), strides=(2, 2, 2),
                           padding="SAME")
    params = fm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = np.asarray(fm.apply({"params": params}, jnp.asarray(x)))
    tm = ConvTranspose(2, 3, 2, 2)
    flipped = flax_to_torch(params, tm)["weight"]
    unflipped = torch.from_numpy(np.transpose(np.asarray(params["kernel"]), (3, 4, 0, 1, 2)))
    xt = torch.from_numpy(np.transpose(x, (0, 4, 1, 2, 3)))
    for w, same in ((flipped, True), (unflipped, False)):
        with torch.no_grad():
            tm.weight.copy_(w)
            got = np.transpose(tm(xt).numpy(), (0, 2, 3, 4, 1))
        assert np.allclose(got, want, atol=1e-6) == same


def test_max_pool_ties_match_reduce_window():
    """ReLU'd data (most 2^3 windows all zeros, as after the V-Net's
    ReLU-then-norm): ``max_pool_2x`` and the JAX package's equal, and so
    are their gradients: each tied window's goes to one element, the same
    one on both sides."""
    rng = np.random.default_rng(6)
    x = np.maximum(rng.normal(-2.0, 1.0, size=(2, 3, 8, 8, 8)), 0).astype(np.float32)
    x[0, 0, :2, :2, :2] = 0.5  # one window of equal non-zero values
    x_j = np.transpose(x, (0, 2, 1, 3, 4))  # NXCYZ
    y, pull = jax.vjp(lambda a: jax_max_pool_2x(a, "NXCYZ"), jnp.asarray(x_j))
    gy = rng.normal(size=y.shape).astype(np.float32)
    (gx,) = pull(jnp.asarray(gy))
    xt = torch.from_numpy(x).requires_grad_()
    out = max_pool_2x(xt)
    out.backward(torch.from_numpy(np.transpose(gy, (0, 2, 1, 3, 4))))
    tied = (x.reshape(2, 3, 4, 2, 4, 2, 4, 2) == 0).all(axis=(3, 5, 7)).mean()
    assert tied > 0.5
    np.testing.assert_array_equal(np.transpose(out.detach().numpy(), (0, 2, 1, 3, 4)),
                                  np.asarray(y))
    np.testing.assert_array_equal(np.transpose(xt.grad.numpy(), (0, 2, 1, 3, 4)),
                                  np.asarray(gx))
    # the rule: the first element of a tied window in X, Y, Z order
    assert xt.grad[0, 0, 0, 0, 0] == float(gy[0, 0, 0, 0, 0]) and \
        float(xt.grad[0, 0, :2, :2, :2].abs().sum()) == abs(float(gy[0, 0, 0, 0, 0]))


def test_attention_gate_matches_flax():
    rng = np.random.default_rng(7)
    a = rng.normal(size=(2, 6, 3, 6, 6)).astype(np.float32)  # NXCYZ, 3 channels
    b = rng.normal(size=(2, 6, 5, 6, 6)).astype(np.float32)  # 5 channels
    fm = FlaxAttentionGate(4, layout="NXCYZ", dtype=jnp.float32)
    params = _perturbed(fm.init(jax.random.PRNGKey(0), jnp.asarray(a), jnp.asarray(b))["params"],
                        rng)
    want = np.asarray(fm.apply({"params": params}, jnp.asarray(a), jnp.asarray(b)))
    tm = AttentionGate(3, 5, 4)
    load_flax_params(tm, params)
    to_t = lambda v: torch.from_numpy(np.transpose(v, (0, 2, 1, 3, 4)))  # noqa: E731
    with torch.inference_mode():
        got = np.transpose(tm(to_t(a), to_t(b)).numpy(), (0, 2, 1, 3, 4))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_addnoise_raises_naming_roadmap():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        VNet3D(addnoise=True)


def test_flax_float32_is_the_less_precise_side():
    """Why flax in float32 is held at 2e-3 and the port at 1e-4 (and at the
    factory's depth not at all): the factory's i2s V-Net at f=2 (4 levels on
    32^3, its InstanceNorms on ReLU'd planes down to 2^3), the port's
    float32 output and flax's (its CPU path, NXCYZ), each against the
    witness, flax in float64 from the same parameters. The port's float64
    run agrees with the witness within 1e-6, its float32 run within 2e-3,
    and flax's float32 run is at least 10x further (measured 5.6e-4 and
    2.8e-1). Prints both distances."""
    from vangan_tpu.config import VanGanConfig as JaxConfig
    from vangan_tpu.models.factory import build_generator as jax_build_generator
    from vangan_torch.config import VanGanConfig
    from vangan_torch.models.factory import build_generator

    x = np.random.default_rng(8).uniform(-1, 1, size=(2, 32, 32, 32, 1)).astype(np.float32)
    fm = jax_build_generator("vnet", JaxConfig(gen_filters=2, compute_dtype="float32",
                                               layout="NXCYZ"), role="i2s")
    variables = fm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    flax_out = np.asarray(fm.apply(variables, jnp.asarray(x)))
    want64 = flax_float64_apply(fm, variables, x)[0]
    tm = load_flax_params(build_generator("vnet", VanGanConfig(gen_filters=2,
                                                               compute_dtype="float32"),
                                          role="i2s"), variables["params"])
    with torch.no_grad():
        port = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(_port_float64(tm, x), want64, atol=ATOL_F64, rtol=0)
    port_err, flax_err = np.abs(port - want64).max(), np.abs(flax_out - want64).max()
    print(f"max |float32 - flax float64|: port {port_err:.3e}, flax {flax_err:.3e}")
    assert port_err <= 2e-3 and flax_err >= 10 * port_err


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("role", ["i2s", "s2i"])
def test_vnet_at_the_factory_depth_matches_flax_float64(role, train):
    """The V-Net at the factory's depth (4 levels; gen_filters 2, so 4
    filters for i2s and 2 for s2i) on 32^3, perturbed parameters and
    statistics, no dropout: the port in float64 within 1e-6 of the witness,
    in float32 within 2e-3 (measured 5.6e-4), and the moved ``batch_stats``
    as ``test_vnet_train_matches_flax_with_batch_stats``. Flax in float32 is
    not compared here (see ``test_flax_float32_is_the_less_precise_side``)."""
    rng = np.random.default_rng(9)
    fm, tm, variables, x = _models(role, rng, shape=(2, 32, 32, 32, 1),
                                   filters=4 if role == "i2s" else 2, num_layers=4)
    want64, stats64 = flax_float64_apply(fm, variables, x, train=train)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train, torch.Generator()).numpy()
    np.testing.assert_allclose(_port_float64(tm, x, train), want64, atol=ATOL_F64, rtol=0)
    np.testing.assert_allclose(got, want64, atol=2e-3, rtol=0)
    if train and role == "s2i":
        _assert_stats(torch_to_flax_variables(tm.state_dict(), tm)["batch_stats"], stats64)
