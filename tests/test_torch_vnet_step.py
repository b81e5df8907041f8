"""BASELINE config 4's train and test steps in the port against the JAX
package's: V-Net generators (the i2s role with InstanceNorm, the s2i role
with BatchNorm and deconvs) and PatchGAN discriminators.

At ``test_train_step.tiny_cfg`` (batch 2, 16^3, clDice with 2 iterations),
float32 on the CPU, where every op of the port takes its plain version. The
generators are the factory's roles at f=4 (the i2s V-Net 8 filters) with 2
levels and no dropout, the discriminators f=8 without noise or dropout
(their random draws differ between the frameworks); the flax NXCYZ layout
for the generators. The port loads the JAX init with its 1-D leaves
perturbed and non-trivial ``batch_stats``, through ``weights.py``.
Two references: JAX's float32 step, and a float64 witness, the same step
with JAX's 64-bit mode on, both generators computing in float64 and every
InstanceNorm's statistics in float64 (``test_torch_vnet.flax_float64``).
Tolerances, by ``test_torch_train_step.py``'s float32-conditioning argument
(ROADMAP.md Queue 3):

- the four restricted gradients of one backward: each network's flat
  gradient no further from JAX's float32 one (relative L2) than a 1e-5
  relative weight perturbation moves the port's own, and within 2e-2 (the
  test prints both); each leaf within 3x that spread
  (``chip_smoke.py``'s ``SPREAD_FACTOR``) plus 1e-5 * max |g| of the
  network over the leaf's size. Against the witness, gen_SI, disc_I and
  disc_S within 1e-4 relative L2 (measured 1.8e-5, 1.6e-6, 1.2e-5; against
  JAX's float32 step gen_SI is 1.2e-2 away, from flax's float32
  InstanceNorm statistics) and each leaf within 1x the spread; gen_IS by
  the float32 rule above (measured 1.2e-2 from the witness, 1.7e-2 its own
  spread): its seg-cycle BCE gradient is set by float32 ulps of its
  saturated tanh output (``test_gen_IS_cycle_gradient_is_set_at_float32_resolution``);
- ``gen_SI``'s ``batch_stats`` after the step (moved twice, on ``real_S``
  and on the detached ``fake_S``), with ``update_gen`` True and False:
  rtol 1e-4, atol 1e-6 (as ``test_torch_vnet.py``), against both;
- the ten losses: rtol 1e-3 in training, and in the test step, which
  normalises by the running averages.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_vnet import _roles, _stats, flax_float64
from test_train_step import make_batch, tiny_cfg, tiny_models

from vangan_tpu.models.vnet import VNet3D as FlaxVNet3D
from vangan_tpu.training.step import make_step_fns
from vangan_torch.config import VanGanConfig
from vangan_torch.models.discriminator import PatchGANDiscriminator3D
from vangan_torch.models.vnet import VNet3D
from vangan_torch.training import step as torch_step
from vangan_torch.training.state import NETWORKS
from vangan_torch.training.step import RESULT_KEYS
from vangan_torch.vangan import VanGan
from vangan_torch.weights import load_flax_networks, torch_to_flax, torch_to_flax_variables

STEPS_PER_EPOCH = 3


def _jax_models(dtype=jnp.float32):
    models = tiny_models(deterministic=True)
    for name, role in (("gen_IS", "i2s"), ("gen_SI", "s2i")):
        models[name] = FlaxVNet3D(**_roles(role), output_activation="tanh", layout="NXCYZ",
                                  dtype=dtype)
    return models


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_run(witness=False):
    """(config, params, model_state, real_I, real_S, grads, losses of the
    train forward, model_state after it, test-step losses), once per module;
    with ``witness``, from the float64 witness (the same parameters and
    batch, host arrays as float32)."""
    if witness:
        with flax_float64():
            return jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float32) if np.asarray(a).dtype == np.float64 else a,
                _jax_step(_jax_models(jnp.float64)))
    return _jax_step(_jax_models())


def _jax_step(models):
    jax_cfg = tiny_cfg()
    rng = np.random.default_rng(0)
    fns = make_step_fns(jax_cfg, models, steps_per_epoch=STEPS_PER_EPOCH)
    state = fns.init(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(
        lambda p: p + 0.1 * jnp.asarray(rng.normal(size=p.shape), p.dtype)
        if p.ndim == 1 else p, state.params)
    model_state = dict(state.model_state)
    model_state["gen_SI"] = {"batch_stats": _stats(model_state["gen_SI"]["batch_stats"], rng)}
    state = state.replace(params=params, model_state=model_state)
    real_I, real_S = make_batch(rng, jax_cfg)
    grads, (result, new_ms) = jax.grad(fns.compute_losses, argnums=0, has_aux=True)(
        params, model_state, real_I, real_S, jax.random.PRNGKey(7), jnp.zeros(()), True, None)
    test = fns.test_step(state, real_I, real_S, jax.random.PRNGKey(8))
    return (jax_cfg, _host(params), _host(model_state), np.array(real_I), np.array(real_S),
            _host(grads), {k: float(v) for k, v in result.items()}, _host(new_ms),
            {k: float(v) for k, v in test.items()})


def _gan(perturb=0.0):
    jax_cfg, params, model_state, *_ = _jax_run()
    cfg = VanGanConfig(N_DEVICES=jax_cfg.N_DEVICES, BATCH_SIZE=jax_cfg.BATCH_SIZE,
                       SUBVOL_PATCH_SIZE=jax_cfg.SUBVOL_PATCH_SIZE, compute_dtype="float32",
                       cldice_iters=jax_cfg.cldice_iters, EPOCHS=jax_cfg.EPOCHS,
                       cycle_loss_I_type=jax_cfg.cycle_loss_I_type,
                       lambda_topology=jax_cfg.lambda_topology, gen_i2s="vnet", gen_s2i="vnet")
    disc = dict(filters=8, use_dropout=False, use_input_noise=False, use_layer_noise=False)
    models = {"gen_IS": VNet3D(**_roles("i2s")), "gen_SI": VNet3D(**_roles("s2i")),
              "disc_I": PatchGANDiscriminator3D(**disc), "disc_S": PatchGANDiscriminator3D(**disc)}
    gan = VanGan(cfg, device="cpu", models=models, steps_per_epoch=STEPS_PER_EPOCH)
    load_flax_networks(gan, params, model_state)
    if perturb:
        g = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for net in gan.nets.values():
                for p in net.parameters():
                    p.mul_(1 + perturb * torch.randn(p.shape, generator=g))
    return gan


def _grads(gan):
    _, _, _, real_I, real_S, *_ = _jax_run()
    return torch_step.compute_grads(gan.nets, gan.cfg, gan.scales, torch.from_numpy(real_I),
                                    torch.from_numpy(real_S), 0.0, gan.generator)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _as_flax(net, tensors):
    return _leaves(torch_to_flax(dict(zip((n for n, _ in net.named_parameters()), tensors)),
                                 net))


@pytest.fixture(scope="module")
def port():
    gan = _gan()
    grads, result = _grads(gan)
    return gan, grads, result


@pytest.fixture(scope="module")
def perturbed():
    return _grads(_gan(perturb=1e-5))[0]


def _assert_grads(port, perturbed, name, witness):
    """The rules of the module note for one network against JAX's float32
    step or, with ``witness``, the float64 witness."""
    gan, grads, _ = port
    net = gan.nets[name]
    got, spread = _as_flax(net, grads[name]), _as_flax(net, perturbed[name])
    want = _leaves(_jax_run(witness)[5][name])
    assert sorted(got) == sorted(want)
    atol = 1e-5 * max(np.abs(w).max() for w in want.values())
    flat = lambda d: np.concatenate([d[k].ravel() for k in sorted(want)])  # noqa: E731
    gap = np.linalg.norm(flat(got) - flat(want))
    own = np.linalg.norm(flat(got) - flat(spread))
    print(f"{name}: relative L2 to {'the witness' if witness else 'JAX'} "
          f"{gap / np.linalg.norm(flat(want)):.3e}, "
          f"the port's own spread {own / np.linalg.norm(flat(want)):.3e}")
    tight = witness and name != "gen_IS"
    assert gap <= min((1e-4 if tight else 2e-2) * np.linalg.norm(flat(want)), own)
    for key, w in want.items():
        gap = np.linalg.norm(got[key] - w)
        factor = 1 if tight else 3
        assert gap <= factor * np.linalg.norm(got[key] - spread[key]) + \
            atol * np.sqrt(w.size), key


@pytest.mark.parametrize("name", NETWORKS)
def test_one_backward_matches_jax_grad(port, perturbed, name):
    _assert_grads(port, perturbed, name, witness=False)


@pytest.mark.parametrize("name", NETWORKS)
def test_one_backward_matches_the_float64_witness(port, perturbed, name):
    """The witness starts from the same parameters and batch."""
    for i in (1, 2, 3, 4):
        for a, b in zip(jax.tree_util.tree_leaves(_jax_run()[i]),
                        jax.tree_util.tree_leaves(_jax_run(True)[i])):
            assert np.array_equal(a, b)
    _assert_grads(port, perturbed, name, witness=True)


def test_gen_IS_cycle_gradient_is_set_at_float32_resolution(port):
    """Why gen_IS's gradient is held by the float32 rule even against the
    witness: the seg cycle's BCE (``cycle_loss_I_type`` 'bce') takes
    probabilities p, min-max normalised from gen_IS's tanh output, and its
    gradient 1/p or 1/(1 - p) is carried by the few voxels closest to the
    wrong end. At least half of sum |dBCE/dp| comes from voxels within 1e-5
    of it (measured 0.44% of the voxels, 85% of the sum), where one float32
    ulp of an output near +-1 is 0.3% or more of that distance."""
    gan, _, _ = port
    _, _, _, real_I, real_S, *_ = _jax_run()
    with torch.no_grad():
        fake_I = gan.nets["gen_SI"](torch.from_numpy(real_S), True, torch.Generator())
        cycled_S = gan.nets["gen_IS"](fake_I, True, torch.Generator()).double().numpy()
    axes = (1, 2, 3, 4)
    norm = lambda a: (a - a.min(axis=axes, keepdims=True)) / np.ptp(  # noqa: E731
        a, axis=axes, keepdims=True)
    p, y = norm(cycled_S), norm(real_S.astype(np.float64))
    dist = np.where(y > 0.5, p, 1 - p)
    unclipped = (p > 1e-7) & (p < 1 - 1e-7)
    dbce = np.where(unclipped, 1 / np.maximum(dist, 1e-7), 0.0)
    near = dist < 1e-5
    share = dbce[near].sum() / dbce.sum()
    print(f"voxels within 1e-5 of the wrong end: {near.mean():.4f}, "
          f"their share of sum |dBCE/dp|: {share:.3f}")
    assert share >= 0.5 and near.mean() < 0.01


def test_train_forward_losses_match_jax(port):
    _, _, result = port
    want = _jax_run()[6]
    assert sorted(result) == sorted(RESULT_KEYS)
    for key in RESULT_KEYS:
        np.testing.assert_allclose(float(result[key]), want[key], rtol=1e-3, err_msg=key)


def _assert_stats(gan):
    got = _leaves(torch_to_flax_variables(gan.nets["gen_SI"].state_dict(),
                                          gan.nets["gen_SI"])["batch_stats"])
    before = _leaves(_jax_run()[2]["gen_SI"]["batch_stats"])
    for witness in (False, True):
        want = _leaves(_jax_run(witness)[7]["gen_SI"]["batch_stats"])
        assert sorted(got) == sorted(want) and len(want) == 5 * 2 * 2  # 5 blocks of 2 BNs
        for key, w in want.items():
            np.testing.assert_allclose(got[key], w, rtol=1e-4, atol=1e-6, err_msg=key)
            assert not np.array_equal(got[key], before[key]), key


@pytest.mark.parametrize("update_gen", [True, False])
def test_batch_stats_after_one_step_match_jax(update_gen):
    """One ``distributed_train_step``: gen_SI's running statistics moved
    twice, as JAX's train step stores them, whether or not the generators'
    parameters are updated; with ``update_gen`` False those stay put."""
    _, _, _, real_I, real_S, *_ = _jax_run()
    gan = _gan()
    before = {n: [p.detach().clone() for p in gan.nets[n].parameters()] for n in NETWORKS}
    gan.distributed_train_step(real_I, real_S, 0.0, update_gen)
    _assert_stats(gan)
    for name in ("gen_IS", "gen_SI"):
        same = all(torch.equal(a, b) for a, b in zip(before[name], gan.nets[name].parameters()))
        assert same != update_gen, name


def test_gen_IS_has_no_running_statistics(port):
    """The i2s V-Net normalises per instance: no buffers, nothing moved."""
    gan, _, _ = port
    assert not list(gan.nets["gen_IS"].buffers())
    assert not _jax_run()[7]["gen_IS"]


def test_test_step_matches_jax():
    """The test step normalises by the running averages and moves nothing."""
    _, _, _, real_I, real_S, *_, want = _jax_run()
    gan = _gan()
    stats = {k: v.clone() for k, v in gan.nets["gen_SI"].state_dict().items()}
    got = gan.distributed_test_step(real_I, real_S)
    assert sorted(got) == sorted(RESULT_KEYS)
    for key in RESULT_KEYS:
        np.testing.assert_allclose(float(got[key]), want[key], rtol=1e-3, err_msg=key)
    assert all(torch.equal(stats[k], v) for k, v in gan.nets["gen_SI"].state_dict().items())
