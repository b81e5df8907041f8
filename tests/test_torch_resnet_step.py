"""The ResNet CycleGAN's train and test steps in the port against the JAX
package's: both generators the factory's ResNet (``gen_i2s = gen_s2i =
"resnet"``), config 2's PatchGAN discriminators.

At ``test_train_step.tiny_cfg`` with 32^3 patches (batch 2, clDice with 2
iterations), float32 on the CPU, where every op of the port takes its plain
version. The generators are the factory's ResNet at ``gen_filters=2`` (4
filters; 3 downsampling blocks, 6 residual blocks at 32 channels on 4^3, 3
upsampling blocks; its 7^3 reflect stem and head), without dropout, and the
discriminators f=8 without noise or dropout: their random draws differ
between the frameworks. The flax NXCYZ layout for the generators. The port
loads the JAX init with its 1-D leaves perturbed, through ``weights.py``.
Not 16^3, where every reflect pad also fits: there the residual blocks
normalise 2^3 planes, and gen_SI's float32 gradient moves by 3.2e-2 under
the weight perturbation below, beyond the rule's 2e-2 (it read 2.3e-2 from
JAX's). Tolerances, as ``test_torch_vnet_step.py``'s float32 rule:

- the four restricted gradients of one backward: each network's flat
  gradient no further from JAX's (relative L2) than a 1e-5 relative weight
  perturbation moves the port's own, and within 2e-2 (the test prints
  both). The spread is the largest of ``SPREAD_DRAWS`` perturbation draws,
  as ``chip_smoke.py``'s ``TWOD_SPREAD_DRAWS``: one draw does not bound it.
  Measured, relative L2 to JAX and the three draws: disc_S 6.7e-4 against
  6.0e-4, 3.7e-3, 1.9e-3. disc_S's gradient is that sensitive to its input:
  computed in float64 on gen_IS's float32 and float64 outputs (1.1e-5
  apart), it moves by 6.7e-4, while disc_S alone in float32 is 9e-7 from
  float64;
- the ten losses: rtol 1e-3, in training and in the test step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_train_step import make_batch, tiny_cfg, tiny_models

from vangan_tpu.models.resnet_generator import ResNetGenerator3D as FlaxResNetGenerator3D
from vangan_tpu.training.step import make_step_fns
from vangan_torch.config import VanGanConfig
from vangan_torch.models.discriminator import PatchGANDiscriminator3D
from vangan_torch.models.resnet_generator import ResNetGenerator3D
from vangan_torch.training import step as torch_step
from vangan_torch.training.state import NETWORKS
from vangan_torch.training.step import RESULT_KEYS
from vangan_torch.vangan import VanGan
from vangan_torch.weights import load_flax_networks, torch_to_flax

STEPS_PER_EPOCH = 3
SPREAD_DRAWS = 3
GEN_FILTERS = 2
PATCH = (32, 32, 32)
# the factory's ResNet (models/factory.py) at gen_filters=2, dropout off
RESNET = dict(filters=2 * GEN_FILTERS, num_downsampling_blocks=3, num_residual_blocks=6,
              num_upsample_blocks=3, stem_dropout=0.0, downsample_dropout=0.0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny networks: one intra-op thread is faster when test workers share
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jax_run():
    """(config, params, real_I, real_S, grads, train losses, test losses),
    once per module."""
    jax_cfg = tiny_cfg(SUBVOL_PATCH_SIZE=PATCH)
    rng = np.random.default_rng(0)
    models = tiny_models(deterministic=True)
    for name in ("gen_IS", "gen_SI"):
        models[name] = FlaxResNetGenerator3D(**RESNET, layout="NXCYZ", dtype=jnp.float32)
    fns = make_step_fns(jax_cfg, models, steps_per_epoch=STEPS_PER_EPOCH)
    state = fns.init(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(
        lambda p: p + 0.1 * jnp.asarray(rng.normal(size=p.shape), p.dtype)
        if p.ndim == 1 else p, state.params)
    state = state.replace(params=params)
    real_I, real_S = make_batch(rng, jax_cfg)
    grads, (result, _) = jax.grad(fns.compute_losses, argnums=0, has_aux=True)(
        params, state.model_state, real_I, real_S, jax.random.PRNGKey(7), jnp.zeros(()), True,
        None)
    test = fns.test_step(state, real_I, real_S, jax.random.PRNGKey(8))
    host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return (jax_cfg, host(params), np.array(real_I), np.array(real_S), host(grads),
            {k: float(v) for k, v in result.items()}, {k: float(v) for k, v in test.items()})


def _gan(perturb=0.0, draw=0):
    jax_cfg, params, *_ = _jax_run()
    cfg = VanGanConfig(N_DEVICES=jax_cfg.N_DEVICES, BATCH_SIZE=jax_cfg.BATCH_SIZE,
                       SUBVOL_PATCH_SIZE=jax_cfg.SUBVOL_PATCH_SIZE, compute_dtype="float32",
                       cldice_iters=jax_cfg.cldice_iters, EPOCHS=jax_cfg.EPOCHS,
                       cycle_loss_I_type=jax_cfg.cycle_loss_I_type,
                       lambda_topology=jax_cfg.lambda_topology, gen_filters=GEN_FILTERS,
                       gen_i2s="resnet", gen_s2i="resnet")
    disc = dict(filters=8, use_dropout=False, use_input_noise=False, use_layer_noise=False)
    models = {"gen_IS": ResNetGenerator3D(**RESNET), "gen_SI": ResNetGenerator3D(**RESNET),
              "disc_I": PatchGANDiscriminator3D(**disc), "disc_S": PatchGANDiscriminator3D(**disc)}
    gan = VanGan(cfg, device="cpu", models=models, steps_per_epoch=STEPS_PER_EPOCH)
    load_flax_networks(gan, params)
    if perturb:
        g = torch.Generator().manual_seed(1 + draw)
        with torch.no_grad():
            for net in gan.nets.values():
                for p in net.parameters():
                    p.mul_(1 + perturb * torch.randn(p.shape, generator=g))
    return gan


def _grads(gan):
    _, _, real_I, real_S, *_ = _jax_run()
    return torch_step.compute_grads(gan.nets, gan.cfg, gan.scales, torch.from_numpy(real_I),
                                    torch.from_numpy(real_S), 0.0, gan.generator)


def _flat(net, tensors=None, tree=None):
    """A network's gradient as one vector in flax leaf order: the port's
    (``tensors`` in ``net.parameters()`` order) or JAX's (``tree``)."""
    if tree is None:
        names = (n for n, _ in net.named_parameters())
        tree = torch_to_flax(dict(zip(names, (t.float() for t in tensors))), net)
    leaves = {jax.tree_util.keystr(p): np.asarray(v)
              for p, v in jax.tree_util.tree_leaves_with_path(tree)}
    return np.concatenate([leaves[k].ravel() for k in sorted(leaves)])


@pytest.fixture(scope="module")
def port():
    gan = _gan()
    grads, result = _grads(gan)
    return gan, grads, result


@pytest.fixture(scope="module")
def perturbed():
    """The port's gradients under SPREAD_DRAWS draws of the 1e-5 weight
    perturbation."""
    return [_grads(_gan(perturb=1e-5, draw=i))[0] for i in range(SPREAD_DRAWS)]


def test_the_generators_are_the_factorys_resnet():
    """The port's ResNet of the config (``build_generator``) has the
    parameters and shapes of the one the test builds, and both roles are
    one network."""
    from vangan_torch.models.factory import build_generator

    gan = _gan()
    for role, name in (("i2s", "gen_IS"), ("s2i", "gen_SI")):
        built = build_generator("resnet", gan.cfg, role=role)
        assert [(n, p.shape) for n, p in built.named_parameters()] == \
            [(n, p.shape) for n, p in gan.nets[name].named_parameters()]


@pytest.mark.parametrize("name", NETWORKS)
def test_one_backward_matches_jax_grad(port, perturbed, name):
    gan, grads, _ = port
    net = gan.nets[name]
    got = _flat(net, grads[name])
    want = _flat(net, tree=_jax_run()[4][name])
    assert got.shape == want.shape
    gap = np.linalg.norm(got - want)
    draws = [np.linalg.norm(got - _flat(net, d[name])) for d in perturbed]
    norm = np.linalg.norm(want)
    print(f"{name}: relative L2 to JAX {gap / norm:.3e}, the port's own spread "
          f"{', '.join(f'{d / norm:.3e}' for d in draws)} ({SPREAD_DRAWS} draws)")
    assert gap <= min(2e-2 * norm, max(draws))


def test_train_forward_losses_match_jax(port):
    _, _, result = port
    want = _jax_run()[5]
    assert sorted(result) == sorted(RESULT_KEYS)
    for key in RESULT_KEYS:
        np.testing.assert_allclose(float(result[key]), want[key], rtol=1e-3, err_msg=key)


def test_test_step_matches_jax():
    _, _, real_I, real_S, *_, want = _jax_run()
    got = _gan().distributed_test_step(real_I, real_S)
    assert sorted(got) == sorted(RESULT_KEYS)
    for key in RESULT_KEYS:
        np.testing.assert_allclose(float(got[key]), want[key], rtol=1e-3, err_msg=key)


def test_train_step_moves_every_parameter():
    """One ``distributed_train_step`` on the batch: every parameter tensor
    of the four networks moves and stays finite, and the ten losses are
    the forward's."""
    _, _, real_I, real_S, *_ = _jax_run()
    gan = _gan()
    before = {n: [p.detach().clone() for p in gan.nets[n].parameters()] for n in NETWORKS}
    out = gan.distributed_train_step(real_I, real_S, 0.0, True)
    want = _jax_run()[5]
    for key in RESULT_KEYS:
        np.testing.assert_allclose(float(out[key]), want[key], rtol=1e-3, err_msg=key)
    for name in NETWORKS:
        for a, p in zip(before[name], gan.nets[name].parameters()):
            assert torch.isfinite(p).all() and not torch.equal(a, p.detach()), name
