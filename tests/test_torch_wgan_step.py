"""The port's WGAN-GP train step against the JAX package's.

At ``test_train_step.tiny_cfg`` size (batch 2, 16^3, generators f=4 with 2
levels, critics f=8 with the Wasserstein head), in float32 on the CPU, where
every op of the port takes its plain version, from one seeded JAX init with
its 1-D leaves perturbed. The random draws of the two frameworks differ, so:
the networks are deterministic (``tiny_models(deterministic=True)``: no
noise, no spatial dropout); the critics' head dropout, which trains whatever
``use_dropout`` says, is neutralised on both sides inside the test (flax's
``nn.Dropout`` patched to the identity, the port's ``w_dropout`` rate set to
0; the mask itself is tested in ``test_torch_wgan.py``); and the port's
gradient penalty is given the interpolation weights JAX draws from its key
(``step.py:208-211``: ``r["gp_I"]`` and ``r["gp_S"]``).

Tolerances, by ``test_torch_train_step.py``'s rules: the four restricted
gradients within 2e-3 relative L2 per network of ``jax.grad(compute_losses)``
at ``gp_scale`` 0 and 10; losses rtol 1e-4; parameters after one Adam step
atol 1e-7 where both gradients have one sign and |g| > 1e-3 max |g|.
"""

import functools
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_checkpoint import one_torch_thread  # noqa: F401  (autouse fixture)
from test_train_step import make_batch, tiny_cfg, tiny_models

from vangan_tpu.training.step import make_step_fns
from vangan_torch.config import VanGanConfig
from vangan_torch.models.discriminator import PatchGANDiscriminator3D
from vangan_torch.models.resunet import ResUNet3D
from vangan_torch.training import step as torch_step
from vangan_torch.training.state import NETWORKS
from vangan_torch.training.step import RESULT_KEYS
from vangan_torch.vangan import VanGan
from vangan_torch.weights import load_flax_networks, torch_to_flax

STEPS_PER_EPOCH = 3
KEY = 7  # the step's PRNG key
GP_SCALES = (0.0, 10.0)


class _NoDropout(fnn.Module):
    """flax ``nn.Dropout`` as the identity: the critic's ``w_dropout``."""

    rate: float = 0.0

    @fnn.compact
    def __call__(self, x, deterministic=None):
        return x


def jax_alphas(batch):
    """The gradient penalty's interpolation weights of the JAX step for key
    ``KEY``: ``normal(fold_in(key, 8 | 9), (B, 1, 1, 1, 1))``."""
    key = jax.random.PRNGKey(KEY)
    return {dom: np.asarray(jax.random.normal(jax.random.fold_in(key, i), (batch, 1, 1, 1, 1),
                                              jnp.float32))
            for dom, i in (("I", 8), ("S", 9))}


@functools.lru_cache(maxsize=None)
def _jax_step():
    """(perturbed params, real_I, real_S, {gp_scale: (grads, losses)}, params
    after one step at gp_scale 0), computed once per module run."""
    cfg = tiny_cfg(wasserstein=True)
    rng = np.random.default_rng(0)
    with mock.patch.object(fnn, "Dropout", _NoDropout):
        fns = make_step_fns(cfg, tiny_models(deterministic=True, wasserstein=True),
                            steps_per_epoch=STEPS_PER_EPOCH)
        state = fns.init(jax.random.PRNGKey(0))
        params = jax.tree_util.tree_map(
            lambda p: p + 0.1 * jnp.asarray(rng.normal(size=p.shape), p.dtype)
            if p.ndim == 1 else p, state.params)
        state = state.replace(params=params)
        real_I, real_S = make_batch(rng, cfg)
        grad_fn = jax.jit(jax.grad(fns.compute_losses, argnums=0, has_aux=True),
                          static_argnums=(6,))
        host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
        out = {}
        for gp in GP_SCALES:
            grads, (result, new_ms) = grad_fn(params, state.model_state, real_I, real_S,
                                              jax.random.PRNGKey(KEY), jnp.zeros(()), True,
                                              jnp.asarray(gp, jnp.float32))
            out[gp] = (host(grads), {k: float(v) for k, v in result.items()})
            if gp == 0.0:
                stepped = host(fns.apply_grads(state, grads, new_ms, jnp.asarray(True)).params)
    return host(params), np.array(real_I), np.array(real_S), out, stepped


def wgan_gan(params=None, seed=0, deterministic=True, use_SN=False, model_state=None):
    """The port's tiny WGAN-GP system, with ``params`` (a JAX tree) and the
    ``batch_stats`` of ``model_state`` loaded."""
    cfg = VanGanConfig(BATCH_SIZE=2, SUBVOL_PATCH_SIZE=(16, 16, 16), compute_dtype="float32",
                       cldice_iters=2, EPOCHS=2, seed=seed, wasserstein=True)
    on = not deterministic
    disc = dict(filters=8, use_dropout=on, use_input_noise=on, use_layer_noise=on,
                wasserstein=True, use_SN=use_SN, patch_size=(16, 16, 16))
    g = torch.Generator().manual_seed(seed)
    models = {"gen_IS": ResUNet3D(4, 2, "simple", generator=g),
              "gen_SI": ResUNet3D(4, 2, "simple", generator=g),
              "disc_I": PatchGANDiscriminator3D(**disc, generator=g),
              "disc_S": PatchGANDiscriminator3D(**disc, generator=g)}
    gan = VanGan(cfg, device="cpu", models=models, steps_per_epoch=STEPS_PER_EPOCH)
    if params is not None:
        load_flax_networks(gan, params, model_state)
    return gan


def _flat(net, tensors):
    tree = torch_to_flax(dict(zip((n for n, _ in net.named_parameters()), tensors)), net)
    return _flat_tree(tree)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _flat_tree(tree):
    return np.concatenate([v.ravel() for _, v in sorted(_leaves(tree).items())])


@pytest.fixture
def jax_alpha(monkeypatch):
    """The port's step with JAX's interpolation weights, picked by domain."""
    alphas = {k: torch.from_numpy(v) for k, v in jax_alphas(2).items()}
    real_gp = torch_step.gradient_penalty
    reals = {}

    def gp(scales, disc_apply, real, fake, generator=None, alpha=None):
        # the step's one slice, ``x[0::1]``, is a view of the batch
        dom = "I" if real.data_ptr() == reals["I"].data_ptr() else "S"
        return real_gp(scales, disc_apply, real, fake, generator, alpha=alphas[dom])

    monkeypatch.setattr(torch_step, "gradient_penalty", gp)
    return reals


@pytest.mark.parametrize("gp_scale", GP_SCALES)
def test_wgan_step_grads_match_jax(jax_alpha, gp_scale):
    """The four restricted gradients and the ten losses of one WGAN-GP
    training forward, without and with the penalty."""
    params, real_I, real_S, out, _ = _jax_step()
    want_grads, want_losses = out[gp_scale]
    gan = wgan_gan(params)
    for name in ("disc_I", "disc_S"):
        gan.nets[name].w_dropout = 0.0
    x, y = torch.from_numpy(real_I), torch.from_numpy(real_S)
    jax_alpha.update(I=x, S=y)
    grads, result = torch_step.compute_grads(gan.nets, gan.cfg, gan.scales, x, y, 0.0,
                                             gan.generator, gp_scale=gp_scale)
    for key in RESULT_KEYS:
        np.testing.assert_allclose(float(result[key]), want_losses[key], rtol=1e-4, err_msg=key)
    if gp_scale:
        # the penalty is in the critics' losses
        assert result["D_I_loss"] > out[0.0][1]["D_I_loss"] + 1e-3
    for name in NETWORKS:
        got, want = _flat(gan.nets[name], grads[name]), _flat_tree(want_grads[name])
        assert got.shape == want.shape
        assert np.linalg.norm(got - want) <= 2e-3 * np.linalg.norm(want), name


def test_wgan_adam_step_matches_jax():
    """One ``distributed_train_step`` at step 0 (no penalty): the losses, and
    the parameters after WGAN Adam (b1 0, b2 0.9, LR 1e-4, no clip)."""
    params, real_I, real_S, out, want_params = _jax_step()
    grads, want_losses = out[0.0]
    gan = wgan_gan(params)
    for name in ("disc_I", "disc_S"):
        gan.nets[name].w_dropout = 0.0
    x, y = torch.from_numpy(real_I), torch.from_numpy(real_S)
    port, _ = torch_step.compute_grads(gan.nets, gan.cfg, gan.scales, x, y, 0.0, gan.generator)
    result = gan.distributed_train_step(real_I, real_S, 0.0, True)
    assert gan.state.step == 1 and gan.state.clipnorm is None
    for key in RESULT_KEYS:
        np.testing.assert_allclose(float(result[key]), want_losses[key], rtol=1e-4, err_msg=key)
    for name in NETWORKS:
        net = gan.nets[name]
        got = _leaves(torch_to_flax(net.state_dict(), net))
        g_jax = _leaves(grads[name])
        g_port = _leaves(torch_to_flax(dict(zip((n for n, _ in net.named_parameters()),
                                                port[name])), net))
        gmax = max(np.abs(v).max() for v in g_jax.values())
        for key, w in _leaves(want_params[name]).items():
            mask = (np.abs(g_jax[key]) > 1e-3 * gmax) & (np.sign(g_jax[key]) ==
                                                          np.sign(g_port[key]))
            np.testing.assert_allclose(got[key][mask], w[mask], rtol=0, atol=1e-7,
                                       err_msg=f"{name}{key}")
