"""The port's WGAN-GP pieces against the JAX package's, on the CPU in
float32: the Wasserstein critic with and without spectral norm, the gradient
penalty, the ncritic bookkeeping, the WGAN optimizer, and the critic's state
through the weight map, the checkpoints and ``python -m vangan_torch train``.

Critics are the tiny ones of the step tests (f=8, 16^3, batch 2) without
noise or spatial dropout; the head's dropout, whose draws differ between
the frameworks, is neutralised on both sides inside the tests that compare
(``test_torch_wgan_step._NoDropout``, ``w_dropout = 0``) and its mask is
tested on its own. Tolerances: critic outputs within 1e-5 * max |JAX|, the
spectral norms' ``u`` and ``sigma`` after a training call rtol 1e-5 (atol
1e-6); the penalty within 1e-5 relative and its gradient w.r.t. the critic's
parameters within 2e-4 relative L2 (float32 sums in another order through a
second derivative).
"""

import os
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_checkpoint import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_fit import _Dataset, _Gan, _partitions, _Summary
from test_torch_wgan_step import _NoDropout, wgan_gan
from test_train_step import make_batch, tiny_cfg

import vangan_tpu.losses as J
from vangan_tpu.config import VanGanConfig as JaxConfig
from vangan_tpu.models.discriminator import PatchGANDiscriminator3D as FlaxDisc
from vangan_tpu.models.resunet import ResUNet3D as FlaxResUNet
from vangan_tpu.training import loop as jax_loop
from vangan_tpu.training.optimizers import make_optimizer as jax_make_optimizer
from vangan_tpu.training.step import make_step_fns
from vangan_torch import cli
from vangan_torch import losses as T
from vangan_torch.config import VanGanConfig
from vangan_torch.models.discriminator import PatchGANDiscriminator3D
from vangan_torch.training import loop
from vangan_torch.training.state import NETWORKS, make_train_state
from vangan_torch.weights import (
    flax_to_torch,
    load_flax_params,
    load_flax_train_state,
    torch_to_flax_variables,
)

PATCH = (16, 16, 16)


def _flax_critic(use_SN, x):
    """(flax critic, perturbed params, batch_stats or None). The kernels are
    scaled by 1.3: flax's init leaves each spectrally normalised kernel with
    sigma 1 for its initial u."""
    rng = np.random.default_rng(1)
    fm = FlaxDisc(filters=8, layout="NXCYZ", dtype=jnp.float32, wasserstein=True, use_SN=use_SN)
    v = fm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda p: p + 0.1 * jnp.asarray(rng.normal(size=p.shape), p.dtype)
        if p.ndim == 1 else 1.3 * p, v["params"])
    return fm, params, v.get("batch_stats")


def _apply(fm, params, bs, x, train):
    """flax's output, and its batch_stats after the call."""
    variables = {"params": params, **({"batch_stats": bs} if bs else {})}
    rngs = {"dropout": jax.random.PRNGKey(0)}
    with mock.patch.object(fnn, "Dropout", _NoDropout):
        if bs and train:
            y, upd = fm.apply(variables, x, train=True, rngs=rngs, mutable=["batch_stats"])
            return y, upd["batch_stats"]
        return fm.apply(variables, x, train=train, rngs=rngs), bs


def _torch_critic(params, bs, use_SN):
    tm = load_flax_params(PatchGANDiscriminator3D(filters=8, wasserstein=True, use_SN=use_SN,
                                                  patch_size=PATCH), params, bs)
    tm.w_dropout = 0.0
    return tm


def _x():
    return np.random.default_rng(0).uniform(-1, 1, size=(2, *PATCH, 1)).astype(np.float32)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("use_SN", [False, True])
def test_critic_matches_flax(use_SN, train):
    """One call: the (B, 1) scores; with spectral norm, the u and sigma it
    stores in training and keeps in eval."""
    x = _x()
    fm, params, bs = _flax_critic(use_SN, x)
    want, want_bs = _apply(fm, params, bs, jnp.asarray(x), train)
    tm = _torch_critic(params, bs, use_SN)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), train, 0.0, torch.Generator()).numpy()
    assert got.shape == (2, 1)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    if use_SN:
        got_bs = torch_to_flax_variables(tm.state_dict(), tm)["batch_stats"]
        moved = jax.tree_util.tree_map(lambda a, b: not np.array_equal(a, b), want_bs, bs)
        assert all(jax.tree_util.tree_leaves(moved)) == train
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6),
            got_bs, want_bs)


@pytest.mark.parametrize("use_SN", [False, True])
def test_gradient_penalty_matches_jax(use_SN):
    """The penalty of a critic trained (no stored spectral-norm state) at
    JAX's interpolation weights, and its gradient w.r.t. the parameters."""
    x = _x()
    fake = np.tanh(np.random.default_rng(2).normal(size=x.shape)).astype(np.float32)
    fm, params, bs = _flax_critic(use_SN, x)
    key = jax.random.PRNGKey(5)
    js = J.LossScales(global_batch_size=2, n_devices=1)

    def jax_gp(p):
        return J.gradient_penalty(js, lambda v: _apply(fm, p, bs, v, True)[0], jnp.asarray(x),
                                  jnp.asarray(fake), key)

    with mock.patch.object(fnn, "Dropout", _NoDropout):
        want, want_g = jax.value_and_grad(jax_gp)(params)
    tm = _torch_critic(params, bs, use_SN)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    alpha = torch.from_numpy(np.array(jax.random.normal(key, (2, 1, 1, 1, 1))))
    gen = torch.Generator()
    gp = T.gradient_penalty(T.LossScales(global_batch_size=2, n_devices=1),
                            lambda v: tm(v, True, 0.0, gen, update_stats=False),
                            torch.from_numpy(x), torch.from_numpy(fake), alpha=alpha)
    np.testing.assert_allclose(gp.item(), float(want), rtol=1e-5)
    names = [n for n, _ in tm.named_parameters()]
    got_g = torch.autograd.grad(gp, list(tm.parameters()), allow_unused=True,
                                materialize_grads=True)  # the biases of the head
    got = torch_to_flax_variables(dict(zip(names, got_g)), tm)["params"]
    flat = lambda t: np.concatenate([np.ravel(v) for v in jax.tree_util.tree_leaves(t)])  # noqa: E731
    g, w = flat(got), flat(jax.tree_util.tree_map(np.asarray, want_g))
    assert np.linalg.norm(g - w) <= 2e-4 * np.linalg.norm(w)
    assert all(torch.equal(v, before[k]) for k, v in tm.state_dict().items())


def test_critic_head_dropout_mask():
    """The head's dropout acts on the flattened logits before ``w_dense`` in
    training only, whatever ``use_dropout`` says: each logit dropped with
    probability 0.2, the rest scaled by 1 / 0.8."""
    tm = PatchGANDiscriminator3D(filters=2, wasserstein=True, use_dropout=False,
                                 patch_size=(64, 64, 64), generator=torch.Generator())
    seen = []
    tm.w_dense.register_forward_pre_hook(lambda m, inp: seen.append(inp[0].detach()))
    x = torch.rand(1, 64, 64, 64, 1, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        tm(x)
        tm(x, True, 0.0, torch.Generator().manual_seed(3))
    logits, dropped = seen
    assert logits.shape == (1, 512) and bool((logits != 0).all())
    kept = dropped != 0
    torch.testing.assert_close(dropped[kept], logits[kept] / 0.8)
    assert 0.12 < 1 - float(kept.float().mean()) < 0.28


def _fit_log(fit, cfg, as_tensor):
    log = []

    class Critic(_Gan):
        wasserstein, ncritic = True, cfg.ncritic

    fit(cfg, Critic(log, as_tensor), _Dataset(log), _Summary(log))
    return log


def test_fit_ncritic_sequence_matches_jax():
    """12 train steps in 4 epochs (validation steps between them lower the
    flag too): the generators' updates are the steps JAX's bookkeeping names."""
    kw = dict(EPOCHS=4, PERIOD_2D_CALLBACK=3, wasserstein=True, ncritic=5)
    got = _fit_log(loop.fit, VanGanConfig(**kw), True)
    want = _fit_log(jax_loop.fit, JaxConfig(**kw), False)
    assert got == want
    flags = [rec[2] for rec in got if rec[0] == "train_step"]
    assert len(flags) == 12 and sum(flags) == 3 and flags[0]


def _snapshot(gan, names):
    return {n: ([p.detach().clone() for p in gan.nets[n].parameters()],
                [t.clone() for s in gan.state.opt[n].state.values()
                 for t in (s["exp_avg"], s["exp_avg_sq"])], gan.state.counts[n])
            for n in names}


def test_update_gen_false_keeps_the_generators():
    """A critic-only step (the penalty on) moves the critics and their
    spectral norms' u, not the generators or their Adam states."""
    rng = np.random.default_rng(0)
    real_I, real_S = (np.asarray(a) for a in make_batch(rng, tiny_cfg()))
    gan = wgan_gan(deterministic=False, use_SN=True)
    gan.distributed_train_step(real_I, real_S, 0.1, True)
    before = _snapshot(gan, NETWORKS)
    u = gan.nets["disc_I"].SpectralNorm_0.u.clone()
    result = gan.distributed_train_step(real_I, real_S, 0.1, False)
    assert all(np.isfinite(float(v)) for v in result.values())
    after = _snapshot(gan, NETWORKS)
    for name in ("gen_IS", "gen_SI"):
        (p0, m0, c0), (p1, m1, c1) = before[name], after[name]
        assert c0 == c1 == 1 and len(m0) == len(m1) == 2 * len(p0)
        assert all(torch.equal(a, b) for a, b in zip(m0 + p0, m1 + p1))
    for name in ("disc_I", "disc_S"):
        assert after[name][2] == 2
        # all but w_dense.bias, which the Wasserstein loss and the penalty do
        # not see: its gradient is 0 and Adam leaves it
        names = [n for n, _ in gan.nets[name].named_parameters()]
        moved = [n for n, a, b in zip(names, before[name][0], after[name][0])
                 if not torch.equal(a, b)]
        assert moved == [n for n in names if n != "w_dense.bias"]
    assert not torch.equal(u, gan.nets["disc_I"].SpectralNorm_0.u)
    assert gan.state.step == 2


def test_wgan_optimizer_matches_optax_without_clipping():
    """Two updates with gradients of norm ~1e3 (which the LSGAN path would
    clip to 100) against the JAX package's WGAN chain: Adam b1 0, b2 0.9,
    eps 1e-7, constant LR 1e-4."""
    nets = {n: torch.nn.Linear(7, 3) for n in NETWORKS}
    state = make_train_state(nets, VanGanConfig(wasserstein=True), steps_per_epoch=3)
    assert state.clipnorm is None
    params = {"w": nets["disc_I"].weight.detach().numpy().copy(),
              "b": nets["disc_I"].bias.detach().numpy().copy()}
    opt = jax_make_optimizer(JaxConfig(wasserstein=True), 3)
    opt_state = opt.init(params)
    rng = np.random.default_rng(0)
    for _ in range(2):
        g = {"w": rng.normal(size=(3, 7)).astype(np.float32) * 300,
             "b": rng.normal(size=3).astype(np.float32) * 300}
        updates, opt_state = opt.update(g, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: np.asarray(p + u), params, updates)
        grads = [torch.from_numpy(g["w"].copy()), torch.from_numpy(g["b"].copy())]
        state.apply("disc_I", grads)
        assert float(grads[0].norm()) > 100  # not clipped in place
    np.testing.assert_allclose(nets["disc_I"].weight.detach().numpy(), params["w"], rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(nets["disc_I"].bias.detach().numpy(), params["b"], rtol=1e-6,
                               atol=1e-9)


def _jax_wgan_state(flatten_opt):
    """A JAX WGAN-GP state (spectral-norm critics) whose Adam moments and
    counts have moved: one optimizer update of each network from random
    gradients."""
    cfg = tiny_cfg(wasserstein=True, flatten_opt=flatten_opt)
    gen = dict(upsample_mode="simple", filters=4, num_layers=2, dropout_type="none")
    critic = dict(filters=8, wasserstein=True, use_SN=True)
    models = {"gen_IS": FlaxResUNet(**gen), "gen_SI": FlaxResUNet(**gen),
              "disc_I": FlaxDisc(**critic), "disc_S": FlaxDisc(**critic)}
    state = make_step_fns(cfg, models, steps_per_epoch=3).init(jax.random.PRNGKey(0))
    opt = jax_make_optimizer(cfg, 3)
    rng = np.random.default_rng(1)
    params, opt_state = {}, {}
    for name in NETWORKS:
        g = jax.tree_util.tree_map(lambda p: jnp.asarray(rng.normal(size=p.shape), p.dtype),
                                   state.params[name])
        updates, opt_state[name] = opt.update(g, state.opt_state[name], state.params[name])
        params[name] = jax.tree_util.tree_map(lambda p, u: p + u, state.params[name], updates)
    return state.replace(step=jnp.asarray(1), params=params, opt_state=opt_state), opt


@pytest.mark.parametrize("flatten_opt", [True, False])
def test_load_flax_train_state_carries_the_wgan_chain(flatten_opt):
    """The parameters (``w_dense`` transposed), the spectral norms' u and
    sigma, and the WGAN chain's moments and counts: the next update from the
    same gradients lands where JAX's does."""
    state, opt = _jax_wgan_state(flatten_opt)
    gan = wgan_gan(use_SN=True)
    load_flax_train_state(gan, state)
    assert gan.state.step == 1 and set(gan.state.counts.values()) == {1}
    rng = np.random.default_rng(2)
    for name in NETWORKS:
        net = gan.nets[name]
        variables = torch_to_flax_variables(net.state_dict(), net)
        jax.tree_util.tree_map(np.testing.assert_array_equal, variables["params"],
                               jax.tree_util.tree_map(np.asarray, state.params[name]))
        if name.startswith("disc"):
            jax.tree_util.tree_map(np.testing.assert_array_equal, variables["batch_stats"],
                                   jax.tree_util.tree_map(
                                       np.asarray, state.model_state[name]["batch_stats"]))
        g = jax.tree_util.tree_map(lambda p: rng.normal(size=p.shape).astype(np.float32),
                                   state.params[name])
        updates, _ = opt.update(g, state.opt_state[name], state.params[name])
        want = jax.tree_util.tree_map(lambda p, u: np.asarray(p + u), state.params[name],
                                      updates)
        sd = flax_to_torch(g, net)
        gan.state.apply(name, [sd[n].contiguous() for n, _ in net.named_parameters()])
        got = torch_to_flax_variables(net.state_dict(), net)["params"]
        jax.tree_util.tree_map(lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-6,
                                                                       atol=1e-9), got, want)


def test_checkpoint_round_trips_spectral_norms_and_wgan_adam(tmp_path):
    rng = np.random.default_rng(0)
    real_I, real_S = (np.asarray(a) for a in make_batch(rng, tiny_cfg()))
    gan = wgan_gan(deterministic=False, use_SN=True)
    gan.cfg.output_dir = str(tmp_path)
    gan.distributed_train_step(real_I, real_S, 0.1, True)
    gan.save_checkpoint(epoch=0)
    gan.checkpointer.wait_until_finished()
    other = wgan_gan(deterministic=False, use_SN=True, seed=1)
    other.cfg.output_dir = str(tmp_path)
    other.load_checkpoint(1)
    assert other.state.step == 1 and other.state.clipnorm is None
    for name in NETWORKS:
        a, b = gan.nets[name].state_dict(), other.nets[name].state_dict()
        assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)
        sa = gan.state.opt[name].state_dict()
        sb = other.state.opt[name].state_dict()
        assert sa["param_groups"][0]["betas"] == sb["param_groups"][0]["betas"] == (0.0, 0.9)
        for i, s in sa["state"].items():
            assert all(torch.equal(s[k], sb["state"][i][k]) for k in s)
    assert "SpectralNorm_0.u" in gan.nets["disc_I"].state_dict()


def test_train_cli_runs_wgan_gp(tmp_path):
    """``python -m vangan_torch train`` with ``wasserstein: true`` and ncritic
    2 in the YAML: 4 train steps in 2 epochs update the critics 4 times and
    the generators 3 times (steps 1, 2 and 4: the validation step between
    the epochs lowers the flag)."""
    _partitions(tmp_path)
    cfg = str(tmp_path / "cfg.yaml")
    VanGanConfig(BATCH_SIZE=1, EPOCHS=2, SUBVOL_PATCH_SIZE=PATCH, gen_filters=4, disc_filters=8,
                 cldice_iters=2, train_steps=2, val_steps=1, compute_dtype="float32",
                 wasserstein=True, ncritic=2, output_dir=str(tmp_path / "out")).to_yaml(cfg)
    cli.main(["train", "--config", cfg, "--data-dir", str(tmp_path / "data"), "--device",
              "cpu"])
    ck = torch.load(os.path.join(tmp_path, "out", "checkpoints", "torch_e2.pt"),
                    weights_only=True)
    counts = ck["train_state"]["counts"]
    assert ck["train_state"]["step"] == 4 and counts["disc_I"] == counts["disc_S"] == 4
    assert counts["gen_IS"] == counts["gen_SI"] == 3
    assert ck["disc_I"]["w_dense.weight"].shape == (1, 8)
