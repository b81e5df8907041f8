"""Gradient accumulation (``micro_batches``) in the port against the JAX
package's ``jit_microbatch_step``.

At ``test_train_step.tiny_cfg`` sizes (16^3, generators f=4 with 2 levels,
discriminators f=8, clDice with 2 iterations), in float32 on the CPU, where
every op of the port takes its plain version, from one seeded JAX init with
its 1-D leaves perturbed. The networks are deterministic (no noise, no
dropout: the random draws of the two frameworks differ); the WGAN critics'
head dropout is neutralised on both sides and the port's gradient penalty is
given JAX's interpolation weights of each slice, as ``test_torch_wgan_step``
does. JAX's side is what ``vangan_tpu.parallel.jit_microbatch_step`` runs:
``grad_gens_micro`` and ``grad_discs_micro`` on each slice ``x[m::micro]``
with the key folded by ``m``, gradients and results summed, the mutable
collections averaged, then ``apply_grads`` (``test_replica_is_jax_microbatch_step``
holds this replica to ``jit_microbatch_step`` itself).

Tolerances, those of ``test_torch_train_step.py`` and ``test_torch_parallel.py``
(their module notes say why): each network's flat gradient within 2e-3
relative L2 of JAX's, or within ``SPREAD_FACTOR`` times what the port's own
gradient moves when every weight moves by 1e-6 relative, whichever is
larger (a slice of one 16^3 sample makes gen_IS's float32 gradient jump
as ``test_torch_parallel``'s one-sample ranks do); the summed losses rtol 1e-4; the
parameters after one Adam step atol 1e-7 where both gradients agree in sign
to 1e-3 and exceed 1e-3 max |g|; config 4's averaged BatchNorm statistics
rtol 1e-4, atol 1e-6 (``test_torch_vnet.py``'s bound).
"""

import contextlib
import functools
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_checkpoint import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_vnet import _roles, _stats, flax_float64
from test_torch_vnet_step import _is_gen_IS_head
from test_torch_wgan_step import _NoDropout
from test_train_step import make_batch, tiny_cfg, tiny_models

from vangan_tpu.models.vnet import VNet3D as FlaxVNet3D
from vangan_tpu.parallel import jit_microbatch_step, make_mesh
from vangan_tpu.training.step import make_step_fns
from vangan_torch import parallel
from vangan_torch.config import VanGanConfig
from vangan_torch.losses import LossScales
from vangan_torch.models.discriminator import PatchGANDiscriminator3D
from vangan_torch.models.resunet import ResUNet3D
from vangan_torch.models.vnet import VNet3D
from vangan_torch.parallel import Group
from vangan_torch.training import step as torch_step
from vangan_torch.training.state import NETWORKS
from vangan_torch.training.step import RESULT_KEYS
from vangan_torch.vangan import VanGan
from vangan_torch.weights import load_flax_networks, torch_to_flax, torch_to_flax_variables

import torch_dp_worker as worker

STEPS_PER_EPOCH = 3
KEY = 7  # the step's PRNG key
SPREAD_FACTOR = 3
TIMEOUT_S = 240

# name -> per-device batch, slices, devices, generators, WGAN-GP, train step
CASES = {
    "micro3_of_3": dict(batch=3, micro=3),
    "micro2_of_4": dict(batch=4, micro=2),
    "config4_micro2_of_4": dict(batch=4, micro=2, gen="vnet"),
    "wgan_micro2_of_4_step1": dict(batch=4, micro=2, wgan=True, step=1),
    "two_ranks_micro2": dict(batch=2, micro=2, n=2),
}


def _case(name):
    c = CASES[name]
    return (c["batch"], c["micro"], c.get("n", 1), c.get("gen", "resUnet"), c.get("wgan", False),
            c.get("step", 0))


def _jax_models(gen, wgan, dtype=jnp.float32):
    models = tiny_models(deterministic=True, wasserstein=wgan)
    if gen == "vnet":
        for name, role in (("gen_IS", "i2s"), ("gen_SI", "s2i")):
            models[name] = FlaxVNet3D(**_roles(role), output_activation="tanh", layout="NXCYZ",
                                      dtype=dtype)
    return models


def jax_alphas(micro, b, step):
    """The gradient penalty's interpolation weights of slice m of JAX's
    micro step: ``normal(fold_in(fold_in(fold_in(key, m), step), 8 | 9))``."""
    out = []
    for m in range(micro):
        r = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(KEY), m), step)
        out.append({dom: np.array(jax.random.normal(jax.random.fold_in(r, i),
                                                      (b, 1, 1, 1, 1), jnp.float32))
                    for dom, i in (("I", 8), ("S", 9))})
    return out


def _avg_leaf(*xs):
    # jit_microbatch_step's _avg_leaf (vangan_tpu/parallel.py:112-122)
    if jnp.issubdtype(jnp.asarray(xs[0]).dtype, jnp.inexact):
        return sum(xs[1:], start=xs[0]) / len(xs)
    return xs[0]


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax(name, witness=False):
    """JAX's micro step of case ``name``: (config, params, model_state,
    real_I, real_S, summed grads, summed losses, averaged model_state,
    params after the step, the state and key the step started from), once
    per module; with ``witness``, config 4's float64 witness (the V-Nets in
    float64 under ``test_torch_vnet.flax_float64``)."""
    b, micro, n, gen, wgan, step = _case(name)
    cfg = tiny_cfg(BATCH_SIZE=b, micro_batches=micro, N_DEVICES=n, wasserstein=wgan)
    patch = mock.patch.object(fnn, "Dropout", _NoDropout) if wgan else contextlib.nullcontext()
    dtype = jnp.float64 if witness else jnp.float32
    with patch, (flax_float64() if witness else contextlib.nullcontext()):
        fns = make_step_fns(cfg, _jax_models(gen, wgan, dtype), steps_per_epoch=STEPS_PER_EPOCH)
        state = fns.init(jax.random.PRNGKey(0))
        rng = np.random.default_rng(0)
        params = jax.tree_util.tree_map(
            lambda p: p + 0.1 * jnp.asarray(rng.normal(size=p.shape), p.dtype)
            if p.ndim == 1 else p, state.params)
        model_state = dict(state.model_state)
        if gen == "vnet":
            # gen_IS's head off tanh saturation (test_torch_vnet_step's probe):
            # saturated, its float32 tanh sets the gradient in both packages
            params = jax.tree_util.tree_map_with_path(
                lambda path, p: p / 8 if _is_gen_IS_head(path) else p, params)
            model_state["gen_SI"] = {"batch_stats": _stats(model_state["gen_SI"]["batch_stats"],
                                                           rng)}
        state = state.replace(params=params, model_state=model_state,
                              step=jnp.asarray(step, state.step.dtype))
        real_I, real_S = make_batch(rng, cfg)
        g1, g2 = jax.jit(fns.grad_gens_micro), jax.jit(fns.grad_discs_micro)
        key, zero = jax.random.PRNGKey(KEY), jnp.zeros(())
        grads = result = None
        mss = []
        for m in range(micro):
            xI, xS, r = real_I[m::micro], real_S[m::micro], jax.random.fold_in(key, m)
            gg, res, ms, fakes = g1(state.params, state.model_state, state.step, xI, xS, r, zero)
            g = {**gg, **g2(state.params, state.model_state, state.step, xI, xS, r, zero, fakes)}
            mss.append(ms)
            add = functools.partial(jax.tree_util.tree_map, jnp.add)
            grads, result = (g, res) if grads is None else (add(grads, g), add(result, res))
        new_ms = jax.tree_util.tree_map(_avg_leaf, *mss)
        new_state = fns.apply_grads(state, grads, new_ms, jnp.asarray(True))
    return (cfg, _host(params), _host(model_state), np.array(real_I), np.array(real_S),
            _host(grads), {k: float(v) for k, v in result.items()}, _host(new_ms),
            _host(new_state.params), (fns, state))


def _cfg_kw(name):
    b, micro, n, gen, wgan, _ = _case(name)
    return dict(N_DEVICES=n, BATCH_SIZE=b, micro_batches=micro, SUBVOL_PATCH_SIZE=(16, 16, 16),
                compute_dtype="float32", cldice_iters=2, EPOCHS=2, gen_i2s=gen, gen_s2i=gen,
                wasserstein=wgan)


def _gan(name, perturb=0.0):
    """The port's system of case ``name`` with JAX's state loaded (one process)."""
    _, _, _, gen, wgan, step = _case(name)
    _, params, model_state, *_ = _jax(name)
    disc = dict(filters=8, use_dropout=False, use_input_noise=False, use_layer_noise=False,
                wasserstein=wgan, patch_size=(16, 16, 16))
    if gen == "vnet":
        gens = [VNet3D(**_roles(role), output_activation="tanh") for role in ("i2s", "s2i")]
    else:
        g = torch.Generator().manual_seed(0)
        gens = [ResUNet3D(4, 2, "simple", generator=g) for _ in range(2)]
    models = {"gen_IS": gens[0], "gen_SI": gens[1], "disc_I": PatchGANDiscriminator3D(**disc),
              "disc_S": PatchGANDiscriminator3D(**disc)}
    gan = VanGan(VanGanConfig(**_cfg_kw(name)), device="cpu", models=models,
                 steps_per_epoch=STEPS_PER_EPOCH)
    load_flax_networks(gan, params, model_state)
    for net in ("disc_I", "disc_S"):
        gan.nets[net].w_dropout = 0.0
    gan.state.step = step
    if perturb:
        g = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for net in gan.nets.values():
                for p in net.parameters():
                    p.mul_(1 + perturb * torch.randn(p.shape, generator=g))
    return gan


@contextlib.contextmanager
def jax_penalty_weights(name):
    """The port's gradient penalty given JAX's weights of each slice, in the
    order the step calls it (disc_I, then disc_S, slice by slice)."""
    b, micro, _, _, wgan, step = _case(name)
    if not wgan:
        yield
        return
    alphas = [torch.from_numpy(a[dom]) for a in jax_alphas(micro, b // micro, step)
              for dom in ("I", "S")]
    real_gp, calls = torch_step.gradient_penalty, iter(alphas)

    def gp(scales, disc_apply, real, fake, generator=None, alpha=None):
        return real_gp(scales, disc_apply, real, fake, generator, alpha=next(calls))

    with mock.patch.object(torch_step, "gradient_penalty", gp):
        yield


def _port_grads(gan, name):
    _, _, _, real_I, real_S, *_ = _jax(name)
    gp = gan.cfg.gp_weight if gan.cfg.wasserstein and gan.state.step > 0 else 0.0
    with jax_penalty_weights(name):
        return torch_step.compute_grads(gan.nets, gan.cfg, gan.scales, torch.from_numpy(real_I),
                                        torch.from_numpy(real_S), 0.0, gan.generator,
                                        gp_scale=gp, micro=gan.cfg.micro_batches)


def _as_flax(net, tensors):
    """Tensors in ``net.parameters()`` order, or one flat vector of them, as
    a flax tree."""
    if isinstance(tensors, torch.Tensor):
        tensors = tensors.split([p.numel() for p in net.parameters()])
    return torch_to_flax({n: t.view_as(p) for (n, p), t in zip(net.named_parameters(), tensors)},
                         net)


def _flat_port(net, tensors):
    return _flat(_as_flax(net, tensors))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _flat(tree):
    return np.concatenate([v.ravel() for _, v in sorted(_leaves(tree).items())])


@functools.lru_cache(maxsize=None)
def _port(name):
    """The port's gradients, losses and moved state_dicts of one micro
    forward, and each network's spread under a 1e-6 weight perturbation."""
    gan = _gan(name)
    grads, result = _port_grads(gan, name)
    flat = {n: _flat_port(gan.nets[n], grads[n]) for n in NETWORKS}
    moved = _gan(name, perturb=1e-6)
    pgrads, _ = _port_grads(moved, name)
    spread = {n: np.linalg.norm(_flat_port(gan.nets[n], pgrads[n]) - flat[n]) /
              np.linalg.norm(flat[n]) for n in NETWORKS}
    states = {n: gan.nets[n].state_dict() for n in NETWORKS}
    return gan, flat, {k: float(v) for k, v in result.items()}, states, spread


def _assert_grads_match(got, name, net_name, spread):
    want = _flat(_jax(name)[5][net_name])
    assert got.shape == want.shape
    gap = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"{name} {net_name}: {gap:.3e} from JAX, spread {spread:.3e}")
    assert gap <= max(2e-3, SPREAD_FACTOR * spread), (gap, spread)


LOCAL = [c for c in CASES if CASES[c].get("n", 1) == 1]
# config 4's gen_IS in float32 (ROADMAP Queue 3): JAX's own float32
# step is ~1.6e-2 from the float64 witness, and the port's 2.2e-2 from JAX's
# (its spread 1.4e-3), so it is held to the witness in float64 instead, with
# its head off tanh saturation as test_torch_vnet_step's probe
F32_CONDITIONED = {("config4_micro2_of_4", "gen_IS")}


@pytest.mark.parametrize("name,net", [(name, net) for name in LOCAL for net in NETWORKS
                                      if (name, net) not in F32_CONDITIONED])
def test_micro_gradients_match_jax(name, net):
    """The summed gradients of the slices against JAX's (config 4's gen_IS
    against the float64 witness, ``test_config4_micro_gradients_match_the_float64_witness``)."""
    _, flat, _, _, spread = _port(name)
    _assert_grads_match(flat[net], name, net, spread[net])


@pytest.mark.parametrize("net", NETWORKS)
def test_config4_micro_gradients_match_the_float64_witness(net):
    """Config 4's slices in float64, the port against JAX's micro step with
    the V-Nets in float64 (the discriminators cast to float32 inside, in
    both): within 1e-4 relative L2, as ``test_torch_vnet_step``'s tight rule."""
    name = "config4_micro2_of_4"
    gan = _gan(name)
    for module in gan.nets.values():
        module.double()
        module.dtype = torch.float64
    _, _, _, real_I, real_S, *_ = _jax(name)
    grads, _ = torch_step.compute_grads(
        gan.nets, gan.cfg, gan.scales, torch.from_numpy(real_I).double(),
        torch.from_numpy(real_S).double(), 0.0, gan.generator, micro=gan.cfg.micro_batches)
    got = _flat_port(gan.nets[net], [g.float() for g in grads[net]])
    want = _flat(_jax(name, witness=True)[5][net])
    gap = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"{name} {net}: {gap:.3e} from the float64 witness")
    assert gap <= 1e-4, gap


@pytest.mark.parametrize("name", LOCAL)
def test_micro_losses_match_jax(name):
    """The loss dict summed over the slices (clDice per slice at λ/micro)."""
    want = _jax(name)[6]
    got = _port(name)[2]
    assert sorted(got) == sorted(want)
    for key in RESULT_KEYS:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)


def test_config4_micro_batch_stats_match_jax():
    """gen_SI's BatchNorm statistics after the slices: each slice starts
    from the step's statistics, which end at the mean of the slices'."""
    name = "config4_micro2_of_4"
    gan, _, _, states, _ = _port(name)
    got = _leaves(torch_to_flax_variables(states["gen_SI"], gan.nets["gen_SI"])["batch_stats"])
    want = _leaves(_jax(name)[7]["gen_SI"]["batch_stats"])
    before = _leaves(_jax(name)[2]["gen_SI"]["batch_stats"])
    assert sorted(got) == sorted(want) and got
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=1e-4, atol=1e-6, err_msg=key)
        assert not np.allclose(w, before[key]), key  # the step moved them


@pytest.mark.parametrize("name", LOCAL)
def test_micro_train_step_matches_jax(name):
    """One ``distributed_train_step``: the summed losses, the parameters
    after the one update and (config 4) the averaged statistics."""
    cfg, _, _, real_I, real_S, grads, want_losses, want_ms, want_params, _ = _jax(name)
    _, port_flat, *_ = _port(name)
    gan = _gan(name)
    with jax_penalty_weights(name):
        result = gan.distributed_train_step(real_I, real_S, 0.0, True)
    assert gan.state.counts == {n: 1 for n in NETWORKS}
    for key in RESULT_KEYS:
        np.testing.assert_allclose(float(result[key]), want_losses[key], rtol=1e-4, err_msg=key)
    for n in NETWORKS:
        net = gan.nets[n]
        variables = torch_to_flax_variables(net.state_dict(), net)
        got, g, want = _leaves(variables["params"]), _leaves(grads[n]), _leaves(want_params[n])
        _assert_params(got, g, port_flat[n], want, n)
        if "batch_stats" in want_ms[n]:
            for key, w in _leaves(want_ms[n]["batch_stats"]).items():
                np.testing.assert_allclose(_leaves(variables["batch_stats"])[key], w,
                                           rtol=1e-4, atol=1e-6, err_msg=f"{n}{key}")


def _assert_params(got, g, port_flat, want, n):
    """atol 1e-7 where both gradients agree in sign to 1e-3 and exceed 1e-3
    max |g| (``test_torch_parallel``'s rule)."""
    keys = sorted(g)
    sizes = np.cumsum([0] + [g[k].size for k in keys])
    g_port = {k: port_flat[a:b].reshape(g[k].shape) for k, a, b in zip(keys, sizes, sizes[1:])}
    gmax = max(np.abs(v).max() for v in g.values())
    checked = 0
    for key, w in want.items():
        mask = ((np.abs(g[key]) > 1e-3 * gmax) & (np.sign(g[key]) == np.sign(g_port[key]))
                & (np.abs(g[key] - g_port[key]) <= 1e-3 * np.abs(g[key])))
        checked += int(mask.sum())
        np.testing.assert_allclose(got[key][mask], w[mask], rtol=0, atol=1e-7,
                                   err_msg=f"{n}{key}")
    assert checked > 0, n


def test_replica_is_jax_microbatch_step():
    """This module's JAX side is ``jit_microbatch_step``: its parameters and
    loss dict after one step from the same state and key."""
    name = "micro3_of_3"
    cfg, _, _, real_I, real_S, _, want_losses, _, want_params, (fns, state) = _jax(name)
    step = jit_microbatch_step(fns, make_mesh(1), cfg.micro_batches, donate=False)
    new_state, result = step(state, jnp.asarray(real_I), jnp.asarray(real_S),
                             jax.random.PRNGKey(KEY), jnp.zeros(()), jnp.asarray(True))
    for key, w in want_losses.items():
        np.testing.assert_allclose(float(result[key]), w, rtol=1e-6, err_msg=key)
    for n in NETWORKS:
        got, want = _leaves(new_state.params[n]), _leaves(want_params[n])
        for key, w in want.items():
            np.testing.assert_allclose(got[key], w, rtol=1e-5, atol=1e-7, err_msg=f"{n}{key}")


def test_micro_scales_compose_with_the_ranks():
    """``for_rank(k).for_micro(m)``: batch G/k, n_devices N/(k m), λ/m and
    the rank's groups, pinned; ``for_micro`` alone keeps the configured
    groups where the default would follow n_devices."""
    base = LossScales(global_batch_size=12, n_devices=4, lambda_topology=5.0, cldice_groups=4)
    s = base.for_rank(4).for_micro(3)
    assert (s.global_batch_size, s.n_devices, s.lambda_topology, s.groups) == (3, 1 / 3, 5 / 3, 1)
    one = LossScales(global_batch_size=3, n_devices=1).for_micro(3)
    assert (one.n_devices, one.groups, one.global_batch_size) == (1 / 3, 1, 3)


@pytest.mark.parametrize("world,micro,batch", [(2, 2, 2), (2, 2, 4), (4, 3, 3), (3, 2, 4)])
def test_rank_rows_follow_jax_micro_then_shard_order(world, micro, batch):
    """JAX takes slice m of the global batch, then shards it contiguously
    over the devices; rank r's contiguous rows, sliced ``[m::micro]`` on the
    rank, are the same samples in the same order."""
    g = world * batch
    for r in range(world):
        mine = np.arange(g)[parallel.rows(Group(r, world, "cpu", pg=object()), g)]
        for m in range(micro):
            jax_slice = np.arange(g)[m::micro]
            shard = np.split(jax_slice, world)[r]
            np.testing.assert_array_equal(mine[m::micro], shard)


@pytest.mark.parametrize("name", ["micro2_of_4", "config4_micro2_of_4"])
def test_micro_one_is_the_parents_step(name):
    """``micro_batches: 1`` runs the batch as one slice: the same gradients,
    losses and float buffers (config 4's BatchNorm statistics), bit for bit,
    as the one-backward step written out."""
    _, _, _, real_I, real_S, *_ = _jax(name)
    x, y = torch.from_numpy(real_I), torch.from_numpy(real_S)
    gan = _gan(name)
    gan.cfg.micro_batches = 1
    grads, result = torch_step.compute_grads(gan.nets, gan.cfg, gan.scales, x, y, 0.0,
                                             torch.Generator().manual_seed(3))
    buffers = {n: [b.clone() for b in gan.nets[n].buffers()] for n in NETWORKS}
    parent = _gan(name)
    total, want = torch_step.compute_losses(parent.nets, parent.cfg, parent.scales, x, y,
                                            train=True, noise_std=0.0,
                                            generator=torch.Generator().manual_seed(3))
    total.backward()
    for n in NETWORKS:
        for got, p in zip(grads[n], parent.nets[n].parameters()):
            assert torch.equal(got, p.grad), n
        for got, b in zip(buffers[n], parent.nets[n].buffers()):
            assert torch.equal(got, b), n
    assert any(len(v) for v in buffers.values()) == (name == "config4_micro2_of_4")
    for key, v in want.items():
        assert torch.equal(result[key], v.detach()), key


def test_batch_not_divisible_by_micro_raises():
    with pytest.raises(ValueError, match="micro_batches"):
        VanGanConfig(BATCH_SIZE=3, micro_batches=2)
    for bad in (0, -2):
        with pytest.raises(ValueError, match="must be at least 1"):
            VanGanConfig(BATCH_SIZE=4, micro_batches=bad)
    assert VanGanConfig(BATCH_SIZE=4, micro_batches=2).micro_batches == 2


@pytest.fixture(scope="module")
def ranks():
    """Two gloo ranks of case ``two_ranks_micro2``: each rank's averaged
    gradients and losses, then one step (``torch_dp_worker.step_rank``)."""
    name = "two_ranks_micro2"
    _, params, model_state, real_I, real_S, *_ = _jax(name)
    gan = _gan(name)
    states = {n: gan.nets[n].state_dict() for n in NETWORKS}
    kw = {k: v for k, v in _cfg_kw(name).items() if k not in ("gen_i2s", "gen_s2i")}
    jobs = {"step": ("step_rank", dict(cfg_kw=kw, states=states, real_I=real_I,
                                       real_S=real_S))}
    return parallel.spawn(worker.run, 2, (jobs,), device="cpu", timeout=TIMEOUT_S)


@pytest.mark.parametrize("net", NETWORKS)
def test_two_ranks_micro_gradients_match_jax(ranks, net):
    """Two ranks x two slices against JAX's N_DEVICES=2 micro step: the
    averaged gradient of the slices' sums, equal on both ranks."""
    name = "two_ranks_micro2"
    gan = _gan(name)
    got = [r["step"]["grads"][net] for r in ranks]
    assert torch.equal(got[0], got[1])
    _assert_grads_match(_flat_port(gan.nets[net], got[0]), name, net, _port(name)[4][net])


def test_two_ranks_micro_train_step_matches_jax(ranks):
    name = "two_ranks_micro2"
    _, _, _, _, _, grads, want_losses, _, want_params, _ = _jax(name)
    gan = _gan(name)
    for r in ranks:
        assert not r["jax_imported"]
        assert r["step"]["counts"] == {n: 1 for n in NETWORKS}
        for key in RESULT_KEYS:
            for got in (r["step"]["losses"][key], r["step"]["step_losses"][key]):
                np.testing.assert_allclose(got, want_losses[key], rtol=1e-4, err_msg=key)
    for n in NETWORKS:
        net = gan.nets[n]
        assert torch.equal(ranks[0]["step"]["params"][n], ranks[1]["step"]["params"][n])
        got = _leaves(_as_flax(net, ranks[0]["step"]["params"][n]))
        port_flat = _flat_port(net, ranks[0]["step"]["grads"][n])
        _assert_params(got, _leaves(grads[n]), port_flat, _leaves(want_params[n]), n)


def test_micro_batches_comes_from_a_jax_yaml(tmp_path):
    """A YAML the JAX package writes with ``micro_batches: 3`` trains in 3
    slices in the port (the field was once dropped on load)."""
    from vangan_tpu.config import VanGanConfig as JaxConfig

    path = str(tmp_path / "cfg.yaml")
    JaxConfig(BATCH_SIZE=3, micro_batches=3, output_dir=str(tmp_path)).to_yaml(path)
    assert VanGanConfig.from_yaml(path).micro_batches == 3


def test_test_step_stays_one_full_batch_call():
    """The validation and test step ignores ``micro_batches``, as
    ``jit_test_step``: the same losses, bit for bit."""
    name = "micro2_of_4"
    _, _, _, real_I, real_S, *_ = _jax(name)
    gan = _gan(name)
    micro = gan.distributed_test_step(real_I, real_S)
    gan.cfg.micro_batches = 1
    one = gan.distributed_test_step(real_I, real_S)
    for key in RESULT_KEYS:
        assert torch.equal(micro[key], one[key]), key
