"""The port's train step (``VanGan.distributed_train_step``) against the JAX
package's, and on its own.

At ``test_train_step.tiny_cfg`` (batch 2, 16^3, generators f=4 with 2
levels, discriminators f=8, clDice with 2 iterations), in float32 on the
CPU, where every op of the port takes its plain version. For the comparisons
with JAX the models are deterministic (``tiny_models(deterministic=True)``:
no noise, no dropout, whose random draws differ between the frameworks) and
the port loads the JAX init with its 1-D leaves perturbed. Tolerances:

- each network's backward at identical inputs (parameters and input
  cotangent of a generator and a discriminator application, the seg
  cycle's loss terms): rtol 2e-4 and atol 1e-5 * max |g| of the network;
- the four restricted gradients of one backward against the port's own four
  independent backwards: the same;
- the four restricted gradients against ``jax.grad(fns.compute_losses)``:
  relative L2 error of each network's flat gradient <= 2e-3, and of each
  leaf <= 3e-3 plus the atol above over the leaf's size. Not the rtol 2e-4
  per element of the identical-inputs tests: the two frameworks' float32
  forwards of these random-init networks differ by up to 1e-4 (binary
  input), and the step's gradient is not smooth in the forward values
  (ReLU, min/max routing in the skeleton and the min-max normalisation).
  A float64 run cannot separate the two, since the JAX package casts to
  float32 inside (resunet.py:122, discriminator.py:110, layers.py:294-296,
  ssim.py:82-83). The second witness is the port's own conditioning: every
  leaf is closer to JAX than the port's gradient moves when all weights
  move by 1e-5 relative (gen_IS moves by 3e-2, gen_SI 3e-3);
- losses: rtol 1e-4 (as the test step);
- parameters after one Adam step: atol 1e-7 where both gradients have one
  sign and |g| > 1e-3 * max |g| of the network (a step-1 Adam update is
  about lr * sign(g), so elements with g near 0 may flip sign between
  implementations).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_train_step import make_batch, tiny_cfg, tiny_models

from vangan_tpu.training.step import make_step_fns
from vangan_torch.config import VanGanConfig
from vangan_torch.losses import (
    cycle_loss,
    cycle_reconstruction,
    cycle_seg_loss,
    discriminator_loss_fn,
    generator_loss_fn,
)
from vangan_torch.models.discriminator import PatchGANDiscriminator3D
from vangan_torch.models.resunet import ResUNet3D
from vangan_torch.training import step as torch_step
from vangan_torch.training.state import NETWORKS
from vangan_torch.training.step import RESULT_KEYS
from vangan_torch.vangan import VanGan, train
from vangan_torch.weights import load_flax_networks, torch_to_flax

STEPS_PER_EPOCH = 3


@functools.lru_cache(maxsize=None)
def _jax_step():
    """(config, perturbed params, real_I, real_S, JAX grads, JAX losses, JAX
    params after one step), computed once per module run."""
    jax_cfg = tiny_cfg()
    rng = np.random.default_rng(0)
    fns = make_step_fns(jax_cfg, tiny_models(deterministic=True),
                        steps_per_epoch=STEPS_PER_EPOCH)
    state = fns.init(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(
        lambda p: p + 0.1 * jnp.asarray(rng.normal(size=p.shape), p.dtype)
        if p.ndim == 1 else p, state.params)
    state = state.replace(params=params)
    real_I, real_S = make_batch(rng, jax_cfg)
    grads, (result, new_ms) = jax.grad(fns.compute_losses, argnums=0, has_aux=True)(
        params, state.model_state, real_I, real_S, jax.random.PRNGKey(7), jnp.zeros(()), True,
        None)
    new_state = fns.apply_grads(state, grads, new_ms, jnp.asarray(True))
    host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return (jax_cfg, params, np.array(real_I), np.array(real_S), host(grads),
            {k: float(v) for k, v in result.items()}, host(new_state.params))


def _torch_gan(jax_cfg, params=None, deterministic=True, seed=0):
    cfg = VanGanConfig(N_DEVICES=jax_cfg.N_DEVICES, BATCH_SIZE=jax_cfg.BATCH_SIZE,
                       SUBVOL_PATCH_SIZE=jax_cfg.SUBVOL_PATCH_SIZE, compute_dtype="float32",
                       cldice_iters=jax_cfg.cldice_iters, EPOCHS=jax_cfg.EPOCHS, seed=seed,
                       cycle_loss_I_type=jax_cfg.cycle_loss_I_type,
                       lambda_topology=jax_cfg.lambda_topology)
    on = not deterministic
    disc = dict(filters=8, use_dropout=on, use_input_noise=on, use_layer_noise=on)
    g = torch.Generator().manual_seed(seed)
    models = {"gen_IS": ResUNet3D(4, 2, "simple", generator=g),
              "gen_SI": ResUNet3D(4, 2, "simple", generator=g),
              "disc_I": PatchGANDiscriminator3D(**disc, generator=g),
              "disc_S": PatchGANDiscriminator3D(**disc, generator=g)}
    gan = VanGan(cfg, device="cpu", models=models, steps_per_epoch=STEPS_PER_EPOCH)
    if params is not None:
        load_flax_networks(gan, params)
    return gan


def _as_flax(net, tensors):
    """A list of tensors in ``net.parameters()`` order as a flax tree."""
    return torch_to_flax(dict(zip((n for n, _ in net.named_parameters()), tensors)), net)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _flat(tree):
    return np.concatenate([v.ravel() for _, v in sorted(_leaves(tree).items())])


def _assert_grads_close(got, want, rtol=2e-4):
    """Per leaf: rtol and atol 1e-5 * max |g| over the whole network."""
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    atol = 1e-5 * max(np.abs(w).max() for w in want.values())
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=rtol, atol=atol, err_msg=key)


@pytest.fixture(scope="module")
def port_grads():
    jax_cfg, params, real_I, real_S, *_ = _jax_step()
    gan = _torch_gan(jax_cfg, params)
    grads, result = torch_step.compute_grads(
        gan.nets, gan.cfg, gan.scales, torch.from_numpy(real_I), torch.from_numpy(real_S),
        0.0, gan.generator)
    return gan, grads, result


@pytest.fixture(scope="module")
def perturbed_grads():
    """The port's gradients with every weight scaled by (1 + 1e-5 N(0, 1))."""
    jax_cfg, params, real_I, real_S, *_ = _jax_step()
    gan = _torch_gan(jax_cfg, params)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for net in gan.nets.values():
            for p in net.parameters():
                p.mul_(1 + 1e-5 * torch.randn(p.shape, generator=g))
    grads, _ = torch_step.compute_grads(
        gan.nets, gan.cfg, gan.scales, torch.from_numpy(real_I), torch.from_numpy(real_S),
        0.0, gan.generator)
    return grads


def _leaf_gaps(port_grads, name, other):
    """Per leaf: (|port - JAX|, |port - other|, atol * sqrt(size), |JAX|), L2."""
    gan, grads, _ = port_grads
    got = _leaves(_as_flax(gan.nets[name], grads[name]))
    want = _leaves(_jax_step()[4][name])
    other = _leaves(_as_flax(gan.nets[name], other)) if other is not None else got
    atol = 1e-5 * max(np.abs(w).max() for w in want.values())
    return {k: (np.linalg.norm(got[k] - w), np.linalg.norm(got[k] - other[k]),
                atol * np.sqrt(w.size), np.linalg.norm(w)) for k, w in want.items()}


@pytest.mark.parametrize("name", NETWORKS)
def test_one_backward_matches_jax_grad(port_grads, name):
    """The four restricted gradients of the port's one backward against
    jax.grad of the JAX package's combined scalar (see the module note)."""
    gan, grads, _ = port_grads
    got, want = _flat(_as_flax(gan.nets[name], grads[name])), _flat(_jax_step()[4][name])
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) <= 2e-3 * np.linalg.norm(want)
    for key, (gap, _, atol, norm) in _leaf_gaps(port_grads, name, None).items():
        assert gap <= 3e-3 * norm + atol, key


@pytest.mark.parametrize("name", NETWORKS)
def test_jax_gap_is_within_float32_conditioning(port_grads, perturbed_grads, name):
    """Each leaf's distance to JAX is at most what a 1e-5 relative weight
    perturbation moves the port's own gradient (the module note)."""
    for key, (gap, spread, atol, _) in _leaf_gaps(port_grads, name,
                                                  perturbed_grads[name]).items():
        assert gap <= spread + atol, key


@pytest.mark.parametrize("name", NETWORKS)
def test_network_backward_matches_jax_at_identical_inputs(rng, name):
    """One application of each generator (on normal data: binary input makes
    its float32 forward ill-conditioned, see the module note) and each
    discriminator (on a tanh fake), with its parameters and its input
    differentiated, against jax.vjp of the JAX network."""
    jax_cfg, params, _, real_S, *_ = _jax_step()
    gan = _torch_gan(jax_cfg, params)
    model = tiny_models(deterministic=True)[name]
    x = rng.normal(size=real_S.shape).astype(np.float32)
    gen = name.startswith("gen")
    if not gen:
        x = np.tanh(x)
    kw = {} if gen else {"noise_std": 0.0}
    y, vjp = jax.vjp(lambda p, a: model.apply({"params": p}, a, train=True, **kw),
                     params[name], jnp.asarray(x))
    gy = rng.normal(size=y.shape).astype(np.float32)
    want_p, want_x = vjp(jnp.asarray(gy))
    xt = torch.from_numpy(x).requires_grad_()
    net = gan.nets[name]
    out = net(xt) if gen else net(xt, True, 0.0, gan.generator)
    got = torch.autograd.grad(out, [xt, *net.parameters()], torch.from_numpy(gy))
    _assert_grads_close(_as_flax(net, got[1:]), jax.tree_util.tree_map(np.asarray, want_p))
    want_x = np.asarray(want_x)
    np.testing.assert_allclose(got[0].numpy(), want_x, rtol=2e-4,
                               atol=1e-5 * np.abs(want_x).max())


def test_one_backward_matches_four_independent_backwards():
    """The reference semantics (vangan.py:394-438): four losses without any
    detach, each differentiated only w.r.t. its own network, with the default
    loss set (BCE + clDice seg cycle)."""
    jax_cfg, params, real_I, real_S, *_ = _jax_step()
    jax_cfg = tiny_cfg()
    gan = _torch_gan(jax_cfg, params)
    x, y = torch.from_numpy(real_I), torch.from_numpy(real_S)
    grads, _ = torch_step.compute_grads(gan.nets, gan.cfg, gan.scales, x, y, 0.0, gan.generator)
    nets, sc = gan.nets, gan.scales
    fake_S, fake_I = nets["gen_IS"](x), nets["gen_SI"](y)
    cycled_S, cycled_I = nets["gen_IS"](fake_I), nets["gen_SI"](fake_S)
    d = lambda name, v: nets[name](v, True, 0.0, gan.generator)  # noqa: E731
    losses = {
        "gen_IS": generator_loss_fn(sc, d("disc_S", fake_S))
        + cycle_loss(sc, y, cycled_S, typ="bce") + cycle_seg_loss(sc, y, cycled_S),
        "gen_SI": generator_loss_fn(sc, d("disc_I", fake_I))
        + cycle_loss(sc, x, cycled_I, typ="mse") + cycle_reconstruction(sc, x, cycled_I),
        "disc_I": discriminator_loss_fn(sc, d("disc_I", x), d("disc_I", fake_I)),
        "disc_S": discriminator_loss_fn(sc, d("disc_S", y), d("disc_S", fake_S)),
    }
    for name in NETWORKS:
        want = torch.autograd.grad(losses[name], list(nets[name].parameters()),
                                   retain_graph=True, allow_unused=True)
        for g, w, (pname, p) in zip(grads[name], want, nets[name].named_parameters()):
            w = torch.zeros_like(p) if w is None else w
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-4,
                                       atol=1e-5 * float(w.abs().max()) + 1e-12,
                                       err_msg=f"{name}.{pname}")


def test_train_step_matches_jax(port_grads):
    """One distributed_train_step: the ten losses and the updated parameters."""
    jax_cfg, params, real_I, real_S, grads, want_losses, want_params = _jax_step()
    gan = _torch_gan(jax_cfg, params)
    result = gan.distributed_train_step(real_I, real_S, 0.0, True)
    assert sorted(result) == sorted(RESULT_KEYS) and gan.state.step == 1
    for key in RESULT_KEYS:
        np.testing.assert_allclose(float(result[key]), want_losses[key], rtol=1e-4, err_msg=key)
    _, port, _ = port_grads
    for name in NETWORKS:
        got = _leaves(torch_to_flax(gan.nets[name].state_dict(), gan.nets[name]))
        want, g = _leaves(want_params[name]), _leaves(grads[name])
        g_port = _leaves(_as_flax(gan.nets[name], port[name]))
        gmax = max(np.abs(v).max() for v in g.values())
        assert gan.state.counts[name] == 1
        for key, w in want.items():
            mask = (np.abs(g[key]) > 1e-3 * gmax) & (np.sign(g[key]) == np.sign(g_port[key]))
            np.testing.assert_allclose(got[key][mask], w[mask], rtol=0, atol=1e-7,
                                       err_msg=f"{name}{key}")


@pytest.mark.parametrize("term", ["bce", "cldice"])
def test_seg_cycle_loss_grads_match_jax(rng, term):
    """The seg cycle's BCE and Dice + clDice gradients w.r.t. one tanh-like
    prediction, in both frameworks: relative L2 error <= 1e-4."""
    import vangan_tpu.losses as jax_losses
    import vangan_torch.losses as torch_losses

    pred = np.tanh(rng.normal(size=(2, 16, 16, 16, 1)) * 2).astype(np.float32)
    real = np.where(rng.uniform(size=pred.shape) > 0.7, 1.0, -1.0).astype(np.float32)
    if term == "bce":
        fn = lambda L, s, r, p: L.cycle_loss(s, r, p, typ="bce")  # noqa: E731
    else:
        fn = lambda L, s, r, p: L.cycle_seg_loss(s, r, p)  # noqa: E731
    js = jax_losses.LossScales(global_batch_size=2, n_devices=1, cldice_iters=2)
    want = np.asarray(jax.grad(lambda p: fn(jax_losses, js, jnp.asarray(real), p))(
        jnp.asarray(pred)))
    t = torch.from_numpy(pred).requires_grad_()
    ts = torch_losses.LossScales(global_batch_size=2, n_devices=1, cldice_iters=2)
    fn(torch_losses, ts, torch.from_numpy(real), t).backward()
    assert np.linalg.norm(t.grad.numpy() - want) <= 1e-4 * np.linalg.norm(want)


def _snapshot(gan, names):
    """Per network: (parameters, Adam moments, updates taken)."""
    return {n: ([p.detach().clone() for p in gan.nets[n].parameters()],
                [t.clone() for s in gan.state.opt[n].state.values()
                 for t in (s["exp_avg"], s["exp_avg_sq"])], gan.state.counts[n])
            for n in names}


def test_update_gen_false_freezes_the_generators():
    jax_cfg, _, real_I, real_S, *_ = _jax_step()
    gan = _torch_gan(jax_cfg, deterministic=False)
    gan.distributed_train_step(real_I, real_S, 0.1, True)  # non-zero optimizer states
    before = _snapshot(gan, NETWORKS)
    gan.distributed_train_step(real_I, real_S, 0.1, False)
    after = _snapshot(gan, NETWORKS)
    for name in ("gen_IS", "gen_SI"):
        (p0, m0, c0), (p1, m1, c1) = before[name], after[name]
        assert c0 == c1 == 1 and len(m0) == len(m1) == 2 * len(p0)
        assert all(torch.equal(a, b) for a, b in zip(m0, m1))
        assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    for name in ("disc_I", "disc_S"):
        assert after[name][2] == 2
        assert any(not torch.equal(a, b) for a, b in zip(before[name][0], after[name][0]))
    assert gan.state.step == 2


class _Summary:
    def __init__(self):
        self.calls = []

    def scalar(self, name, value, epoch, training=True):
        self.calls.append((name, value, epoch, training))


def test_train_takes_steps_batches_and_summarises():
    jax_cfg, _, real_I, real_S, *_ = _jax_step()
    gan = _torch_gan(jax_cfg, deterministic=False)
    batches = iter([(real_I, real_S)] * 3)
    summary = _Summary()
    results = train(batches, gan, summary, epoch=1, steps=2, training=True, noise_std=0.05)
    assert next(batches)  # the third batch was not taken
    assert gan.state.step == 2 and all(c == 2 for c in gan.state.counts.values())
    assert sorted(results) == sorted(RESULT_KEYS) and all(len(v) == 2 for v in results.values())
    assert sorted(c[0] for c in summary.calls) == sorted(RESULT_KEYS)
    for name, value, epoch, training in summary.calls:
        assert (epoch, training) == (1, True) and np.isfinite(value)
        np.testing.assert_allclose(value, np.mean(results[name]), rtol=1e-6)


def test_train_step_is_seeded_with_noise_on():
    """Two VanGans from one seed take the same step with noise and dropout on;
    every parameter of every network moves and stays finite."""
    jax_cfg, _, real_I, real_S, *_ = _jax_step()
    runs = []
    for _ in range(2):
        gan = _torch_gan(jax_cfg, deterministic=False, seed=4)
        before = _snapshot(gan, NETWORKS)
        runs.append((gan.distributed_train_step(real_I, real_S, 0.1, True), gan, before))
    (r0, g0, b0), (r1, g1, _) = runs
    assert all(torch.equal(r0[k], r1[k]) for k in RESULT_KEYS)
    for name in NETWORKS:
        for a, b, p0 in zip(g0.nets[name].parameters(), g1.nets[name].parameters(),
                            b0[name][0]):
            assert torch.equal(a, b) and torch.isfinite(a).all()
        assert any(not torch.equal(a, p0) for a, p0 in zip(g0.nets[name].parameters(),
                                                             b0[name][0]))


def test_train_defaults_to_training_in_both_packages():
    """``train`` without ``training`` trains, in the JAX package and in the
    port: from the same init (noise and dropout off), two of three offered
    batches are taken as train steps by both, with the same losses and
    parameters after them.

    Tolerances: both steps' losses rtol 1e-4 (as the step above; measured
    up to 1.4e-5 on the second step); the parameters' moves over the two
    steps within 5% relative L2 per network of the JAX package's moves
    (measured 0.6-2.7%: a step-1 Adam update is about lr * sign(g), and
    elements with g near 0 may take opposite signs in the two
    frameworks)."""
    from vangan_tpu.vangan import VanGan as JaxVanGan
    from vangan_tpu.vangan import train as jax_train

    jax_cfg = tiny_cfg()
    _, _, real_I, real_S, *_ = _jax_step()
    jax_gan = JaxVanGan(jax_cfg, steps_per_epoch=STEPS_PER_EPOCH, init_rng=jax.random.PRNGKey(3),
                        models=tiny_models(deterministic=True))
    init = jax.tree_util.tree_map(np.asarray, jax.device_get(jax_gan.state.params))
    gan = _torch_gan(jax_cfg, init)
    runs = {}
    for tag, fn, g in (("jax", jax_train, jax_gan), ("torch", train, gan)):
        batches = iter([(real_I, real_S)] * 3)
        summary = _Summary()
        runs[tag] = fn(batches, g, summary, epoch=0, steps=2)
        assert next(batches)  # the third batch was not taken
        assert all(training for *_, training in summary.calls)
    assert int(jax_gan.state.step) == 2 and gan.state.step == 2
    assert sorted(runs["jax"]) == sorted(runs["torch"]) == sorted(RESULT_KEYS)
    for key in RESULT_KEYS:
        want, got = runs["jax"][key], runs["torch"][key]
        assert len(want) == len(got) == 2
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=key)
    after = jax.tree_util.tree_map(np.asarray, jax.device_get(jax_gan.state.params))
    for name in NETWORKS:
        got = _flat(torch_to_flax(gan.nets[name].state_dict(), gan.nets[name]))
        want, start = _flat(after[name]), _flat(init[name])
        assert np.linalg.norm(want - start) > 0
        assert np.linalg.norm(got - want) <= 0.05 * np.linalg.norm(want - start), name
