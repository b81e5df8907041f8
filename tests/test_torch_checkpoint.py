"""Checkpoints of the port (``vangan_torch.checkpoint``, ``VanGan.save_checkpoint``
and ``load_checkpoint``) and the carrying of a JAX train state
(``weights.load_flax_train_state``), against the JAX package.

At ``test_train_step.tiny_cfg`` (batch 2, 16^3, generators f=4 with 2
levels, discriminators f=8, clDice with 2 iterations), float32, on the CPU.

- A save and load restores every tensor exactly, and resuming (k steps,
  save, load into a fresh ``VanGan``, n - k steps, with the noise
  generator's state copied across, since it is not checkpointed, as in JAX)
  equals n straight steps bit for bit, with noise and dropout on.
- The missing-file and mismatch cases behave as ``vangan_tpu.checkpoint``'s.
- A JAX state after 2 steps (noise and dropout off), carried by
  ``load_flax_train_state`` from either optimizer layout (``flatten_opt``
  True: one raveled vector per network; False: a per-leaf tree), gives the
  same Adam moments, counts and step bit for bit after the layout map
  (JAX's own ``ravel_pytree`` unravels the flat vector here, independently
  of the port's; the per-leaf state is the same run's, so JAX's step is
  compiled once). One more step on each side: each network's parameter
  update within 1e-4 relative L2 of JAX's on the elements whose gradient
  carries signal (|g| > 1e-3 max |g|, as ``test_torch_train_step.py``
  masks; measured 2.2e-5 at most), on the other elements no larger on
  either side than Adam's largest step at that LR, and over the whole
  network within 3x
  the port's own update spread when every weight moves by 1e-5 relative
  (measured 6.3e-3 to 2.0e-2 against spreads of 5.9e-3 to 1.8e-2). The
  whole-network figure misses 1e-2 for the generators: a bias whose
  per-channel shift the next InstanceNorm removes has a gradient of exactly
  0 in exact arithmetic, so its computed gradient is rounding noise, which
  Adam scales up to steps of the LR's size with either sign in either
  framework.
- A bundle of the port's ``export_models`` loads in the JAX package's
  ``load_exported``, and the reverse, with outputs within atol 1e-4 (the
  tolerance of ``test_torch_resunet.py``).
- BASELINE config 4 (V-Net generators; the s2i one with BatchNorm
  ``batch_stats`` and deconvs) at f=2 on 32^3: its export bundles load both
  ways with every variable (parameters and running statistics) equal after
  the layout map, and both generators' outputs within atol 2e-3 of flax in
  float64 (``test_torch_vnet.flax_float64_apply``, the witness; at 4 levels
  the port's float32 V-Net is up to 5.6e-4 from it,
  ``test_torch_vnet.py::test_vnet_at_the_factory_depth_matches_flax_float64``),
  the s2i one also within 2e-3 of flax in float32 (flax's float32 i2s
  V-Net is 2.8e-1 from its own float64 run at this depth,
  ``test_torch_vnet.py::test_flax_float32_is_the_less_precise_side``); a
  JAX train state (``batch_stats`` and Adam moments set from a seed)
  carries bit for bit, the deconv kernels' moments flipped and transposed
  like the kernels; the
  converter script carries ``batch_stats`` with and without
  ``--train-state``; and a resume with dropout on is exact, buffers
  included.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from test_torch_train_step import STEPS_PER_EPOCH, _torch_gan
from test_train_step import make_batch, tiny_cfg, tiny_models

from vangan_tpu import checkpoint as jax_checkpoint
from vangan_tpu.config import VanGanConfig as JaxConfig
from vangan_tpu.models.factory import build_discriminator, build_generator
from vangan_tpu.training.step import make_step_fns
from vangan_torch import checkpoint
from vangan_torch.config import VanGanConfig
from vangan_torch.training.state import NETWORKS
from vangan_torch.vangan import VanGan
from vangan_torch.weights import load_flax_train_state, torch_to_flax, torch_to_flax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These networks are tiny: one intra-op thread is ~3x faster than eight
    on them, and far faster when several test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batches(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return [tuple(np.array(a) for a in make_batch(rng, cfg)) for _ in range(n)]


def _state_tensors(gan):
    """Every tensor of the training state, by name: parameters, Adam moments
    and steps, BatchNorm buffers, and the counts and step as tensors."""
    out = {}
    for name in NETWORKS:
        for pname, p in gan.nets[name].named_parameters():
            out[f"{name}.{pname}"] = p.detach()
            for k, t in gan.state.opt[name].state[p].items():
                out[f"{name}.{pname}.{k}"] = t
        for bname, b in gan.nets[name].named_buffers():
            out[f"{name}.{bname}"] = b
        out[f"{name}.count"] = torch.tensor(gan.state.counts[name])
    out["step"] = torch.tensor(gan.state.step)
    return out


def _assert_states_equal(a, b):
    ta, tb = _state_tensors(a), _state_tensors(b)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


def _gan(tmp_path, deterministic=False, seed=0):
    gan = _torch_gan(tiny_cfg(), deterministic=deterministic, seed=seed)
    gan.cfg.output_dir = str(tmp_path)
    return gan


def test_save_load_round_trip_restores_every_tensor(tmp_path):
    gan = _gan(tmp_path)
    x, y = _batches(tiny_cfg(), 1)[0]
    gan.distributed_train_step(x, y, 0.1, True)
    gan.save_checkpoint(epoch=4)  # writes torch_e5.pt (epoch + 1, vangan.py:249)
    assert gan.checkpointer.latest_epoch() == 5
    assert os.path.isfile(tmp_path / "checkpoints" / "torch_e5.pt")
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path / "checkpoints"))

    fresh = _gan(tmp_path, seed=7)  # other initial values, same structure
    fresh.load_checkpoint(epoch=5)
    assert fresh.checkpoint_loaded
    _assert_states_equal(fresh, gan)
    assert fresh.state.step == 1 and all(c == 1 for c in fresh.state.counts.values())

    # predict --epoch N reads the networks of the same file
    served = _gan(tmp_path, seed=8)
    served.load_weights(served.weights_path(5))
    for name in NETWORKS:
        for a, b in zip(served.nets[name].parameters(), gan.nets[name].parameters()):
            assert torch.equal(a, b)


def test_adam_moments_are_made_for_checkpoints_only(tmp_path):
    """Serving and evaluation hold no Adam moments; a checkpoint's layout
    makes them (step 0, zero moments, as optax's ``init``)."""
    gan = _gan(tmp_path)
    x, y = _batches(tiny_cfg(), 1)[0]
    gan.distributed_test_step(x, y)
    assert not any(o.state for o in gan.state.opt.values())
    state = gan.checkpoint_state()["train_state"]["opt"]
    for name in NETWORKS:
        params = list(gan.nets[name].parameters())
        assert len(state[name]["state"]) == len(params)
        for p in params:
            st = gan.state.opt[name].state[p]
            assert float(st["step"]) == 0.0
            assert not st["exp_avg"].any() and not st["exp_avg_sq"].any()


def test_resume_is_exact_with_noise_and_dropout(tmp_path):
    """k = 2 steps, save, load into a fresh VanGan, 2 more == 4 straight steps."""
    batches = _batches(tiny_cfg(), 4, seed=3)
    straight = _gan(tmp_path / "a")
    for x, y in batches:
        straight.distributed_train_step(x, y, 0.1, True)

    first = _gan(tmp_path / "b")
    for x, y in batches[:2]:
        first.distributed_train_step(x, y, 0.1, True)
    first.save_checkpoint(epoch=0)
    resumed = _gan(tmp_path / "b", seed=11)
    resumed.load_checkpoint(epoch=1)
    resumed.generator.set_state(first.generator.get_state())
    for x, y in batches[2:]:
        resumed.distributed_train_step(x, y, 0.1, True)
    _assert_states_equal(resumed, straight)
    assert resumed.state.step == 4


def test_async_save_then_immediate_load(tmp_path):
    ck = checkpoint.VanGanCheckpointer(str(tmp_path))
    state = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    ck.save(state, epoch=2)
    state["w"].add_(1)  # the snapshot was taken at save
    got = ck.load({"w": torch.zeros(2, 3)}, epoch=3)
    assert torch.equal(got["w"], torch.arange(6, dtype=torch.float32).reshape(2, 3))


def _outcome(fn):
    try:
        return "ok", fn()
    except ValueError as e:
        return ("expect_partial" if "expect_partial" in str(e) else
                "shape/dtype" if "shape/dtype" in str(e) else str(e)), None


@pytest.mark.parametrize("case", ["extra_in_template", "missing_in_template", "shape",
                                  "dtype", "not_found"])
@pytest.mark.parametrize("expect_partial", [False, True])
def test_missing_and_mismatch_behave_as_jax(tmp_path, case, expect_partial):
    """The same trees through both checkpointers: which loads raise (and
    why), which return None, and what a partial load keeps."""
    saved = {"a": np.ones((2, 2), np.float32), "b": np.full((3,), 2.0, np.float32)}
    template = {"a": np.zeros((2, 2), np.float32), "b": np.zeros((3,), np.float32)}
    if case == "extra_in_template":
        template["c"] = np.zeros((4,), np.float32)
    elif case == "missing_in_template":
        del template["b"]
    elif case == "shape":
        template["b"] = np.zeros((5,), np.float32)
    elif case == "dtype":
        template["b"] = np.zeros((3,), np.float64)
    results = {}
    for pkg, ck, conv in (
            ("jax", jax_checkpoint.VanGanCheckpointer(str(tmp_path / "jax")), np.asarray),
            ("torch", checkpoint.VanGanCheckpointer(str(tmp_path / "torch")), torch.from_numpy)):
        ck.save({k: conv(v) for k, v in saved.items()}, epoch=0)
        ck.wait_until_finished()
        epoch = 99 if case == "not_found" else 1
        kind, got = _outcome(lambda: ck.load({k: conv(v) for k, v in template.items()}, epoch,
                                             expect_partial=expect_partial))
        results[pkg] = (kind, None if got is None else
                        {k: (np.asarray(v).dtype, np.asarray(v).tolist()) for k, v in got.items()})
    assert results["torch"] == results["jax"]


@functools.lru_cache(maxsize=None)
def _jax_run():
    """(state after 2 steps, state after a third, the 3 batches), host
    arrays, of the default layout (``flatten_opt``)."""
    cfg = tiny_cfg()
    fns = make_step_fns(cfg, tiny_models(deterministic=True), steps_per_epoch=STEPS_PER_EPOCH)
    state = fns.init(jax.random.PRNGKey(0))
    batches = _batches(cfg, 3, seed=5)
    step = jax.jit(fns.train_step)
    for i in range(3):
        if i == 2:
            two = jax.tree_util.tree_map(np.asarray, state)
        state, _ = step(state, *batches[i], jax.random.PRNGKey(i), jnp.zeros(()),
                        jnp.asarray(True))
    return two, jax.tree_util.tree_map(np.asarray, state), batches


def _per_leaf_layout(two):
    """``two`` in the ``flatten_opt=False`` layout: each moment vector
    unraveled by JAX's own ``ravel_pytree`` into the param tree, in the
    optimizer-state structure ``make_step_fns`` gives that layout (checked
    by ``jax.eval_shape`` of its ``init``, which compiles nothing)."""
    opt = {}
    for name, (clip, (adam, sched)) in two.opt_state.items():
        unravel = ravel_pytree(two.params[name])[1]
        opt[name] = (clip, (adam._replace(mu=jax.tree_util.tree_map(np.asarray, unravel(adam.mu)),
                                          nu=jax.tree_util.tree_map(np.asarray, unravel(adam.nu))),
                            sched))
    fns = make_step_fns(tiny_cfg(flatten_opt=False), tiny_models(deterministic=True),
                        steps_per_epoch=STEPS_PER_EPOCH)
    want = jax.eval_shape(fns.init, jax.random.PRNGKey(0)).opt_state
    assert jax.tree_util.tree_structure(opt) == jax.tree_util.tree_structure(want)
    return two.replace(opt_state=opt)


def _adam(opt_state):
    return opt_state[1][0]  # chain(clip, [flatten](chain(scale_by_adam, lr)))


@pytest.mark.parametrize("flatten_opt", [True, False])
def test_carries_a_jax_train_state(flatten_opt):
    two, three, batches = _jax_run()
    if not flatten_opt:
        two = _per_leaf_layout(two)
    gan = _torch_gan(tiny_cfg())
    load_flax_train_state(gan, two)
    assert gan.state.step == int(two.step) == 2
    for name in NETWORKS:
        adam = _adam(two.opt_state[name])
        unravel = ravel_pytree(two.params[name])[1]
        for key, t in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            want = getattr(adam, key)
            if flatten_opt:
                assert np.ndim(want) == 1
                want = unravel(want)
            got = torch_to_flax({pn: gan.state.opt[name].state[p][t]
                                 for pn, p in gan.nets[name].named_parameters()},
                                gan.nets[name])
            got_flat, want_flat = ravel_pytree(got)[0], ravel_pytree(want)[0]
            assert np.array_equal(np.asarray(got_flat), np.asarray(want_flat)), (name, key)
        assert gan.state.counts[name] == int(adam.count) == 2
        assert all(float(s["step"]) == 2.0 for s in gan.state.opt[name].state.values())

    # one more step on each side, and the port's step from weights moved by
    # 1e-5 relative: the float32 conditioning witness
    update = _port_update(gan, batches[2])
    spread = _port_update(_carried(two, perturb=True), batches[2])
    # no Adam update of the third step exceeds this (gan.state.lr(2): its LR)
    cap = gan.state.lr(2) * _adam_step_bound(*gan.state.opt["gen_IS"].param_groups[0]["betas"],
                                             t=3)
    for name in NETWORKS:
        want = _flat(three.params[name]) - _flat(two.params[name])
        got = update[name]
        # JAX's third gradient, from its Adam moments: mu3 = 0.5 mu2 + 0.5 g3
        g3 = 2 * _flat_moment(three, name) - _flat_moment(two, name)
        signal = np.abs(g3) > 1e-3 * np.abs(g3).max()
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        rel_signal = (np.linalg.norm((got - want)[signal]) / np.linalg.norm(want[signal]))
        own = np.linalg.norm(spread[name] - got) / np.linalg.norm(got)
        rest = max(np.max(np.abs(a[~signal]), initial=0.0) for a in (got, want))
        print(f"{name}: third-step update, port vs JAX, relative L2 {rel:.3e} "
              f"({rel_signal:.3e} where |g| > 1e-3 max |g|; elsewhere at most "
              f"{rest / cap:.3f} of Adam's largest step); the port's own spread {own:.3e}")
        assert rel_signal <= 1e-4, name
        # the rest carry rounding noise, which either side's Adam scales up
        # to steps of the LR's size, and no larger
        assert np.max(np.abs(got[~signal]), initial=0.0) <= cap, name
        assert np.max(np.abs(want[~signal]), initial=0.0) <= cap, name
        assert rel <= 3 * own, name


def _adam_step_bound(b1, b2, t):
    """The largest |update| / LR of Adam's t-th step: |m_t| / sqrt(v_t) is
    at most (1 - b1) / sqrt(1 - b2) * sqrt(sum_{k<t} (b1^2 / b2)^k) by
    Cauchy-Schwarz, times the bias corrections sqrt(1 - b2^t) / (1 - b1^t)."""
    s = sum((b1 * b1 / b2) ** k for k in range(t))
    return (1 - b1) / np.sqrt(1 - b2) * np.sqrt(s) * np.sqrt(1 - b2 ** t) / (1 - b1 ** t)


def _flat(tree):
    return np.asarray(ravel_pytree(tree)[0])


def _flat_moment(state, name):
    mu = _adam(state.opt_state[name]).mu
    return np.asarray(mu) if np.ndim(mu) == 1 else _flat(mu)


def _carried(two, perturb=False):
    gan = _torch_gan(tiny_cfg())
    load_flax_train_state(gan, two)
    if perturb:
        g = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for net in gan.nets.values():
                for p in net.parameters():
                    p.mul_(1 + 1e-5 * torch.randn(p.shape, generator=g))
    return gan


def _port_update(gan, batch):
    """Each network's parameter update (flax layout, raveled) of one step."""
    flat = lambda n: _flat(torch_to_flax(gan.nets[n].state_dict(), gan.nets[n]))  # noqa: E731
    before = {n: flat(n) for n in NETWORKS}
    gan.distributed_train_step(*batch, 0.0, True)
    return {n: flat(n) - before[n] for n in NETWORKS}


def test_flax_checkpoint_converts_to_a_resumable_port_checkpoint(tmp_path):
    """scripts/flax_ckpt_to_torch.py --train-state on an orbax checkpoint of
    the JAX package (factory networks, moments and counts set from a seed):
    ``load_checkpoint`` then holds what ``load_flax_train_state`` carries
    from the live state."""
    import importlib.util

    cfg, jcfg = _tiny_factory_cfgs(tmp_path)
    state = make_step_fns(jcfg, _jax_factory_models(jcfg), steps_per_epoch=10).init(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    state = state.replace(step=jnp.asarray(2, state.step.dtype), opt_state=jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(size=a.shape), a.dtype) if a.ndim
        else jnp.asarray(2, a.dtype), state.opt_state))
    jck = jax_checkpoint.VanGanCheckpointer(jcfg.output_dir)
    jck.save(state, epoch=1)
    jck.wait_until_finished()

    spec = importlib.util.spec_from_file_location(
        "flax_ckpt_to_torch", os.path.join(REPO, "scripts", "flax_ckpt_to_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    out = script.convert(cfg, 2, train_state=True)
    assert out == str(tmp_path / "checkpoints" / "torch_e2.pt")

    gan = VanGan(cfg, device="cpu")
    gan.load_checkpoint(epoch=2)
    want = VanGan(cfg, device="cpu")
    load_flax_train_state(want, jax.tree_util.tree_map(np.asarray, state))
    assert want.state.step == 2 and all(c == 2 for c in want.state.counts.values())
    _assert_states_equal(gan, want)


def _tiny_factory_cfgs(tmp_path):
    d = dict(BATCH_SIZE=1, SUBVOL_PATCH_SIZE=(16, 16, 16), gen_filters=4, disc_filters=8,
             cldice_iters=2, compute_dtype="float32", output_dir=str(tmp_path))
    return VanGanConfig(**d), JaxConfig(**d)


def _jax_factory_models(jcfg):
    return {"gen_IS": build_generator(jcfg.gen_i2s, jcfg, role="i2s"),
            "gen_SI": build_generator(jcfg.gen_s2i, jcfg, role="s2i"),
            "disc_I": build_discriminator(jcfg), "disc_S": build_discriminator(jcfg)}


def _x():
    return np.random.default_rng(7).normal(size=(1, 16, 16, 16, 1)).astype(np.float32)


def test_port_bundle_loads_in_jax(tmp_path):
    cfg, _ = _tiny_factory_cfgs(tmp_path)
    gan = VanGan(cfg, device="cpu")
    path = checkpoint.export_models(cfg, gan.nets, epoch=2)
    assert path.endswith(os.path.join("exports", "e3"))
    _, nets = jax_checkpoint.load_exported(path)
    assert set(nets) == set(NETWORKS)
    for name in ("gen_IS", "disc_I"):
        module, variables = nets[name]
        want = np.asarray(module.apply(variables, jnp.asarray(_x()), train=False))
        with torch.no_grad():
            got = gan.nets[name](torch.from_numpy(_x())).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4, err_msg=name)


def test_jax_bundle_loads_in_the_port(tmp_path):
    _, jcfg = _tiny_factory_cfgs(tmp_path)
    models = _jax_factory_models(jcfg)
    state = make_step_fns(jcfg, models, steps_per_epoch=10).init(jax.random.PRNGKey(0))
    path = jax_checkpoint.export_models(jcfg, state, epoch=2)
    cfg, nets = checkpoint.load_exported(path, device="cpu")
    assert cfg.gen_filters == 4 and set(nets) == set(NETWORKS)
    for name in ("gen_IS", "disc_I"):
        want = np.asarray(models[name].apply({"params": state.params[name]},
                                             jnp.asarray(_x()), train=False))
        with torch.no_grad():
            got = nets[name](torch.from_numpy(_x())).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4, err_msg=name)


def test_cuda_bundle_load_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    cfg, _ = _tiny_factory_cfgs(tmp_path)
    path = checkpoint.export_models(cfg, VanGan(cfg, device="cpu").nets, epoch=0)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        checkpoint.load_exported(path)


def test_converter_script_has_train_state_flag():
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "flax_ckpt_to_torch.py"),
                           "--help"], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "--train-state" in proc.stdout


# --- BASELINE config 4: V-Net generators with BatchNorm state and deconvs ---

_C4 = dict(BATCH_SIZE=1, SUBVOL_PATCH_SIZE=(32, 32, 32), gen_filters=2, disc_filters=4,
           cldice_iters=2, compute_dtype="float32", gen_i2s="vnet", gen_s2i="vnet")


def _config4_cfgs(tmp_path):
    return (VanGanConfig(**_C4, output_dir=str(tmp_path)),
            JaxConfig(**_C4, output_dir=str(tmp_path)))


@functools.lru_cache(maxsize=None)
def _config4_jax_state():
    """A JAX config-4 state (host arrays): factory init, gen_SI's
    ``batch_stats`` and every Adam moment set from a seed, step and counts 2."""
    from test_torch_vnet import _stats

    jcfg = JaxConfig(**_C4)
    state = make_step_fns(jcfg, _jax_factory_models(jcfg), steps_per_epoch=10).init(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    model_state = dict(state.model_state)
    model_state["gen_SI"] = {"batch_stats": _stats(model_state["gen_SI"]["batch_stats"], rng)}
    state = state.replace(step=jnp.asarray(2, state.step.dtype), model_state=model_state,
                          opt_state=jax.tree_util.tree_map(
                              lambda a: jnp.asarray(rng.normal(size=a.shape), a.dtype) if a.ndim
                              else jnp.asarray(2, a.dtype), state.opt_state))
    return jax.tree_util.tree_map(np.asarray, state)


def _x32():
    return np.random.default_rng(8).uniform(-1, 1, size=(2, 32, 32, 32, 1)).astype(np.float32)


def _stats_of(net):
    return torch_to_flax_variables(net.state_dict(), net)["batch_stats"]


def _assert_trees_equal(a, b):
    la, lb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
    assert [jax.tree_util.keystr(p) for p, _ in la] == [jax.tree_util.keystr(p) for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert np.array_equal(np.asarray(x), np.asarray(y)), jax.tree_util.keystr(path)


def _assert_config4_outputs(nets, flax_generators):
    """Each port generator within 2e-3 of its flax counterpart (module,
    variables) in float64, and the s2i one of flax in float32 too."""
    from test_torch_vnet import flax_float64_apply

    x = _x32()
    for name, (module, variables) in flax_generators.items():
        with torch.no_grad():
            got = nets[name](torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, flax_float64_apply(module, variables, x)[0], rtol=0,
                                   atol=2e-3, err_msg=name)
        if name == "gen_SI":
            want = np.asarray(module.apply(variables, jnp.asarray(x), train=False))
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


def test_config4_jax_bundle_loads_in_the_port(tmp_path):
    _, jcfg = _config4_cfgs(tmp_path)
    state = _config4_jax_state()
    path = jax_checkpoint.export_models(jcfg, state, epoch=0)
    cfg, nets = checkpoint.load_exported(path, device="cpu")
    assert (cfg.gen_i2s, cfg.gen_s2i) == ("vnet", "vnet")
    for name in NETWORKS:
        got = torch_to_flax_variables(nets[name].state_dict(), nets[name])
        _assert_trees_equal(got, {"params": state.params[name], **state.model_state[name]})
    models = _jax_factory_models(jcfg)
    _assert_config4_outputs(nets, {name: (models[name], {"params": state.params[name],
                                                         **state.model_state[name]})
                                   for name in ("gen_IS", "gen_SI")})


def test_config4_port_bundle_loads_in_jax(tmp_path):
    cfg, _ = _config4_cfgs(tmp_path)
    gan = VanGan(cfg, device="cpu")
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():  # non-trivial running statistics
        for bname, b in gan.gen_SI.named_buffers():
            b.copy_(torch.rand(b.shape, generator=g) + (0.5 if bname.endswith("var") else -0.5))
    path = checkpoint.export_models(cfg, gan.nets, epoch=1)
    _, nets = jax_checkpoint.load_exported(path)
    for name in NETWORKS:
        _assert_trees_equal(jax.tree_util.tree_map(np.asarray, nets[name][1]),
                            torch_to_flax_variables(gan.nets[name].state_dict(), gan.nets[name]))
    _assert_config4_outputs(gan.nets, {name: nets[name] for name in ("gen_IS", "gen_SI")})


def test_config4_train_state_carries_batch_stats_and_deconv_moments(tmp_path):
    cfg, _ = _config4_cfgs(tmp_path)
    state = _config4_jax_state()
    gan = VanGan(cfg, device="cpu")
    load_flax_train_state(gan, state)
    _assert_trees_equal(_stats_of(gan.gen_SI), state.model_state["gen_SI"]["batch_stats"])
    assert gan.state.step == 2
    for name in NETWORKS:
        net, adam = gan.nets[name], _adam(state.opt_state[name])
        unravel = ravel_pytree(state.params[name])[1]
        for key, t in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            want = getattr(adam, key)
            want = jax.tree_util.tree_map(np.asarray, unravel(want) if np.ndim(want) == 1
                                          else want)
            got = torch_to_flax({pn: gan.state.opt[name].state[p][t]
                                 for pn, p in net.named_parameters()}, net)
            _assert_trees_equal(got, want)
            if name == "gen_SI":  # the deconv's moment in torch's layout, by hand
                kernel = want["deconv0"]["kernel"]
                moment = gan.state.opt[name].state[net.deconv0.weight][t].numpy()
                assert np.array_equal(moment, np.transpose(np.flip(kernel, (0, 1, 2)),
                                                           (3, 4, 0, 1, 2)))
        assert gan.state.counts[name] == 2


@pytest.mark.parametrize("train_state", [False, True])
def test_config4_converter_carries_batch_stats(tmp_path, train_state):
    import importlib.util

    cfg, jcfg = _config4_cfgs(tmp_path)
    state = jax.tree_util.tree_map(jnp.asarray, _config4_jax_state())
    jck = jax_checkpoint.VanGanCheckpointer(jcfg.output_dir)
    jck.save(state, epoch=1)
    jck.wait_until_finished()
    spec = importlib.util.spec_from_file_location(
        "flax_ckpt_to_torch", os.path.join(REPO, "scripts", "flax_ckpt_to_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    script.convert(cfg, 2, train_state=train_state)
    gan = VanGan(cfg, device="cpu")
    if train_state:
        gan.load_checkpoint(epoch=2)
    else:
        gan.load_weights(gan.weights_path(2))
    _assert_trees_equal(_stats_of(gan.gen_SI),
                        _config4_jax_state().model_state["gen_SI"]["batch_stats"])


def test_config4_resume_is_exact_with_dropout(tmp_path):
    """The factory V-Nets (spatial dropout 0.5) and discriminator noise on:
    2 steps, save, load into a fresh VanGan, 2 more == 4 straight steps,
    every parameter, moment and running statistic bit for bit."""
    cfg, _ = _config4_cfgs(tmp_path)
    batches = _batches(tiny_cfg(SUBVOL_PATCH_SIZE=(32, 32, 32), BATCH_SIZE=1), 4, seed=6)
    straight = VanGan(cfg, device="cpu")
    for x, y in batches:
        straight.distributed_train_step(x, y, 0.1, True)
    first = VanGan(cfg, device="cpu")
    for x, y in batches[:2]:
        first.distributed_train_step(x, y, 0.1, True)
    first.save_checkpoint(epoch=0)
    resumed = VanGan(dataclasses.replace(cfg, seed=5), device="cpu")
    resumed.load_checkpoint(epoch=1)
    resumed.generator.set_state(first.generator.get_state())
    for x, y in batches[2:]:
        resumed.distributed_train_step(x, y, 0.1, True)
    assert len(list(resumed.gen_SI.buffers())) == 36
    _assert_states_equal(resumed, straight)
