"""Data parallelism (``vangan_torch.parallel``) against the JAX package's
``N_DEVICES=2`` contract, and its plumbing on one process.

Two gloo ranks on the CPU, started by ``parallel.spawn`` from
``torch_dp_worker`` (no JAX in them), each take one sample of the global
batch of ``test_train_step.tiny_cfg(N_DEVICES=2, BATCH_SIZE=1)`` (16^3,
generators f=4 with 2 levels, discriminators f=8, no noise or dropout,
clDice with 2 iterations) from the JAX init with perturbed 1-D leaves. JAX
runs its one global-batch step under the same contract (``reduce_mean_overall``
times 2 / 2, two clDice groups). Tolerances are those of
``test_torch_train_step`` (the module note there says why): the losses within
rtol 1e-4, the parameters after one Adam step within 1e-7 where both
gradients agree in sign and are above 1e-3 max |g|, the test step's losses
within rtol 1e-4; each network's averaged gradient within 2e-3 relative L2
of ``jax.grad``, or within ``SPREAD_FACTOR`` times what the port's own
one-process float32 gradient moves when every weight moves by 1e-6
relative, whichever is larger. The second arm is the f32 rule of
``chip_smoke.py``: here gen_IS's float32 gradient jumps by 2.3e-2 under
that perturbation (the step is not smooth in the forward values, see
``test_torch_train_step``), and the two ranks' per-sample forwards differ
from one batched forward in the last bits, which moves it as much (2.3e-2 from one
process in float32, 1.5e-16 in float64: ``test_torch_parallel_f64.py``
holds the ranks to one process in float64). The two ranks' parameters after
the step are equal bit for bit.

The ranks rendezvous through a file store in a new temporary directory, and
the test joins them within ``TIMEOUT_S`` seconds or fails.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_checkpoint import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_fit import _partitions
from test_torch_train_step import _as_flax, _flat, _leaves
from test_train_step import make_batch, tiny_cfg, tiny_models

from vangan_tpu.training.step import make_step_fns
from vangan_torch import parallel
from vangan_torch.config import VanGanConfig
from vangan_torch.data.pipeline import VanGanDataset
from vangan_torch.inference.stitcher import stitch_subvolumes
from vangan_torch.parallel import Group
from vangan_torch.training.state import NETWORKS
from vangan_torch.training.step import RESULT_KEYS
from vangan_torch.weights import load_flax_networks

import torch_dp_worker as worker

TIMEOUT_S = 240
STEPS_PER_EPOCH = worker.STEPS_PER_EPOCH
SPREAD_FACTOR = 3


def _cfg_kw(jax_cfg):
    return dict(N_DEVICES=jax_cfg.N_DEVICES, BATCH_SIZE=jax_cfg.BATCH_SIZE,
                SUBVOL_PATCH_SIZE=jax_cfg.SUBVOL_PATCH_SIZE, compute_dtype="float32",
                cldice_iters=jax_cfg.cldice_iters, EPOCHS=jax_cfg.EPOCHS,
                cycle_loss_I_type=jax_cfg.cycle_loss_I_type,
                lambda_topology=jax_cfg.lambda_topology)


@functools.lru_cache(maxsize=None)
def _jax():
    """JAX's step at N_DEVICES=2 (config, perturbed params, batch, grads,
    losses, params after one step, test-step losses), once per module."""
    jax_cfg = tiny_cfg(N_DEVICES=2, BATCH_SIZE=1)
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
    test = fns.test_step(state, real_I, real_S, jax.random.PRNGKey(7))
    host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return (jax_cfg, params, np.array(real_I), np.array(real_S), host(grads),
            {k: float(v) for k, v in result.items()}, host(new_state.params),
            {k: float(v) for k, v in test.items()})


def _states(jax_cfg, params):
    """The port's state_dicts of the JAX parameter trees."""
    gan = worker.tiny_gan(_cfg_kw(jax_cfg))
    load_flax_networks(gan, params)
    return gan, {n: gan.nets[n].state_dict() for n in NETWORKS}


@functools.lru_cache(maxsize=None)
def _spread():
    """Per network: the relative L2 distance that a 1e-6 relative weight
    perturbation moves the port's one-process float32 gradient."""
    jax_cfg, params, real_I, real_S, *_ = _jax()
    gan, states = _states(jax_cfg, params)
    base, _ = worker.grads_and_losses(gan, real_I, real_S)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for net in gan.nets.values():
            for p in net.parameters():
                p.mul_(1 + 1e-6 * torch.randn(p.shape, generator=g))
    moved, _ = worker.grads_and_losses(gan, real_I, real_S)
    return {n: float((moved[n] - base[n]).norm() / base[n].norm()) for n in NETWORKS}


@pytest.fixture(scope="module")
def ranks():
    """What each of two gloo ranks returned from ``worker.step_rank``."""
    jax_cfg, params, real_I, real_S, *_ = _jax()
    _, states = _states(jax_cfg, params)
    jobs = {"step": ("step_rank", dict(cfg_kw=_cfg_kw(jax_cfg), states=states,
                                       real_I=real_I, real_S=real_S))}
    return parallel.spawn(worker.run, 2, (jobs,), device="cpu", timeout=TIMEOUT_S)


def _unflat(net, flat):
    """A flat vector in ``net.parameters()`` order as a flax tree."""
    sizes = [p.numel() for p in net.parameters()]
    parts = [t.view_as(p) for t, p in zip(flat.split(sizes), net.parameters())]
    return _as_flax(net, parts)


@pytest.mark.parametrize("name", NETWORKS)
def test_two_rank_gradients_match_jax(ranks, name):
    """The averaged gradients of two ranks against jax.grad of the global
    program."""
    jax_cfg, params, *_ = _jax()
    gan, _ = _states(jax_cfg, params)
    got = _flat(_unflat(gan.nets[name], ranks[0]["step"]["grads"][name]))
    want = _flat(_jax()[4][name])
    assert got.shape == want.shape
    gap = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert gap <= max(2e-3, SPREAD_FACTOR * _spread()[name]), (gap, _spread()[name])
    # every rank holds the same average
    assert torch.equal(ranks[0]["step"]["grads"][name], ranks[1]["step"]["grads"][name])


def test_two_rank_train_step_matches_jax(ranks):
    """The averaged loss dict, and one ``distributed_train_step`` of each
    rank on the global batch: the losses and the parameters after it, equal
    on the two ranks bit for bit."""
    jax_cfg, params, _, _, grads, want_losses, want_params, _ = _jax()
    gan, _ = _states(jax_cfg, params)
    for r in ranks:
        assert not r["jax_imported"]
        for key in RESULT_KEYS:
            for got in (r["step"]["losses"][key], r["step"]["step_losses"][key]):
                np.testing.assert_allclose(got, want_losses[key], rtol=1e-4, err_msg=key)
        assert r["step"]["counts"] == {n: 1 for n in NETWORKS}
    for name in NETWORKS:
        params = ranks[0]["step"]["params"][name]
        assert torch.equal(params, ranks[1]["step"]["params"][name])
        # the update of the averaged gradient, bit for bit
        net, avg = gan.nets[name], ranks[0]["step"]["grads"][name]
        gan.state.apply(name, [t.view_as(p) for t, p in zip(
            avg.split([p.numel() for p in net.parameters()]), net.parameters())])
        assert torch.equal(params, worker._flat(net.parameters())), name
        got = _leaves(_unflat(net, params))
        g = _leaves(grads[name])
        g_port = _leaves(_unflat(net, avg))
        want = _leaves(want_params[name])
        gmax = max(np.abs(v).max() for v in g.values())
        for key, w in want.items():
            # as test_torch_train_step, and where the two gradients agree to
            # 1e-3: an element's Adam step, lr g / (|g| + eps), moves with g
            # by eps / |g| of its relative change (the module note: gen_IS's
            # float32 gradient moves by 2.3e-2 here)
            mask = ((np.abs(g[key]) > 1e-3 * gmax) & (np.sign(g[key]) == np.sign(g_port[key]))
                    & (np.abs(g[key] - g_port[key]) <= 1e-3 * np.abs(g[key])))
            np.testing.assert_allclose(got[key][mask], w[mask], rtol=0, atol=1e-7,
                                       err_msg=f"{name}{key}")


def test_two_rank_test_step_matches_jax(ranks):
    want = _jax()[7]
    for r in ranks:
        assert sorted(r["step"]["test"]) == sorted(want)
        for key, w in want.items():
            np.testing.assert_allclose(r["step"]["test"][key], w, rtol=1e-4, err_msg=key)


def test_rank_generators_differ(ranks):
    """Rank 0 draws what one process draws (seed + 1); rank 1 draws others."""
    one = torch.rand(8, generator=torch.Generator().manual_seed(VanGanConfig().seed + 1))
    assert torch.equal(ranks[0]["step"]["draws"], one)
    assert not torch.equal(ranks[1]["step"]["draws"], one)


def test_world_of_one_makes_no_collective_call(monkeypatch, tmp_path):
    """A group of one rank: the train and test steps, loading weights and a
    stitch call no collective, and give what no group gives, bit for bit."""
    jax_cfg = tiny_cfg(N_DEVICES=1, BATCH_SIZE=2)
    rng = np.random.default_rng(3)
    real_I, real_S = (np.asarray(a) for a in make_batch(rng, jax_cfg))
    alone = worker.tiny_gan(_cfg_kw(jax_cfg))
    alone.save_weights(str(tmp_path / "w.pt"))

    def refuse(*args, **kwargs):
        raise AssertionError("a world of 1 called a collective")

    for name in ("all_reduce", "broadcast", "barrier", "all_gather", "reduce"):
        monkeypatch.setattr(dist, name, refuse)
    ranked = worker.tiny_gan(_cfg_kw(jax_cfg), group=Group(0, 1, "cpu"))
    ranked.load_weights(str(tmp_path / "w.pt"))
    out = [(gan.distributed_train_step(real_I, real_S, 0.0, True),
            gan.distributed_test_step(real_I, real_S)) for gan in (alone, ranked)]
    for a, b in zip(*out):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for name in NETWORKS:
        for p, q in zip(alone.nets[name].parameters(), ranked.nets[name].parameters()):
            assert torch.equal(p, q)
    vol = rng.normal(size=(20, 18, 17, 1)).astype(np.float32)
    kw = dict(stride=(8, 8, 8), complete=True, save=False, batch_size=4, device="cpu")
    with torch.inference_mode():
        np.testing.assert_array_equal(
            stitch_subvolumes(alone.gen_IS, vol, (4, 16, 16, 16, 1), **kw),
            stitch_subvolumes(ranked.gen_IS, vol, (4, 16, 16, 16, 1),
                              group=Group(0, 1, "cpu"), **kw))


@pytest.mark.parametrize("groups", [3, 5])
def test_cldice_groups_the_world_does_not_divide_raise(groups):
    cfg = VanGanConfig(N_DEVICES=2, BATCH_SIZE=5 * 3, cldice_groups=groups)
    with pytest.raises(ValueError, match=f"cldice_groups={groups} does not split over 2"):
        cfg.rank_batch(2)
    # a rank raises before any collective
    with pytest.raises(ValueError, match="cldice_groups"):
        worker.tiny_gan(dict(N_DEVICES=2, BATCH_SIZE=15, cldice_groups=groups),
                        group=Group(0, 2, "cpu", pg=object()))


def test_rank_batch_checks_the_world():
    cfg = VanGanConfig(N_DEVICES=2, BATCH_SIZE=3)
    assert cfg.rank_batch(2) == 3
    with pytest.raises(ValueError, match="one rank per device"):
        cfg.rank_batch(3)


@pytest.mark.parametrize("requested, visible, used, gb, groups", [
    (4, 2, 2, 12, 4),  # capped: the global batch and groups keep the YAML's derivation
    (2, 8, 2, 6, 2),
    (0, 3, 3, 9, 3),   # 0: every device
])
def test_cap_devices_as_the_jax_cli(requested, visible, used, gb, groups, capsys):
    cfg = VanGanConfig(N_DEVICES=requested, BATCH_SIZE=3)
    assert cfg.cap_devices(visible) == used == cfg.N_DEVICES
    assert (cfg.GLOBAL_BATCH_SIZE, cfg.cldice_groups) == (gb, groups)
    assert ("running on" in capsys.readouterr().out) == (requested > visible)


@pytest.mark.parametrize("workers", [1, 2])
def test_feed_rank_slices_make_the_global_batch(tmp_path, workers):
    """Each rank's shard of the train and validation batches; the shards,
    concatenated, are the one-process global batches."""
    import pickle

    _partitions(tmp_path)
    part = {}
    for pid in ("A", "B"):
        with open(tmp_path / "data" / f"data{pid}_partition.pkl", "rb") as f:
            part[pid] = pickle.load(f)
    cfg = VanGanConfig(N_DEVICES=2, BATCH_SIZE=2, SUBVOL_PATCH_SIZE=(16, 16, 16),
                       DATA_WORKERS=workers)

    def batches(rank, world):
        group = None if world == 1 else Group(rank, world, "cpu", pg=object())
        ds = VanGanDataset(cfg, part["A"], part["B"], seed=5, device="cpu", group=group)
        try:
            tr, va = ds.train_batches(), ds.val_batches()
            return [next(tr) for _ in range(2)] + [next(va)], ds.train_steps
        finally:
            ds.close()

    (whole, steps), shards = batches(0, 1), [batches(r, 2) for r in range(2)]
    assert all(s == steps for _, s in shards)
    for i, (real_I, real_S) in enumerate(whole):
        assert real_I.shape[0] == cfg.GLOBAL_BATCH_SIZE == 4
        for r, (shard, _) in enumerate(shards):
            assert shard[i][0].shape[0] == 2
            assert torch.equal(shard[i][0], real_I[2 * r: 2 * r + 2])
            assert torch.equal(shard[i][1], real_S[2 * r: 2 * r + 2])
    with pytest.raises(ValueError, match="does not split"):
        VanGanDataset(cfg, part["A"], part["B"], device="cpu",
                      group=Group(0, 3, "cpu", pg=object()))


def test_all_reduce_helpers_average():
    """The helpers' arithmetic on a stand-in group whose sum doubles (two
    ranks holding the same values)."""

    class Twice(Group):
        def sum_(self, t):
            return t.mul_(2)

    g = Twice(0, 2, "cpu", pg=object())
    grads = [torch.arange(6.0).view(2, 3), torch.ones(4)]
    out = parallel.all_reduce_grads(g, grads)
    assert all(torch.equal(a, b) and a.shape == b.shape for a, b in zip(out, grads))
    mean = parallel.all_reduce_mean(g, {"a": torch.tensor(1.5), "b": torch.tensor(-2.0,
                                                                              dtype=torch.float64)})
    assert float(mean["a"]) == 1.5 and mean["b"].dtype == torch.float64
    assert parallel.rows(g, 6) == slice(0, 3) and parallel.rows(None, 6) == slice(0, 6)
    with pytest.raises(ValueError, match="does not split"):
        parallel.rows(g, 5)


def test_spawn_fails_on_a_rank_error_and_on_timeout():
    """A rank that raises stops the other (left waiting in a barrier) and
    raises in the parent; ranks that run past the limit are killed."""
    with pytest.raises(Exception, match="rank 1 failed on purpose"):
        parallel.spawn(worker.run, 2, ({"x": ("fail_rank", {})},), device="cpu",
                       timeout=TIMEOUT_S)
    with pytest.raises(TimeoutError, match="did not finish in 5 s"):
        parallel.spawn(worker.run, 2, ({"s": ("sleep_rank", {"seconds": 600})},),
                       device="cpu", timeout=5)


def test_spawn_reports_the_rank_that_failed_first():
    """Rank 1's error leaves rank 0 failing in its barrier: the error
    ``spawn`` raises starts with rank 1's ``ValueError``, then rank 0's."""
    with pytest.raises(parallel.RankError) as info:
        parallel.spawn(worker.run, 2, ({"x": ("fail_rank", {})},), device="cpu",
                       timeout=TIMEOUT_S)
    text = str(info.value)
    assert text.startswith("rank 1 failed first:\n"), text[:200]
    assert "ValueError: rank 1 failed on purpose" in text.split("rank 0 failed")[0]


@pytest.mark.parametrize("exit_codes, first", [
    ((-15, 1), "rank 1 failed first:\n"),
    ((-9, 1), "rank 0 exited with code -9 and left no error\nrank 1 failed first:\n"),
])
def test_spawn_skips_an_unreadable_error_and_names_a_silent_rank(tmp_path, exit_codes, first):
    """An empty ``rank0.err`` (a rank stopped as it wrote) beside rank 1's
    real one: the error raised is rank 1's, and rank 0's exit code is named,
    first when it died on its own (SIGKILL) and last when ``join`` stopped it
    (SIGTERM)."""
    (tmp_path / "rank0.err").write_text("")
    (tmp_path / "rank1.err").write_text(f"{12.5!r}\nValueError: rank 1 failed on purpose\n")

    class Proc:
        def __init__(self, code):
            self.exitcode = code

        def join(self, timeout=None):
            pass

    class Ctx:
        processes = [Proc(c) for c in exit_codes]

        def join(self, timeout=None):
            raise torch.multiprocessing.ProcessRaisedException("secondary", 0, 1)

    assert [r for _, r, _ in parallel._rank_errors(str(tmp_path), 2)] == [1]
    with pytest.raises(parallel.RankError) as info:
        parallel._join(Ctx(), str(tmp_path), 2, None)
    text = str(info.value)
    assert text.startswith(first), text
    assert "ValueError: rank 1 failed on purpose" in text
    assert "rank 0 exited with code" in text
