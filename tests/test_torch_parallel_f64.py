"""Two data-parallel ranks against one process of the port, in float64, and
the cross-rank BatchNorm and the split stitch.

Two gloo ranks on the CPU (``parallel.spawn`` of ``torch_dp_worker``, which
imports no JAX) against the port in one process, from the same weights and
the same global batch:

- the four averaged gradients and the loss dict of the tiny networks of
  ``test_train_step.tiny_cfg`` (no noise or dropout) in float64, the
  gradients within 1e-10 relative L2 per network (measured 1.5e-16), the
  losses within rtol 1e-6 (a generator casts its output to float32 before
  the tanh in either dtype, so losses of its outputs and the float32 batch
  are float32 sums, added in another order on two ranks): one rank a sample
  with the default clDice groups (2), and two samples a rank with
  ``cldice_groups`` 2 and 4 (each rank takes half of them);
- the s2i V-Net (BatchNorm, deconvs; f=4, 2 levels) in float64 and training
  mode, its BatchNorm statistics across the ranks, against flax on the
  global batch in float64 (``test_torch_vnet.flax_float64``): the output
  rows within atol 1e-6 (both cast to float32 before the tanh, as there),
  the input's cotangent and each parameter's gradient of sum(y g) within
  1e-5 relative L2 (the cotangent passes that float32 tanh), the moved
  ``batch_stats`` within rtol 1e-6 (compared in float32, the layout
  ``weights.torch_to_flax_variables`` gives), and equal on the two ranks;
- the stitch of a 20 x 18 x 17 volume split over two ranks against the
  one-process stitch: rank 0 returns it, rank 1 None; within atol 4e-3 on
  its [0, 255] scale (255 x 2^-16: the float32 accumulators add the same
  patch predictions in another order, each voxel's sum over at most 27
  patches of values in [-1, 1]).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_checkpoint import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_vnet import _models, _roles, flax_float64

from vangan_torch import parallel
from vangan_torch.inference.stitcher import stitch_subvolumes
from vangan_torch.training.state import NETWORKS
from vangan_torch.weights import flax_to_torch, torch_to_flax_variables

import torch_dp_worker as worker

TIMEOUT_S = 240
CASES = {  # name: (BATCH_SIZE a rank, cldice_groups)
    "batch1_groups2": (1, None),
    "batch2_groups2": (2, 2),
    "batch2_groups4": (2, 4),
}
VNET_SHAPE = (4, 16, 16, 16, 1)


def _cfg_kw(batch, groups):
    return dict(N_DEVICES=2, BATCH_SIZE=batch, SUBVOL_PATCH_SIZE=(16, 16, 16),
                compute_dtype="float32", cldice_iters=2, EPOCHS=2, cldice_groups=groups)


def _states(rng):
    """Seeded tiny networks with every 1-D parameter moved by 0.1 N(0, 1)."""
    models = worker.tiny_models()
    with torch.no_grad():
        for m in models.values():
            for p in m.parameters():
                if p.dim() == 1:
                    p.add_(0.1 * torch.from_numpy(rng.normal(size=p.shape).astype(np.float32)))
    return {n: models[n].state_dict() for n in NETWORKS}


def _batch(rng, n):
    real_I = rng.normal(size=(n, 16, 16, 16, 1)).astype(np.float32)
    real_S = np.where(rng.uniform(size=real_I.shape) > 0.7, 1.0, -1.0).astype(np.float32)
    return real_I, real_S


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(11)
    states = _states(rng)
    steps = {name: (_cfg_kw(b, g), _batch(rng, 2 * b)) for name, (b, g) in CASES.items()}
    fm, tm, variables, x = _models("s2i", rng, shape=VNET_SHAPE)
    gy = rng.normal(size=x.shape).astype(np.float32)  # the cotangent of a float32 output
    vol = rng.normal(size=(20, 18, 17, 1)).astype(np.float32)
    return states, steps, (fm, tm, variables, x.astype(np.float64), gy), vol


@pytest.fixture(scope="module")
def ranks(inputs):
    states, steps, (_, tm, _, x, gy), vol = inputs
    jobs = {name: ("grads_rank", dict(cfg_kw=kw, states=states, real_I=bI, real_S=bS,
                                      dtype=torch.float64))
            for name, (kw, (bI, bS)) in steps.items()}
    jobs["vnet"] = ("vnet_rank", dict(kw=_roles("s2i", use_attention_gate=False),
                                      state=tm.state_dict(), x=x, gy=gy))
    jobs["stitch"] = ("stitch_rank", dict(state=states["gen_IS"], vol=vol, stride=(8, 8, 8),
                                          batch_size=4))
    return parallel.spawn(worker.run, 2, (jobs,), device="cpu", timeout=TIMEOUT_S)


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_ranks_match_one_process_in_float64(inputs, ranks, case):
    states, steps, *_ = inputs
    kw, (real_I, real_S) = steps[case]
    gan = worker.tiny_gan(kw, states, None, torch.float64)
    assert gan.scales.groups == (kw["cldice_groups"] or 2)
    want_grads, want_losses = worker.grads_and_losses(gan, real_I, real_S)
    for r in ranks:
        assert not r["jax_imported"]
        got = r[case]
        for name in NETWORKS:
            g, w = got["grads"][name], want_grads[name]
            assert g.dtype == torch.float64
            assert float((g - w).norm()) <= 1e-10 * float(w.norm()), name
        for key, w in want_losses.items():
            np.testing.assert_allclose(got["losses"][key], w, rtol=1e-6, err_msg=key)


def test_cross_rank_batchnorm_matches_flax_on_the_global_batch(inputs, ranks):
    """The V-Net's BatchNorms across two ranks: output, gradients and
    ``batch_stats`` against flax's global-batch statistics (float64)."""
    _, _, (fm, tm, variables, x, gy), _ = inputs
    with flax_float64():
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), dict(variables))
        fm64 = fm.clone(dtype=jnp.float64)

        def f(params, xx):
            return fm64.apply({**v64, "params": params}, xx, train=True,
                              mutable=["batch_stats"])

        out, pull, upd = jax.vjp(f, v64["params"], jnp.asarray(x), has_aux=True)
        gp, gx = pull(jnp.asarray(gy))
        want_y, want_dx = np.asarray(out), np.asarray(gx)
        want_stats = jax.tree_util.tree_map(np.asarray, dict(upd)["batch_stats"])
        want_grads = flax_to_torch(jax.tree_util.tree_map(np.asarray, gp), tm)
    half = x.shape[0] // 2
    for rank, r in enumerate(ranks):
        got = r["vnet"]
        sl = slice(rank * half, (rank + 1) * half)
        np.testing.assert_allclose(got["y"].numpy(), want_y[sl], atol=1e-6, rtol=0)
        dx = got["dx"].numpy()
        assert np.linalg.norm(dx - want_dx[sl]) <= 1e-5 * np.linalg.norm(want_dx[sl])
        for name, g in got["grads"].items():
            w = want_grads[name].double()
            assert float((g - w).norm()) <= 1e-5 * float(w.norm()) + 1e-12, name
        sd = {**tm.state_dict(), **got["buffers"]}
        got_stats = torch_to_flax_variables(sd, tm)["batch_stats"]
        for path, w in jax.tree_util.tree_leaves_with_path(want_stats):
            g = got_stats
            for k in path:
                g = g[k.key]
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-12, err_msg=str(path))
    for name, b in ranks[0]["vnet"]["buffers"].items():
        assert torch.equal(b, ranks[1]["vnet"]["buffers"][name]), name


def test_two_rank_stitch_matches_one_process(inputs, ranks):
    states, _, _, vol = inputs
    gen = worker.tiny_models()["gen_IS"].eval()
    gen.load_state_dict(states["gen_IS"])
    with torch.inference_mode():
        want = stitch_subvolumes(gen, vol, (4, 16, 16, 16, 1), stride=(8, 8, 8), complete=True,
                                 padFactor=0.25, save=False, batch_size=4, device="cpu")
    assert ranks[1]["stitch"] is None
    got = ranks[0]["stitch"]
    assert got.shape == want.shape == vol.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=255 * 2.0 ** -16, rtol=0)
