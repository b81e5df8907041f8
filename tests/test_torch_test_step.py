"""The port's test step (the evaluation slice) against the JAX package's.

``make_step_fns(cfg, models).test_step`` of the JAX package and
``VanGan.distributed_test_step`` of the port run on the same batch
(``make_batch``) from the same four parameter trees (the JAX init, with the
1-D leaves perturbed, carried over by ``weights.load_flax_networks``), in
float32 on the CPU, at the size of ``test_train_step.tiny_cfg``: batch 2,
16^3, generators f=4 with 2 levels, discriminators f=8 with input noise,
layer noise and spatial dropout on (the test step runs them in eval, where
they are off), clDice with 2 iterations. The JAX side takes its plain paths
on the CPU (the Pallas skeleton falls back to XLA), the port its plain torch
versions. Tolerance: rtol 1e-4 on each of the ten losses (float32 sums in
another order through two generators, a discriminator and the reductions).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_train_step import make_batch, tiny_cfg

from vangan_tpu.models.discriminator import PatchGANDiscriminator3D as FlaxDisc
from vangan_tpu.models.resunet import ResUNet3D as FlaxResUNet3D
from vangan_tpu.training.step import make_step_fns
from vangan_torch.config import VanGanConfig
from vangan_torch.models.discriminator import PatchGANDiscriminator3D
from vangan_torch.models.resunet import ResUNet3D
from vangan_torch.training import step as torch_step
from vangan_torch.training.step import RESULT_KEYS
from vangan_torch.vangan import VanGan, train
from vangan_torch.weights import load_flax_networks

DISC = dict(filters=8, use_dropout=True, use_input_noise=True, use_layer_noise=True)


def _jax_models():
    gen = dict(upsample_mode="simple", filters=4, num_layers=2, dropout_type="none",
               output_activation="tanh", layout="NXCYZ", dtype=jnp.float32)
    disc = dict(DISC, layout="NXCYZ", dtype=jnp.float32)
    return {"gen_IS": FlaxResUNet3D(**gen), "gen_SI": FlaxResUNet3D(**gen),
            "disc_I": FlaxDisc(**disc), "disc_S": FlaxDisc(**disc)}


def _torch_gan(jax_cfg, params):
    cfg = VanGanConfig(N_DEVICES=jax_cfg.N_DEVICES, BATCH_SIZE=jax_cfg.BATCH_SIZE,
                       SUBVOL_PATCH_SIZE=jax_cfg.SUBVOL_PATCH_SIZE, compute_dtype="float32",
                       cldice_iters=jax_cfg.cldice_iters)
    models = {"gen_IS": ResUNet3D(4, 2), "gen_SI": ResUNet3D(4, 2),
              "disc_I": PatchGANDiscriminator3D(**DISC),
              "disc_S": PatchGANDiscriminator3D(**DISC)}
    gan = VanGan(cfg, device="cpu", models=models)
    load_flax_networks(gan, params)
    return gan


@functools.lru_cache(maxsize=None)
def _jax_step(n_devices=1):
    """(config, perturbed params, real_I, real_S, JAX losses) at batch 2
    split over ``n_devices``; computed once per module run."""
    jax_cfg = tiny_cfg(N_DEVICES=n_devices, BATCH_SIZE=2 // n_devices)
    rng = np.random.default_rng(0)
    fns = make_step_fns(jax_cfg, _jax_models(), steps_per_epoch=1)
    state = fns.init(jax.random.PRNGKey(0))
    # non-trivial IN affines and conv biases, so their mapping is exercised
    params = jax.tree_util.tree_map(
        lambda p: p + 0.1 * jnp.asarray(rng.normal(size=p.shape), p.dtype)
        if p.ndim == 1 else p, state.params)
    state = state.replace(params=params)
    real_I, real_S = make_batch(rng, jax_cfg)
    want = fns.test_step(state, real_I, real_S, jax.random.PRNGKey(7))
    return (jax_cfg, params, np.array(real_I), np.array(real_S),
            {k: float(v) for k, v in want.items()})


@pytest.mark.parametrize("n_devices", [1, 2])
def test_test_step_matches_jax(n_devices):
    """All ten losses; ``N_DEVICES=2`` (batch 1 per device) evaluates clDice
    in two groups and doubles the axis=None quirk scale."""
    jax_cfg, params, real_I, real_S, want = _jax_step(n_devices)
    gan = _torch_gan(jax_cfg, params)
    got = gan.distributed_test_step(real_I, real_S)
    assert sorted(got) == sorted(want) == sorted(RESULT_KEYS)
    for key in RESULT_KEYS:
        assert got[key].shape == () and got[key].device == gan.device
        np.testing.assert_allclose(float(got[key]), want[key], rtol=1e-4, err_msg=key)


class _Summary:
    def __init__(self):
        self.calls = []

    def scalar(self, name, value, epoch, training=True):
        self.calls.append((name, value, epoch, training))


def test_train_evaluates_each_batch_and_summarises():
    jax_cfg, params, real_I, real_S, want = _jax_step()
    gan = _torch_gan(jax_cfg, params)
    batches = iter([(real_I, real_S)] * 3)
    summary = _Summary()
    results = train(batches, gan, summary, epoch=4, steps=2, training=False)
    assert next(batches)  # the third batch was not taken
    assert sorted(results) == sorted(RESULT_KEYS)
    assert all(len(v) == 2 and v[0] == v[1] for v in results.values())
    assert sorted(c[0] for c in summary.calls) == sorted(RESULT_KEYS)
    for name, value, epoch, training in summary.calls:
        assert (epoch, training) == (4, False)
        np.testing.assert_allclose(value, want[name], rtol=1e-4)
    stepped = train(iter([(real_I, real_S)]), gan, summary, epoch=0, training=True,
                    noise_std=0.1)
    assert gan.state.step == 1 and all(len(v) == 1 for v in stepped.values())


def test_weights_round_trip_and_generators_only_file(tmp_path):
    cfg = VanGanConfig(gen_filters=2, disc_filters=2, SUBVOL_PATCH_SIZE=(16, 16, 16))
    a = VanGan(cfg, device="cpu")
    b = VanGan(VanGanConfig(gen_filters=2, disc_filters=2, seed=1), device="cpu")
    a.save_weights(str(tmp_path / "all.pt"))
    b.load_weights(str(tmp_path / "all.pt"))
    for name in a.nets:
        for (ka, va), (kb, vb) in zip(a.nets[name].state_dict().items(),
                                      b.nets[name].state_dict().items()):
            assert ka == kb and torch.equal(va, vb)
    # a generators-only file (the predict slice's format) still loads
    torch.save({"gen_IS": a.gen_IS.state_dict(), "gen_SI": a.gen_SI.state_dict()},
               tmp_path / "gens.pt")
    c = VanGan(VanGanConfig(gen_filters=2, disc_filters=2, seed=2), device="cpu")
    disc_before = {k: v.clone() for k, v in c.disc_I.state_dict().items()}
    c.load_weights(str(tmp_path / "gens.pt"))
    assert all(torch.equal(v, a.gen_IS.state_dict()[k]) for k, v in c.gen_IS.state_dict().items())
    assert all(torch.equal(v, disc_before[k]) for k, v in c.disc_I.state_dict().items())
    torch.save({"gen_IS": a.gen_IS.state_dict()}, tmp_path / "one.pt")
    with pytest.raises(KeyError, match="gen_SI"):
        c.load_weights(str(tmp_path / "one.pt"))


def test_training_forward_judges_each_fake_twice_with_the_same_noise():
    """In training each fake goes through D twice (step.py:277-280): with
    detached parameters (gradient to the fake only) and on the detached fake
    (gradient to D only), with the same noise and dropout draws."""
    disc = PatchGANDiscriminator3D(**dict(DISC, filters=4))
    fake = torch.rand(1, 16, 16, 16, 1, requires_grad=True)
    gen_branch, dis_branch = torch_step.judged_twice(disc, fake, 0.1,
                                                      torch.Generator().manual_seed(0))
    assert torch.equal(gen_branch, dis_branch)
    assert not torch.equal(gen_branch, disc(fake))  # noise and dropout were on
    gen_branch.sum().backward()
    assert fake.grad is not None and all(p.grad is None for p in disc.parameters())
    fake.grad = None
    dis_branch.sum().backward()
    assert fake.grad is None and all(p.grad is not None for p in disc.parameters())


def test_training_forward_is_seeded_and_finite():
    jax_cfg, params, real_I, real_S, _ = _jax_step()
    gan = _torch_gan(jax_cfg, params)
    x, y = torch.from_numpy(real_I), torch.from_numpy(real_S)
    runs = []
    for _ in range(2):
        with torch.no_grad():
            _, result = torch_step.compute_losses(
                gan.nets, gan.cfg, gan.scales, x, y, train=True, noise_std=0.1,
                generator=torch.Generator().manual_seed(5))
        runs.append(result)
    assert all(torch.equal(runs[0][k], runs[1][k]) for k in RESULT_KEYS)
    assert all(bool(torch.isfinite(v)) for v in runs[0].values())
