"""The port's 2-D train and test steps (DIMENSIONS=2) against the JAX
package's 2-D step, and the 2-D training state through the weight map and
the checkpoints.

At ``test_2d.cfg2d`` (batch 2, 16 x 16 images, generators f=4 with 2
levels, discriminators f=8, clDice with 2 iterations), float32 on the CPU:
JAX through XLA (its 2-D path), the port on its plain torch versions, from
JAX's init with its 1-D leaves perturbed, noise and dropout off (their
random draws differ between the frameworks). Tolerances:

- the ten losses: 1e-5 relative;
- each network's gradient of the one backward against
  ``jax.grad(compute_losses)``: 2e-3 relative L2 (the rule of the 3-D step,
  ``test_torch_train_step.py``: float32 forwards of random-init networks
  that differ in the last bits, through a gradient that is not smooth in
  them);
- the gradient penalty at JAX's interpolation weights, shaped (B, 1, 1, 1):
  1e-5 relative, its parameter gradient 2e-4 relative L2
  (``test_torch_wgan.py``);
- the checkpoint and the export bundle: exact, and the bundle's networks
  in JAX within atol 1e-4 of the port's outputs.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_2d import cfg2d
from test_torch_train_step import _as_flax, _flat

import vangan_tpu.losses as J
from vangan_tpu import checkpoint as jax_checkpoint
from vangan_tpu.models import PatchGANDiscriminator3D as FlaxDisc
from vangan_tpu.models import ResUNet3D as FlaxResUNet3D
from vangan_tpu.training.step import make_step_fns
from vangan_torch import checkpoint
from vangan_torch import losses as T
from vangan_torch.config import VanGanConfig
from vangan_torch.models.discriminator import PatchGANDiscriminator3D
from vangan_torch.models.resunet import ResUNet3D
from vangan_torch.training import step as torch_step
from vangan_torch.training.state import NETWORKS
from vangan_torch.training.step import RESULT_KEYS
from vangan_torch.vangan import VanGan
from vangan_torch.weights import load_flax_networks, load_flax_params

STEPS_PER_EPOCH = 3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_models():
    gen = dict(upsample_mode="simple", filters=4, num_layers=2, dropout_type="none")
    disc = dict(filters=8, use_dropout=False, use_input_noise=False, use_layer_noise=False)
    return {"gen_IS": FlaxResUNet3D(**gen), "gen_SI": FlaxResUNet3D(**gen),
            "disc_I": FlaxDisc(**disc), "disc_S": FlaxDisc(**disc)}


@functools.lru_cache(maxsize=None)
def _jax_step():
    """(config, perturbed params, real_I, real_S, JAX grads, JAX losses, JAX
    test-step losses), computed once per module run."""
    cfg = cfg2d()
    rng = np.random.default_rng(0)
    fns = make_step_fns(cfg, _jax_models(), steps_per_epoch=STEPS_PER_EPOCH)
    state = fns.init(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(
        lambda p: p + 0.1 * jnp.asarray(rng.normal(size=p.shape), p.dtype)
        if p.ndim == 1 else p, state.params)
    state = state.replace(params=params)
    real_I = rng.normal(size=(2, 16, 16, 1)).astype(np.float32)
    real_S = (2.0 * (rng.uniform(size=(2, 16, 16, 1)) > 0.7) - 1.0).astype(np.float32)
    grads, (result, _) = jax.grad(fns.compute_losses, argnums=0, has_aux=True)(
        params, state.model_state, jnp.asarray(real_I), jnp.asarray(real_S),
        jax.random.PRNGKey(7), jnp.zeros(()), True, None)
    test = fns.test_step(state, jnp.asarray(real_I), jnp.asarray(real_S), jax.random.PRNGKey(8))
    host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return (cfg, params, real_I, real_S, host(grads), {k: float(v) for k, v in result.items()},
            {k: float(v) for k, v in test.items()})


def _torch_gan(params=None, **cfg_kw):
    jcfg = _jax_step()[0]
    cfg = VanGanConfig(N_DEVICES=1, BATCH_SIZE=jcfg.BATCH_SIZE, DIMENSIONS=2,
                       SUBVOL_PATCH_SIZE=jcfg.SUBVOL_PATCH_SIZE, compute_dtype="float32",
                       cldice_iters=jcfg.cldice_iters, EPOCHS=jcfg.EPOCHS, **cfg_kw)
    g = torch.Generator().manual_seed(0)
    disc = dict(filters=8, dims=2, generator=g)
    models = {"gen_IS": ResUNet3D(4, 2, "simple", dims=2, generator=g),
              "gen_SI": ResUNet3D(4, 2, "simple", dims=2, generator=g),
              "disc_I": PatchGANDiscriminator3D(**disc),
              "disc_S": PatchGANDiscriminator3D(**disc)}
    gan = VanGan(cfg, device="cpu", models=models, steps_per_epoch=STEPS_PER_EPOCH)
    if params is not None:
        load_flax_networks(gan, params)
    return gan


@pytest.fixture(scope="module")
def port_grads():
    _, params, real_I, real_S, *_ = _jax_step()
    gan = _torch_gan(params)
    grads, result = torch_step.compute_grads(
        gan.nets, gan.cfg, gan.scales, torch.from_numpy(real_I), torch.from_numpy(real_S), 0.0,
        gan.generator)
    return gan, grads, {k: float(v) for k, v in result.items()}


def test_losses_2d_match_jax(port_grads):
    *_, want, _ = _jax_step()
    _, _, got = port_grads
    assert sorted(got) == sorted(RESULT_KEYS) == sorted(want)
    for key in RESULT_KEYS:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("name", NETWORKS)
def test_one_backward_2d_matches_jax_grad(port_grads, name):
    gan, grads, _ = port_grads
    got = _flat(_as_flax(gan.nets[name], grads[name]))
    want = _flat(_jax_step()[4][name])
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) <= 2e-3 * np.linalg.norm(want)


def test_test_step_2d_matches_jax():
    _, params, real_I, real_S, *_, want = _jax_step()
    got = _torch_gan(params).distributed_test_step(real_I, real_S)
    for key in RESULT_KEYS:
        np.testing.assert_allclose(float(got[key]), want[key], rtol=1e-5, err_msg=key)


def test_train_step_2d_runs_with_noise_and_dropout():
    """The factory's networks in 2-D with noise and dropout on: finite
    losses, every parameter moved, and the same step from the same seed. At
    32^2 the generators' 4 levels end on 2 x 2 planes (a 1 x 1 plane's
    InstanceNorm is constant, and the layers before it get no gradient)."""
    rng = np.random.default_rng(3)
    real_I = rng.normal(size=(2, 32, 32, 1)).astype(np.float32)
    real_S = (2.0 * (rng.uniform(size=(2, 32, 32, 1)) > 0.7) - 1.0).astype(np.float32)
    kw = dict(N_DEVICES=1, BATCH_SIZE=2, DIMENSIONS=2, SUBVOL_PATCH_SIZE=(32, 32, 32),
              gen_filters=2, disc_filters=4, cldice_iters=2, compute_dtype="float32")
    runs = []
    for _ in range(2):
        gan = VanGan(VanGanConfig(**kw), device="cpu")
        before = {n: [p.detach().clone() for p in net.parameters()]
                  for n, net in gan.nets.items()}
        out = gan.distributed_train_step(real_I, real_S, 0.1, True)
        assert all(np.isfinite(float(v)) for v in out.values()) and len(out) == 10
        for n, net in gan.nets.items():
            assert all(not torch.equal(a, b) for a, b in zip(before[n], net.parameters())), n
        runs.append({k: float(v) for k, v in out.items()})
    assert runs[0] == runs[1]


def test_gradient_penalty_2d_matches_jax():
    """The penalty's interpolation weights are (B, 1, 1, 1) on images."""
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, size=(2, 16, 16, 1)).astype(np.float32)
    fake = np.tanh(rng.normal(size=x.shape)).astype(np.float32)
    fm = FlaxDisc(filters=8, dtype=jnp.float32)
    params = fm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    key = jax.random.PRNGKey(5)
    js = J.LossScales(global_batch_size=2, n_devices=1)

    def jax_gp(p):
        return J.gradient_penalty(js, lambda v: fm.apply({"params": p}, v, train=True),
                                  jnp.asarray(x), jnp.asarray(fake), key)

    want, want_g = jax.value_and_grad(jax_gp)(params)
    tm = load_flax_params(PatchGANDiscriminator3D(filters=8, dims=2), params)
    alpha = torch.from_numpy(np.array(jax.random.normal(key, (2, 1, 1, 1))))
    gp = T.gradient_penalty(T.LossScales(global_batch_size=2, n_devices=1),
                            lambda v: tm(v, True, 0.0, torch.Generator()),
                            torch.from_numpy(x), torch.from_numpy(fake), alpha=alpha)
    np.testing.assert_allclose(gp.item(), float(want), rtol=1e-5)
    got = torch.autograd.grad(gp, list(tm.parameters()), allow_unused=True,
                              materialize_grads=True)  # the head's bias
    g, w = _flat(_as_flax(tm, got)), _flat(jax.tree_util.tree_map(np.asarray, want_g))
    assert np.linalg.norm(g - w) <= 2e-4 * np.linalg.norm(w)


def test_checkpoint_and_bundle_2d_round_trip(tmp_path):
    """A 2-D VanGan's checkpoint restores every tensor; its export bundle
    loads in JAX (a 2-D factory there) and in the port."""
    kw = dict(output_dir=str(tmp_path), DIMENSIONS=2, SUBVOL_PATCH_SIZE=(16, 16, 16),
              gen_filters=4, disc_filters=8, compute_dtype="float32", BATCH_SIZE=2)
    gan = VanGan(VanGanConfig(**kw), device="cpu")
    _, _, real_I, real_S, *_ = _jax_step()
    gan.distributed_train_step(real_I, real_S, 0.1, True)
    gan.save_checkpoint(0)
    gan.checkpointer.wait_until_finished()
    other = VanGan(VanGanConfig(**kw, seed=5), device="cpu")
    other.load_checkpoint(epoch=1)
    for name in NETWORKS:
        a, b = gan.nets[name].state_dict(), other.nets[name].state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a), name
    assert other.state.step == 1

    path = checkpoint.export_models(gan.cfg, gan.nets, epoch=0)
    _, jnets = jax_checkpoint.load_exported(path)
    _, tnets = checkpoint.load_exported(path, device="cpu")
    x = np.random.default_rng(7).normal(size=(1, 16, 16, 1)).astype(np.float32)
    for name in NETWORKS:
        module, variables = jnets[name]
        want = np.asarray(module.apply(variables, jnp.asarray(x), train=False))
        with torch.no_grad():
            got = gan.nets[name](torch.from_numpy(x)).numpy()
            again = tnets[name](torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4, err_msg=name)
        assert np.array_equal(got, again), name
    assert os.path.isdir(path)


def test_train_cli_2d(tmp_path):
    """``python -m vangan_torch train --predict-after`` with a DIMENSIONS: 2
    config on (H, W, 1) .npy images: the checkpoint, the 2-D panels and one
    (h, w) page per test image."""
    import pickle

    from vangan_torch import cli
    from vangan_torch.data.preprocess import read_tiff

    rng = np.random.default_rng(0)
    for dom, pid in (("img", "A"), ("seg", "B")):
        part = {}
        for split, n in (("training", 2), ("validation", 1), ("testing", 1)):
            d = tmp_path / "data" / f"{split}{pid}"
            d.mkdir(parents=True)
            for i in range(n):
                v = (rng.normal(size=(40, 36, 1)) if dom == "img" else
                     np.where(rng.uniform(size=(40, 36, 1)) > 0.9, 1.0, -1.0))
                np.save(d / f"{dom}{i}.npy", v.astype(np.float32))
            part[split] = np.array([str(d / f"{dom}{i}.npy") for i in range(n)], dtype=object)
        with open(tmp_path / "data" / f"data{pid}_partition.pkl", "wb") as f:
            pickle.dump(part, f)
    out = tmp_path / "out"
    # 32^2 patches: predict-after's stride 25 covers the image
    VanGanConfig(BATCH_SIZE=1, EPOCHS=2, DIMENSIONS=2, SUBVOL_PATCH_SIZE=(32, 32, 32),
                 gen_filters=4, disc_filters=8, cldice_iters=2, train_steps=2, val_steps=1,
                 PERIOD_2D_CALLBACK=2, compute_dtype="float32", stitcher_batch=4,
                 output_dir=str(out)).to_yaml(str(tmp_path / "cfg.yaml"))
    cli.main(["train", "--config", str(tmp_path / "cfg.yaml"), "--data-dir",
              str(tmp_path / "data"), "--device", "cpu", "--predict-after"])
    ck = torch.load(out / "checkpoints" / "torch_e2.pt", weights_only=True)
    assert ck["train_state"]["step"] == 4
    assert ck["gen_IS"]["head.weight"].shape == (1, 4, 1, 1, 1)
    for f in ("2_genIS.png", "2_genSI.png", "dataset_sample_2d.png"):
        assert (out / "GANMonitor" / f).is_file(), f
    for name in ("VANGAN_img0.tiff", "VANGAN_seg0.tiff"):
        img = read_tiff(str(out / name))
        assert img.shape == (1, 40, 36, 1) and np.isfinite(img).all()
