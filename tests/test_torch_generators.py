"""The port's other generator families and options against the flax package:
the ResU-Net with ``deconv`` upsampling and with the attention gate, the
ResNet generator, and every kind x role of the factory.

Flax runs on the NXCYZ layout, the port on its plain torch versions, from
one flax parameter tree with perturbed 1-D leaves, on inputs made with
numpy from a seed. Tolerances as ``test_torch_vnet.py``'s outputs: the port
in float64 within atol 1e-6 and in float32 within atol 1e-4 of flax in
float64 (the witness, ``test_torch_vnet.flax_float64_apply``), and in
float32 within atol 2e-3 of flax in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_vnet import _assert_output, _perturbed, flax_float64_apply

from vangan_tpu.config import VanGanConfig as JaxConfig
from vangan_tpu.models.factory import build_generator as jax_build_generator
from vangan_tpu.models.resnet_generator import ResNetGenerator3D as FlaxResNetGenerator3D
from vangan_tpu.models.resunet import ResUNet3D as FlaxResUNet3D
from vangan_torch.config import VanGanConfig
from vangan_torch.models.factory import build_generator
from vangan_torch.models.resnet_generator import ResNetGenerator3D
from vangan_torch.models.resunet import ResUNet3D
from vangan_torch.weights import flax_to_torch, load_flax_params, torch_to_flax_variables


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These networks are tiny: one intra-op thread is faster than many,
    and far faster when several test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(fm, tm, rng, shape=(2, 16, 16, 16, 1)):
    x = rng.uniform(-1, 1, size=shape).astype(np.float32)
    params = _perturbed(fm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"], rng)
    load_flax_params(tm, params)
    return params, x


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("option", [{"upsample_mode": "deconv"},
                                    {"use_attention_gate": True},
                                    {"upsample_mode": "deconv", "use_attention_gate": True}])
def test_resunet_options_match_flax(option, train):
    kw = {"upsample_mode": "simple", **option}
    fm = FlaxResUNet3D(dropout_type="none", filters=4, num_layers=2, output_activation="tanh",
                       layout="NXCYZ", dtype=jnp.float32, **kw)
    tm = ResUNet3D(filters=4, num_layers=2, **kw)
    params, x = _load(fm, tm, np.random.default_rng(0))
    want = fm.apply({"params": params}, jnp.asarray(x), train=train)
    want64 = flax_float64_apply(fm, {"params": params}, x, train)[0]
    _assert_output(tm, x, np.asarray(want), want64, train=train)


@pytest.mark.parametrize("train", [False, True])
def test_resnet_generator_matches_flax(train):
    """Two downsamples, two residual blocks, two upsamples at f=4 (7^3
    reflect stem and head, 4^3 'same' upsample convs); no dropout in
    training, whose draws differ between the frameworks."""
    kw = dict(filters=4, num_downsampling_blocks=2, num_residual_blocks=2,
              num_upsample_blocks=2, stem_dropout=0.0, downsample_dropout=0.0)
    fm = FlaxResNetGenerator3D(**kw, layout="NXCYZ", dtype=jnp.float32)
    tm = ResNetGenerator3D(**kw)
    params, x = _load(fm, tm, np.random.default_rng(1))
    want = fm.apply({"params": params}, jnp.asarray(x), train=train)
    want64 = flax_float64_apply(fm, {"params": params}, x, train)[0]
    _assert_output(tm, x, np.asarray(want), want64, train=train)


def test_resnet_gamma_init_is_he_normal():
    """The ResNet generator's InstanceNorm gammas are drawn with he_normal
    (fan_in = channels), as ``he_normal_1d``: not ones."""
    tm = build_generator("resnet", VanGanConfig(gen_filters=16),
                         generator=torch.Generator().manual_seed(0))
    g = tm.res0.inorm1.weight.detach()
    assert g.shape == (256,) and not torch.all(g == 1)
    std = (2.0 / 256) ** 0.5
    assert 0.5 * std < float(g.std()) < 1.5 * std and float(g.abs().max()) <= 2 * std / 0.8796


@pytest.mark.parametrize("role", ["i2s", "s2i"])
@pytest.mark.parametrize("kind", ["resUnet", "vnet", "resnet"])
def test_factory_names_and_shapes_match(kind, role):
    """Every kind x role of the factory at f=4: the same parameter names and
    shapes as ``vangan_tpu``'s (flax leaves mapped by ``flax_to_torch``,
    the deconvs by their module type), ``batch_stats`` counted apart: the
    s2i V-Net's 18 BatchNorms hold 36 of them, no other generator any."""
    jcfg = JaxConfig(gen_filters=4, compute_dtype="float32")
    fm = jax_build_generator(kind, jcfg, role=role)
    shapes = jax.eval_shape(lambda: fm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 32, 32, 32, 1))))
    zeros = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda s: np.zeros(s.shape, np.float32), tree)
    params = zeros(shapes["params"])
    stats = zeros(shapes["batch_stats"]) if "batch_stats" in shapes else None
    tm = build_generator(kind, VanGanConfig(gen_filters=4, compute_dtype="float32"), role=role)
    sd = flax_to_torch(params, tm, stats)
    n_stats = len(jax.tree_util.tree_leaves(stats)) if stats else 0
    n_buffers = len(list(tm.buffers()))
    assert n_stats == n_buffers == (36 if (kind, role) == ("vnet", "s2i") else 0)
    assert len(jax.tree_util.tree_leaves(params)) == len(list(tm.parameters()))
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    load_flax_params(tm, params, stats)
    back = torch_to_flax_variables(tm.state_dict(), tm)
    assert jax.tree_util.tree_structure(back["params"]) == \
        jax.tree_util.tree_structure(params)


@pytest.mark.parametrize("kind", ["vnet", "resnet"])
def test_dropout_draws_from_the_call_generator(kind):
    """The factory's V-Net (spatial dropout 0.5) and ResNet generator (0.5
    and 0.2): in training two calls with one seed agree and another seed
    differs; in eval no generator is needed and dropout is off."""
    cfg = VanGanConfig(gen_filters=2, compute_dtype="float32")
    tm = build_generator(kind, cfg, role="i2s", generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (1, 32, 32, 32, 1))
                         .astype(np.float32))
    with torch.no_grad():
        a = tm(x, True, torch.Generator().manual_seed(5))
        b = tm(x, True, torch.Generator().manual_seed(5))
        c = tm(x, True, torch.Generator().manual_seed(6))
        e1, e2 = tm(x), tm(x)
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.equal(e1, e2)
    assert not torch.equal(a, e1)
    with pytest.raises(ValueError, match="generator"):
        tm(x, True)


def test_make_dropout_dispatch():
    """'spatial' drops whole (b, c) planes, 'standard' single elements, both
    scaling what they keep by 1 / (1 - rate); 'none' is no layer; nothing
    is dropped outside training."""
    from vangan_torch.models.layers import make_dropout

    x = torch.ones(4, 8, 6, 6, 6)
    g = torch.Generator().manual_seed(0)
    spatial = make_dropout("spatial", 0.5)(x, train=True, generator=g)
    planes = spatial.flatten(2)
    assert torch.all((planes == 0).all(-1) | (planes == 2).all(-1))
    assert 0 < int((planes == 0).all(-1).sum()) < 32
    standard = make_dropout("standard", 0.5)(x, train=True, generator=g)
    assert set(standard.unique().tolist()) == {0.0, 2.0}
    assert not ((standard.flatten(2) == 0).all(-1) | (standard.flatten(2) == 2).all(-1)).all()
    assert make_dropout("none", 0.5) is None and make_dropout(None, 0.5) is None
    assert make_dropout("standard", 0.5)(x) is x
    with pytest.raises(ValueError, match="dropout_type"):
        make_dropout("alpha", 0.5)


def _partitions(root, shape=(36, 34, 33, 1)):
    """JAX-layout partition pickles of seeded .npy volumes: 1 training, 1
    validation and 1 testing volume per domain."""
    import pickle

    rng = np.random.default_rng(0)
    for dom, pid in (("img", "A"), ("seg", "B")):
        part = {}
        for split in ("training", "validation", "testing"):
            d = root / "data" / f"{split}{pid}"
            d.mkdir(parents=True)
            v = (rng.normal(size=shape) if dom == "img" else
                 np.where(rng.uniform(size=shape) > 0.9, 1.0, -1.0)).astype(np.float32)
            np.save(d / f"{dom}.npy", v)
            part[split] = np.array([str(d / f"{dom}.npy")], dtype=object)
        with open(root / "data" / f"data{pid}_partition.pkl", "wb") as f:
            pickle.dump(part, f)


@pytest.mark.parametrize("kind", ["vnet", "resnet"])
def test_train_and_predict_cli_run_every_family(tmp_path, kind):
    """``python -m vangan_torch train --predict-after`` and ``predict
    --epoch`` with both generators of ``kind`` (f=2, 32^3 patches, one epoch
    of one step) on the CPU: the checkpoint holds the s2i V-Net's running
    statistics, moved by the step, and the TIFFs come out."""
    from vangan_torch import cli
    from vangan_torch.data.preprocess import read_tiff

    _partitions(tmp_path)
    out = tmp_path / "out"
    cfg_path = str(tmp_path / "cfg.yaml")
    VanGanConfig(BATCH_SIZE=1, EPOCHS=1, SUBVOL_PATCH_SIZE=(32, 32, 32), gen_filters=2,
                 disc_filters=4, cldice_iters=2, train_steps=1, val_steps=1,
                 compute_dtype="float32", stitcher_batch=2, gen_i2s=kind, gen_s2i=kind,
                 output_dir=str(out)).to_yaml(cfg_path)
    cli.main(["train", "--config", cfg_path, "--data-dir", str(tmp_path / "data"),
              "--device", "cpu", "--predict-after"])
    ck = torch.load(out / "checkpoints" / "torch_e1.pt", weights_only=True)
    stats = {k: v for k, v in ck["gen_SI"].items() if k.endswith((".mean", ".var"))}
    assert len(stats) == (36 if kind == "vnet" else 0)
    if kind == "vnet":
        assert not torch.equal(stats["down0.bn0.mean"], torch.zeros(2))
    for name in ("VANGAN_img.tiff", "VANGAN_seg.tiff"):
        vol = read_tiff(str(out / name))
        assert vol.shape == (33, 36, 34, 1) and np.isfinite(vol).all()
    cli.main(["predict", "--config", cfg_path, "--input", str(tmp_path / "data" / "testingA"),
              "--output", str(tmp_path / "pred"), "--epoch", "1", "--stride", "16", "16", "16",
              "--device", "cpu"])
    assert read_tiff(str(tmp_path / "pred" / "VANGAN_img.tiff")).shape == (33, 36, 34, 1)
