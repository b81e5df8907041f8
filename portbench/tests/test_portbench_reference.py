"""The frozen reference against the program's CPU path at a tiny size (a bad
copy shows here), and the reference's independence from the program."""

import ast
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import REPO, TINY_FIELDS

from portbench import data, weights
from portbench.reference import step as ref_step
from portbench.reference.draws import Draws
from portbench.reference.layers import Ctx
from portbench.reference.nets import kind
from portbench.run_support import Run, build_gan

SEED = 3000000011


def _fields(config):
    with open(os.path.join(REPO, "portbench", "configs", config + ".json")) as f:
        return {**json.load(f)["fields"], **TINY_FIELDS}


def _run(config, patch=16):
    tr = {"batch": 3, "patch": [patch] * 3, "noise_std": 0.1}
    return Run(REPO, "t", _fields(config), tr, SEED, 0.0, False, torch.device("cpu"), 0.0)


@pytest.mark.parametrize("config", ["vangan_resunet", "vangan_resnet"])
def test_networks_agree_forward(config):
    h = _run(config)
    gan, fields, init = build_gan(h, BATCH_SIZE=3, SUBVOL_PATCH_SIZE=(16, 16, 16))
    x = torch.rand((3, 16, 16, 16, 1), generator=torch.Generator().manual_seed(1)) * 2 - 1
    seg = Draws(None, "cpu", torch.float32).segment()
    for name, k in ref_step.network_kinds(fields).items():
        with torch.no_grad():
            got = gan.nets[name](x)
            want = k.forward(init[name], x, Ctx(), seg, False, 0.0)
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("config", ["vangan_resunet", "vangan_resnet"])
def test_losses_and_one_step_agree(config):
    """The step's ten losses, every leaf's gradient (from Adam's first moment)
    and every leaf's update, with the same draws (noise, dropout)."""
    h = _run(config)
    gan, fields, init = build_gan(h, BATCH_SIZE=3, SUBVOL_PATCH_SIZE=(16, 16, 16))
    pool = data.train_pool(4, (16, 16, 16), SEED, "cpu")
    real_I, real_S = next(data.Feed(pool, 3, SEED))
    got = {k: float(v) for k, v in gan.distributed_train_step(real_I, real_S, 0.1, True).items()}
    ref = ref_step.run_steps(fields, weights.make(ref_step.specs(fields), SEED, "cpu"),
                             [(real_I, real_S)], torch.Generator().manual_seed(SEED + 1), 0.1,
                             h.steps_per_epoch, ckpt=False)
    assert set(got) == set(ref.losses[0])
    for k, v in ref.losses[0].items():
        assert got[k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
    # a leaf whose gradient is rounding (under 1e-3 of the median leaf's, as
    # a bias under a norm) gets an update of rounding's sign: not compared
    floor = 1e-3 * float(np.median(list(ref.grad1.values())))
    for name in ref_step.NETWORKS:
        opt = gan.state.opt[name]
        for pname, p in gan.nets[name].named_parameters():
            g = float(opt.state[p]["exp_avg"].norm()) / 0.5
            key = f"{name}/{pname}"
            assert g == pytest.approx(ref.grad1[key], rel=1e-4, abs=floor), key
            if ref.grad1[key] >= floor:
                change = float((p.detach() - init[name][pname]).norm())
                assert change == pytest.approx(ref.change[key], rel=1e-3), key


def test_the_stitcher_agrees():
    from vangan_torch.inference.stitcher import stitch_subvolumes

    from portbench.reference import stitch

    h = _run("vangan_resunet")
    gan, fields, init = build_gan(h, SUBVOL_PATCH_SIZE=(16, 16, 16))
    vol = data.volume(37, SEED, "cpu")
    got = stitch_subvolumes(gan.gen_IS_batched, vol, (8, 16, 16, 16, 1), stride=(8, 8, 8),
                            complete=True, padFactor=0.1, blend="gaussian", batch_size=8,
                            save=False, device="cpu")
    seg = Draws(None, "cpu", torch.float32).segment()
    want = stitch.stitch(lambda x: kind("resUnet").forward(init["gen_IS"], x, Ctx(), seg),
                         vol, 16, 8, 0.1, 5, "cpu")
    assert got.shape == want.shape == (37, 37, 37, 1)
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_the_reference_imports_nothing_of_the_program():
    files = glob.glob(os.path.join(REPO, "portbench", "reference", "**", "*.py"), recursive=True)
    assert files
    for path in files:
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("vangan_torch", "vangan_tpu", "jax", "flax"), \
                    (path, n)
    code = ("import sys\n"
            f"sys.path.insert(0, {REPO!r})\n"
            "import portbench.reference.step, portbench.reference.stitch\n"
            "import portbench.reference.nets.resUnet, portbench.reference.nets.resnet\n"
            "import portbench.reference.nets.patchgan\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('vangan_torch', 'vangan_tpu', 'jax', 'jaxlib', 'flax')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
