"""The V-Net reference (``reference/nets/vnet.py``, the kind of
``configs/vangan_vnet.json``) against the program's CPU path at a tiny size
in float32: each role's forward in eval and in training with the same
dropout draws, one step's losses, first gradients and changes; a run of the
harness on the cell; its work counts against hand counts; and its
independence from the program.

Tolerances: ``test_portbench_reference.py``'s (forward 1e-4 relative and
1e-5 absolute; losses 1e-5, gradients 1e-4 and changes 1e-3 relative), each
widened by twice what float32 rounding alone moves the reference by, read
as its distance from the same computation in float64 (the witness). The
V-Net's ReLU before every norm and its batch norms over a few voxels make
float32 rounding grow: at 32^3 the reference's own gradient of the first
InstanceNorm's beta sits 2.6e-2 from its float64 run, the program 4e-3 from
the reference; where the reference is well conditioned the witness adds
next to nothing.
"""

import ast
import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import REPO, TINY_FIELDS, TINY_LIMITS, drive, make_tiny

from portbench import data, weights, work
from portbench.reference import step as ref_step
from portbench.reference.draws import Draws
from portbench.reference.layers import Ctx
from portbench.reference.nets import vnet
from portbench.run_support import Run, build_gan

SEED = 3000000019
PATCH = 32  # 4 levels down to a 2^3 bottleneck


def _fields():
    with open(os.path.join(REPO, "portbench", "configs", "vangan_vnet.json")) as f:
        return {**json.load(f)["fields"], **TINY_FIELDS}


def _built():
    tr = {"batch": 3, "patch": [PATCH] * 3, "noise_std": 0.1}
    h = Run(REPO, "t", _fields(), tr, SEED, 0.0, False, torch.device("cpu"), 0.0)
    return h, *build_gan(h, BATCH_SIZE=3, SUBVOL_PATCH_SIZE=(PATCH,) * 3)


@pytest.fixture(scope="module")
def built():
    return _built()


def test_the_configuration_is_the_v_net_in_both_roles(built):
    _, gan, fields, _ = built
    assert fields["gen_i2s"] == fields["gen_s2i"] == "vnet"
    assert ref_step.network_kinds(fields)["gen_IS"] is vnet
    names = {n: dict(gan.nets[n].named_parameters()) for n in ("gen_IS", "gen_SI")}
    f = TINY_FIELDS["gen_filters"]
    assert names["gen_IS"]["bottleneck.conv1.weight"].shape[0] == 32 * f  # 2f .. 32f
    assert names["gen_SI"]["bottleneck.conv1.weight"].shape[0] == 16 * f  # f .. 16f
    assert "upconv0.weight" in names["gen_IS"] and "deconv0.weight" in names["gen_SI"]
    assert len(ref_step.state_specs(fields)["gen_SI"]) == 36
    assert not ref_step.state_specs(fields)["gen_IS"]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", ["gen_IS", "gen_SI"])
def test_each_role_forward_agrees(built, name, train):
    """Training: batch statistics, and the dropout's uniforms drawn in the
    same order from equal generators. Eval: the running statistics, moved
    first by a training call so that they are neither zeros nor ones."""
    _, gan, fields, init = built
    net = copy.deepcopy(gan.nets[name])
    x = torch.rand((3, PATCH, PATCH, PATCH, 1), generator=torch.Generator().manual_seed(1))
    x = 2 * x - 1
    with torch.no_grad():
        if not train:
            net(x, True, torch.Generator().manual_seed(5))
        got = net(x, train, torch.Generator().manual_seed(7))
    names = ref_step.state_specs(fields)[name]
    state = {k: v for k, v in net.state_dict().items() if k in names}
    if name == "gen_SI" and not train:
        assert state["down0.bn0.var"].ne(1.0).all()
    P = {**init[name], **state}
    want = {}
    for dt in (torch.float32, torch.float64):
        seg = Draws(torch.Generator().manual_seed(7), "cpu", torch.float32).segment()
        with torch.no_grad():
            want[dt] = vnet.forward({k: v.to(dt) for k, v in P.items()}, x.to(dt), Ctx(), seg,
                                    train, 0.0)
        # five dropout draws in training (four encoder blocks and the bottleneck), none in eval
        assert len(seg.kept) == (5 if train else 0)
    assert got.shape == want[torch.float32].shape == x.shape
    witness = float((want[torch.float32] - want[torch.float64]).abs().max())
    torch.testing.assert_close(got, want[torch.float32], rtol=1e-4, atol=1e-5 + 2 * witness)


def test_eval_without_running_statistics_raises(built):
    _, _, fields, init = built
    x = torch.zeros((1, PATCH, PATCH, PATCH, 1))
    with pytest.raises(KeyError, match="mean"):
        vnet.forward(init["gen_SI"], x, Ctx(), Draws(None, "cpu", torch.float32).segment())


def _witness(fields, P0, real_I, real_S):
    """The reference's first step in float64 with the same draws: its losses,
    each leaf's clipped gradient norm, each leaf's change after one Adam step
    (lr g / (|g| + eps) elementwise, Adam's first step), and the leaves that
    hold an element whose gradient is rounding's (nonzero, under 1e-6 of the
    leaf's largest: a conv bias that the next norm cancels where the ReLU
    passed the whole plane). In float32 such an element's gradient is ~1e-8
    and Adam steps it by a good part of the learning rate, on either side as
    rounding falls."""
    P = {n: {k: v.detach().double().requires_grad_() for k, v in p.items()}
         for n, p in P0.items()}
    draws = Draws(torch.Generator().manual_seed(SEED + 1), "cpu", torch.float32)
    total, result = ref_step.compute_losses(fields, P, real_I.double(), real_S.double(), draws,
                                            0.1, Ctx(), ckpt=False)
    total.backward()
    lr = ref_step.lr_at(fields, 0, fields["train_steps"])
    grad1, change, rounding = {}, {}, set()
    for n, p in P.items():
        for k, v in p.items():
            g = v.grad if v.grad is not None else torch.zeros_like(v)
            g = g * min(1.0, ref_step.CLIPNORM / max(float(g.norm()), 1e-12))
            grad1[f"{n}/{k}"] = float(g.norm())
            change[f"{n}/{k}"] = float((lr * g / (g.abs() + ref_step.EPS)).norm())
            if ((g != 0) & (g.abs() < 1e-6 * g.abs().max())).any():
                rounding.add(f"{n}/{k}")
    return {k: float(v.detach()) for k, v in result.items()}, grad1, change, rounding


def test_losses_and_one_step_agree():
    """The step's ten losses, every leaf's gradient (from Adam's first
    moment) and every moving leaf's update, with the same draws (noise,
    dropout), through the program's step and the reference's ``run_steps``."""
    h, gan, fields, init = _built()
    pool = data.train_pool(4, (PATCH,) * 3, SEED, "cpu")
    real_I, real_S = next(data.Feed(pool, 3, SEED))
    got = {k: float(v) for k, v in gan.distributed_train_step(real_I, real_S, 0.1, True).items()}
    P0 = weights.make(ref_step.specs(fields), SEED, "cpu")
    ref = ref_step.run_steps(fields, P0, [(real_I, real_S)],
                             torch.Generator().manual_seed(SEED + 1), 0.1, h.steps_per_epoch,
                             ckpt=False)
    losses64, grad64, change64, rounding = _witness(fields, P0, real_I, real_S)
    assert set(got) == set(ref.losses[0]) == set(losses64)
    for k, v in ref.losses[0].items():
        assert got[k] == pytest.approx(v, rel=1e-5 + 2 * abs(v - losses64[k]) / abs(v),
                                       abs=1e-7), k
    # a leaf whose gradient is rounding (under 1e-3 of the median leaf's, as
    # a bias under a norm) gets an update of rounding's sign, and so does a
    # leaf with an element of rounding: their changes are not compared
    floor = 1e-3 * float(np.median(list(ref.grad1.values())))
    compared = 0
    for name in ref_step.NETWORKS:
        opt = gan.state.opt[name]
        for pname, p in gan.nets[name].named_parameters():
            g = float(opt.state[p]["exp_avg"].norm()) / 0.5
            key = f"{name}/{pname}"
            r = ref.grad1[key]
            assert g == pytest.approx(r, rel=1e-4, abs=floor + 2 * abs(r - grad64[key])), key
            if r >= floor and key not in rounding:
                change, r = float((p.detach() - init[name][pname]).norm()), ref.change[key]
                assert change == pytest.approx(r, rel=1e-3, abs=2 * abs(r - change64[key])), key
                compared += 1
    assert set(ref.grad1) == set(grad64) == {f"{n}/{k}" for n in ref_step.NETWORKS
                                             for k, _ in gan.nets[n].named_parameters()}
    assert compared > len(ref.grad1) // 2


def test_the_harness_runs_the_cell_and_catches_its_faults(tmp_path):
    """``vnet-train-b3`` through ``run.py`` at the tiny copy's size, held to
    the tiny limits of the first step's loss and median leaf gradient:
    correct as it is, not correct with the update skipped or half of each
    batch dropped. At 16^3 in float32 the V-Net is chaotic: the reference
    against itself with its weights moved by 1e-7 (relative) reads 1.5e-1 on
    the second step's losses (the ResU-Net 5.7e-4), and its own float32
    gradients sit up to 0.2 from float64 on batch norm leaves, so the whole
    networks' gradient norms (``grad_net``), later steps' losses (``loss``)
    and changes (``change_median``) wobble past the tiny limits run to run."""
    root = make_tiny(str(tmp_path))
    limits = {k: TINY_LIMITS["train"][k] for k in ("loss1", "grad1_median")}
    with open(os.path.join(root, "portbench", "limits", "vnet-train-b3.json"), "w") as f:
        json.dump({"limits": limits}, f)
    for plant in (None, "unchanged", "half_batch"):
        rc, result, err = drive(root, "vnet-train-b3", plant=plant)
        assert rc == 0, err
        assert result["correct"] is (plant is None), (plant, result["checks"])
        if plant is None:
            assert set(result["metrics"]) == {"train_patches_per_s", "train_step_p90_ms",
                                              "setup_s"}
            assert set(result["checks"]) == set(limits)
            assert result["failed"] == 0


def _meta_params(spec):
    meta = torch.device("meta")
    return {k: torch.empty(shape, device=meta, requires_grad=True)
            for k, (shape, _) in spec.leaves.items()}


@pytest.mark.parametrize("role", ["i2s", "s2i"])
def test_a_block_counts_two_3x3x3_convs_and_two_norms(role):
    """down1 of the published widths: 2f -> 4f (i2s, InstanceNorm, biased
    convs) or f -> 2f (s2i, BatchNorm) at 64^3, batch 3, in bfloat16."""
    fields = {"gen_filters": 16}
    P = _meta_params(vnet.spec(fields, role))
    ci = 32 if role == "i2s" else 16
    co = 2 * ci
    x = torch.empty(3, ci, 64, 64, 64, device="meta", requires_grad=True)
    rec = []
    vnet.block(P, Ctx(record=rec), None, "down1", x, True, False)
    assert [r[0] for r in rec] == ["conv", "in", "conv", "in"] if role == "i2s" else \
        [r[0] for r in rec] == ["conv", "bn", "conv", "bn"]
    got = work.tally(rec, act_bytes=2)
    vox = 3 * 64 ** 3
    per_pass = 2 * vox * co * ci * 27 + 2 * vox * co * co * 27
    assert got.conv_flops == 3 * per_pass  # forward, dgrad, wgrad of each conv
    assert got.norm_bytes == 2 * (2 + 3) * vox * co * 2
    # without a backward, the forwards alone
    assert work.tally(rec, 2, backward=False).conv_flops == per_pass
    assert work.tally(rec, 2, backward=False).norm_bytes == 2 * 2 * vox * co * 2


def test_a_deconv_counts_its_input_voxels():
    """deconv0 of the published s2i widths: 256 -> 128 channels, 8^3 -> 16^3."""
    P = _meta_params(vnet.spec({"gen_filters": 16}, "s2i"))
    x = torch.empty(3, 256, 8, 8, 8, device="meta", requires_grad=True)
    rec = []
    y = vnet.up(P, Ctx(record=rec), 0, x)
    assert tuple(y.shape) == (3, 128, 16, 16, 16)
    ((kind, xs, ws, ys, dx, dw),) = rec
    assert (kind, xs, ws, ys, dx, dw) == ("conv_transpose", (3, 256, 8, 8, 8),
                                          (256, 128, 2, 2, 2), (3, 128, 16, 16, 16), True, True)
    flops = 2 * 3 * 8 ** 3 * 256 * 128 * 8  # 2 B Ci Co k^3 on the input voxels
    got = work.tally(rec, 2)
    assert got.conv_flops == 3 * flops
    xb, wb, yb = 3 * 256 * 8 ** 3 * 2, 256 * 128 * 8 * 2, 3 * 128 * 16 ** 3 * 2
    bounds = [max(flops / 989e12, (xb + wb + yb) / 3.35e12)] * 2 + \
        [max(flops / 989e12, (xb + yb + 256 * 128 * 8 * 4) / 3.35e12)]
    assert got.conv_bound_s == pytest.approx(sum(bounds), rel=1e-12)
    assert got.norm_bytes == 0


def test_the_v_net_reference_imports_nothing_of_the_program():
    path = os.path.join(REPO, "portbench", "reference", "nets", "vnet.py")
    for node in ast.walk(ast.parse(open(path).read())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                 [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        assert all(n.split(".")[0] in ("torch", "portbench") for n in names), names
    code = ("import sys\n"
            f"sys.path.insert(0, {REPO!r})\n"
            "import portbench.reference.nets.vnet\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('vangan_torch', 'vangan_tpu', 'jax', 'jaxlib', 'flax')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
