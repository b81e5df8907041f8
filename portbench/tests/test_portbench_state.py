"""A network that carries state beside its parameters: the program's s2i
V-Net, whose 18 BatchNorms hold a running ``mean`` and ``var``, loaded from a
reference spec of this file that declares them (the kind ``vnet``, put in
place of a reference file for the test), and the seeded weights of the
benchmark's configurations, bitwise as they were before specs held state."""

import hashlib
import json
import math
import os
import sys
import types

import pytest
import torch
import torch.nn.functional as F

from conftest import REPO

from portbench import check, data, weights
from portbench.generators import train as train_mix
from portbench.reference import step as ref_step
from portbench.reference.layers import (Spec, batch_norm, conv, conv_transpose, from_volume,
                                        rounded, to_volume, uniform)
from portbench.run_support import Run, build_gan

SEED = 3000000013
PATCH = (16, 16, 16)
# config 2 with the s2i V-Net in gen_SI, cut to 2 filters in float32
TINY = {"gen_filters": 2, "disc_filters": 2, "compute_dtype": "float32", "gen_s2i": "vnet"}
LAYERS = 4


def vnet_spec(fields: dict, role: str) -> Spec:
    """The s2i V-Net's parameters and state, as the program names them."""
    f, ci = fields["gen_filters"], 1
    s = Spec()

    def block(p, ci, co):
        for i, c in enumerate((ci, co)):
            s.conv(f"{p}.conv{i}", c, co, 3, False)
            s.batch_norm(f"{p}.bn{i}", co)

    for layer in range(LAYERS):
        block(f"down{layer}", ci, f)
        ci, f = f, 2 * f
    block("bottleneck", ci, f)
    for i in range(LAYERS):
        s.conv_transpose(f"deconv{i}", f, f // 2, 2)
        f //= 2
        block(f"up{i}", 2 * f, f)
    s.conv("head", f, 1, 1, True)
    return s


def vnet_forward(P, x, ctx, seg, train=False, noise_std=0.0):
    """conv, ReLU, BatchNorm (training statistics), twice a block; max-pool
    down, deconv up, concat [up, skip]; a 1^3 tanh head (no dropout: the
    plumbing of the readings is under test here, not the network)."""
    def block(p, h):
        for i in range(2):
            h = torch.relu(conv(ctx, h, P[f"{p}.conv{i}.weight"], None, 1, uniform(1), "reflect"))
            h = batch_norm(ctx, h, P[f"{p}.bn{i}.weight"], P[f"{p}.bn{i}.bias"])
        return h

    h, skips = rounded(ctx, to_volume(x)), []
    for layer in range(LAYERS):
        h = block(f"down{layer}", h)
        skips.append(h)
        h = F.max_pool3d(h, 2)
    h = block("bottleneck", h)
    for i, skip in enumerate(reversed(skips)):
        h = conv_transpose(ctx, h, P[f"deconv{i}.weight"], P[f"deconv{i}.bias"], 2)
        h = block(f"up{i}", torch.cat([h, skip], dim=1))
    return from_volume(conv(ctx, h, P["head.weight"], P["head.bias"], 1, uniform(0))).tanh()


def _edit(spec_fn, edit):
    """``spec_fn`` with one entry of its spec dropped or misnamed."""
    def spec(fields, role):
        s = spec_fn(fields, role)
        table, key = {"state": (s.state, "down1.bn0.var"),
                      "parameter": (s.leaves, "up2.conv1.weight")}[edit[1]]
        value = table.pop(key)
        if edit[0] == "misname":
            table[key.replace("down1", "down9").replace("up2", "up9")] = value
        return s
    return spec


@pytest.fixture
def vnet(monkeypatch):
    """Installs the test's spec as the reference kind ``vnet``; returns the
    module, whose ``spec`` a test may replace."""
    mod = types.ModuleType("portbench.reference.nets.vnet")
    mod.spec, mod.forward = vnet_spec, vnet_forward
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    return mod


def _run():
    with open(os.path.join(REPO, "portbench", "configs", "vangan_resunet.json")) as f:
        fields = {**json.load(f)["fields"], **TINY}
    tr = {"batch": 2, "patch": list(PATCH), "noise_std": 0.1}
    return Run(REPO, "t", fields, tr, SEED, 0.0, False, torch.device("cpu"), 0.0)


def test_a_spec_with_state_loads_strictly(vnet):
    gan, fields, init = build_gan(_run(), BATCH_SIZE=2, SUBVOL_PATCH_SIZE=PATCH)
    net = gan.nets["gen_SI"]
    params = dict(net.named_parameters())
    buffers = {k: v for k, v in net.state_dict().items() if k not in params}
    state = ref_step.state_specs(fields)["gen_SI"]
    assert (len(params), len(buffers)) == (64, 36)
    assert set(buffers) == set(state)
    assert set(init["gen_SI"]) == set(params) == set(ref_step.specs(fields)["gen_SI"])
    for k, p in params.items():
        assert torch.equal(p.detach(), init["gen_SI"][k])
    for k, b in buffers.items():
        assert torch.equal(b, torch.full_like(b, 1.0 if k.endswith(".var") else 0.0))
    # the networks that hold no state declare none
    assert not any(ref_step.state_specs(fields)[n] for n in ("gen_IS", "disc_I", "disc_S"))


@pytest.mark.parametrize("edit", [("drop", "state"), ("misname", "state"),
                                  ("drop", "parameter"), ("misname", "parameter")])
def test_a_missing_or_misnamed_entry_raises(vnet, edit):
    vnet.spec = _edit(vnet_spec, edit)
    with pytest.raises(RuntimeError, match="Missing key|Unexpected key"):
        build_gan(_run(), BATCH_SIZE=2, SUBVOL_PATCH_SIZE=PATCH)


def test_the_readings_hold_parameters_only_and_compare_finitely(vnet):
    """One program step through the window's call and feed, read as the train
    mix reads it, and one reference step from the same seed: the same
    parameter keys on both sides, no state key, and every number finite."""
    from vangan_torch import vangan as vg

    h = _run()
    gan, fields, init = build_gan(h, BATCH_SIZE=2, SUBVOL_PATCH_SIZE=PATCH)
    pool = data.train_pool(4, PATCH, SEED, "cpu")
    res = vg.train(data.Feed(pool, 2, SEED), gan, train_mix._NoSummary(), 0, steps=1,
                   training=True, noise_std=0.1)
    prog = ref_step.Readings([{k: v[0] for k, v in res.items()}], train_mix.first_gradients(gan),
                             train_mix.changes(gan, init))
    moved = gan.nets["gen_SI"].state_dict()["down0.bn0.mean"]
    assert moved.abs().sum() > 0  # the program moved its state
    ref = train_mix.reference_readings(h, fields, pool, 2, 1)
    keys = {f"{n}/{k}" for n, s in ref_step.specs(fields).items() for k in s}
    state = {f"{n}/{k}" for n, s in ref_step.state_specs(fields).items() for k in s}
    assert len(state) == 36 and not keys & state
    for readings in (prog, ref):
        assert set(readings.grad1) == set(readings.change) == keys
    numbers = check.train_numbers(prog, ref)
    assert all(math.isfinite(v) for v in numbers.values()), numbers


# sha256 of every leaf (name, shape, float32 bytes; networks and names
# sorted) that ``weights.make`` drew on the CPU before specs held state
DIGESTS = {
    ("vangan_resunet", 3000000007):
        "d9c01e3b2e82cf96fa40f99131510a43b9a709b3df5855e4f0244e6b7179faa4",
    ("vangan_resunet", 2147495993):
        "dfeb296fedce206dec0e4d0e60c7f0cc0ed5ed83124a9838b1e2e3c5d88fedc5",
    ("vangan_resnet", 3000000007):
        "2602566b850c4e837b29cfb77b1c2c64d617f34fef88a37da0c879cb57afa61d",
    ("vangan_resnet", 2147495993):
        "9971c90bff2f07cdb1fc52c95743d01fab15081a6c996904f1b53c4dffeff29b",
}


@pytest.mark.parametrize("config, seed", sorted(DIGESTS))
def test_the_configurations_weights_are_bitwise_as_before(config, seed):
    with open(os.path.join(REPO, "portbench", "configs", config + ".json")) as f:
        fields = json.load(f)["fields"]
    w = weights.make(ref_step.specs(fields), seed, torch.device("cpu"))
    h = hashlib.sha256()
    for n in sorted(w):
        for k in sorted(w[n]):
            h.update(f"{n}/{k}{tuple(w[n][k].shape)}".encode())
            h.update(w[n][k].contiguous().numpy().tobytes())
    assert h.hexdigest() == DIGESTS[(config, seed)]
    assert not any(ref_step.state_specs(fields).values())
