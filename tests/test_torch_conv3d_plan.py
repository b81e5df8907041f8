"""``conv_plan``: the body and tiles the conv kernels take at every kernel conv
shape of the full-width ``gen_IS`` and ``disc_I`` at 128^3 and batch 3 (the
shapes ``chip_smoke.py`` phase 2 checks on the card), for the forward (K1),
the input gradient (K2, one launch for every stride parity;
``tests/test_torch_dgrad_plan.py`` checks the rest of its plan) and the
weight gradient (K3); and the wrapper's side of the plan (the weight layout
of the tensor-core forward, the workspace of the tensor-core K3).

The plan is pure Python, so these run on the CPU; the kernels' own results
are checked on the card (``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).
"""

import math

import numpy as np
import pytest
import torch

from vangan_torch.config import VanGanConfig
from vangan_torch.models.factory import build_discriminator, build_generator
from vangan_torch.models.layers import KERNEL_MAX_CHANNELS, ConvND
from vangan_torch.ops import conv3d as C

BATCH = 3
N = 128
BF16 = torch.bfloat16

# name: (Ci, Co, k, stride, padding, pad_mode, input edge) of every conv of
# one gen_IS (f=16, 4 levels) and one disc_I call with max(Ci, Co) < 128
PATH_CONVS = {
    "stem.conv1": (1, 16, 3, 1, ((1, 1),) * 3, "reflect", 128),
    "stem.conv_block.conv": (16, 16, 3, 1, ((1, 1),) * 3, "reflect", 128),
    "stem.shortcut": (1, 16, 1, 1, "same", "zeros", 128),
    "enc1.block1.conv": (16, 32, 3, 2, ((1, 1),) * 3, "reflect", 128),
    "enc1.block2.conv": (32, 32, 3, 1, ((1, 1),) * 3, "reflect", 64),
    "enc1.shortcut": (16, 32, 1, 2, "same", "zeros", 128),
    "enc2.block1.conv": (32, 64, 3, 2, ((1, 1),) * 3, "reflect", 64),
    "enc2.block2.conv": (64, 64, 3, 1, ((1, 1),) * 3, "reflect", 32),
    "enc2.shortcut": (32, 64, 1, 2, "same", "zeros", 64),
    "dec2.block2.conv": (64, 64, 3, 1, ((1, 1),) * 3, "reflect", 32),
    "dec1.block1.conv": (96, 32, 3, 1, ((1, 1),) * 3, "reflect", 64),
    "dec1.block2.conv": (32, 32, 3, 1, ((1, 1),) * 3, "reflect", 64),
    "dec1.shortcut": (96, 32, 1, 1, "same", "zeros", 64),
    "dec0.block1.conv": (48, 16, 3, 1, ((1, 1),) * 3, "reflect", 128),
    "dec0.block2.conv": (16, 16, 3, 1, ((1, 1),) * 3, "reflect", 128),
    "dec0.shortcut": (48, 16, 1, 1, "same", "zeros", 128),
    "head": (16, 1, 1, 1, "same", "zeros", 128),
    "disc.conv0": (1, 64, 4, 2, ((1, 1),) * 3, "reflect", 128),
}
# the four convs that do 565 of the 756 GFLOP of a gen_IS + disc_I call
HEAVY = ("dec0.block1.conv", "dec1.block1.conv", "stem.conv_block.conv", "dec0.block2.conv")
PAD_SHARE_CAP = 0.2  # the dgrad of a 3^3 conv writes the padded size (130^3, 66^3): ragged bricks
THIN_CI = ("stem.conv1", "stem.shortcut", "disc.conv0")  # Ci = 1: the forward's CUDA-core body


def _geometry(name):
    ci, co, k, s, padding, pad_mode, n = PATH_CONVS[name]
    k, s, dims = (k,) * 3, (s,) * 3, (n,) * 3
    pads = C.norm_padding(padding, k, s, dims)
    out = tuple((d + lo + hi - kk) // ss + 1 for d, (lo, hi), kk, ss in zip(dims, pads, k, s))
    return ci, co, k, s, pads, out


def _plans(name, dtype):
    """The plans of the forward, the dgrad and the wgrad of a conv."""
    ci, co, k, s, pads, out = _geometry(name)
    n, pad_mode = PATH_CONVS[name][6], PATH_CONVS[name][5]
    return {"fwd": C.conv_plan("fwd", ci, co, k, s, out, dtype, BATCH),
            "dgrad": C.conv_plan("dgrad", ci, co, k, s, out, dtype, BATCH, in_dims=(n,) * 3,
                                 pads=pads, pad_mode=pad_mode),
            "wgrad": C.conv_plan("wgrad", ci, co, k, s, out, dtype, BATCH)}


@pytest.mark.parametrize("name,launches", [("enc1.block1.conv", 8), ("enc1.shortcut", 1),
                                           ("disc.conv0", 8), ("dec0.block1.conv", 1)])
def test_dgrad_parities(name, launches):
    """The stride parities with taps that K2's one launch computes: the 3^3
    and 4^3 stride-2 convs 8, a 1^3 stride-2 shortcut only the even one (its
    odd positions get zeros)."""
    _, _, k, s, pads, _ = _geometry(name)
    xp = C.padded_dims((PATH_CONVS[name][6],) * 3, pads)
    parities = [t for t in C.dgrad_launch_order(k, s, xp) if math.prod(t[1])]
    assert len(parities) == launches
    for p, e, n in parities:
        assert all(ee == len(range(pp, kk, ss)) and nn == len(range(pp, x, ss))
                   for pp, ee, nn, kk, ss, x in zip(p, e, n, k, s, xp))


def _kernel_takes(plan):
    """What the C entry points accept for a plan (they return 1000 otherwise)."""
    if plan.route in ("f32", "thin"):
        return True
    limit = {"fwd": C.FWD_MAX_CO_TILE, "dgrad": C.DGRAD_MAX_CI_TILE,
             "wgrad": C.WGRAD_MAX_CO_TILE}[plan.op]
    static = C.DGRAD_STATIC_SMEM if plan.op == "dgrad" else 0
    ok = (plan.co_tile % 8 == 0 and 8 <= plan.co_tile <= limit
          and 0 < plan.smem_bytes and plan.smem_bytes + static <= C.MAX_SMEM)
    if plan.op == "wgrad":
        ok = ok and plan.tap_warps in (1, 2, 4, 8) and 1 <= plan.split <= 65535
    return ok


def test_path_convs_are_the_models_kernel_convs():
    """The table above is what the two networks run through the kernels."""
    seen = []
    for prefix, model in (
            ("", build_generator("resUnet", VanGanConfig(), generator=torch.Generator())),
            ("disc.", build_discriminator(VanGanConfig(), generator=torch.Generator()))):
        model.set_use_kernels(False)
        hooks = [m.register_forward_pre_hook(
            lambda mod, inp, name=prefix + name: seen.append((name, mod, inp[0].shape)))
            for name, m in model.named_modules() if isinstance(m, ConvND)]
        with torch.inference_mode():
            model(torch.zeros(1, 16, 16, 16, 1))
        for h in hooks:
            h.remove()
    got = {}
    for name, m, shape in seen:
        co, ci = m.weight.shape[:2]
        if max(ci, co) < KERNEL_MAX_CHANNELS:
            got[name] = (ci, co, m.kernel_size[0], m.strides[0], m.padding, m.pad_mode,
                        shape[2] * N // 16)
    assert got == PATH_CONVS


@pytest.mark.parametrize("name", sorted(PATH_CONVS))
def test_bf16_path_shapes_take_a_route_the_kernel_takes(name):
    for part, plan in _plans(name, BF16).items():
        assert plan.route in ("mma", "thin"), (part, plan)
        assert _kernel_takes(plan), (part, plan)
        # K3 always runs on the tensor cores (deterministic), the forward
        # only leaves them for Ci <= 3 (and K2 for Co <= 3: the head)
        if part == "wgrad":
            assert plan.route == "mma"
        elif part == "fwd":
            assert (plan.route == "thin") == (name in THIN_CI)


@pytest.mark.parametrize("name", sorted(PATH_CONVS))
def test_f32_always_takes_the_f32_route(name):
    for part, plan in _plans(name, torch.float32).items():
        assert plan.route == "f32", (part, plan)
        assert plan.workspace_bytes == 0


@pytest.mark.parametrize("name", sorted(PATH_CONVS))
def test_wgrad_split_and_workspace(name):
    plan = _plans(name, BF16)["wgrad"]
    ci, co, k = PATH_CONVS[name][:3]
    assert plan.split >= 1
    assert plan.workspace_bytes <= C.WORKSPACE_CAP
    assert plan.workspace_bytes == plan.workspace_slices * co * ci * k ** 3 * 4
    # enough blocks to fill the card, each with at least one brick to sum
    tiles = plan.tap_groups * -(-ci // C.CI_CHUNK) * plan.co_tiles
    _, _, _, _, _, out = _geometry(name)
    bricks = BATCH * math.prod(-(-n // b) for n, b in zip(out, C.BRICK))
    assert plan.split <= bricks
    assert plan.split * tiles >= min(C.SMS, bricks * tiles)


@pytest.mark.parametrize("name", HEAVY)
def test_heavy_convs_pad_little(name):
    for part, plan in _plans(name, BF16).items():
        assert plan.route == "mma"
        assert plan.pad_share < PAD_SHARE_CAP, (part, plan)


def test_wgrad_tap_warps_follow_the_taps():
    """A 27-tap conv spreads its taps over all eight warps; a 1^3 conv puts
    them on one and splits the voxels over the eight."""
    wide = C.conv_plan("wgrad", 48, 16, (3, 3, 3), (1, 1, 1), (128,) * 3, BF16, BATCH)
    thin = C.conv_plan("wgrad", 48, 16, (1, 1, 1), (1, 1, 1), (128,) * 3, BF16, BATCH)
    assert (wide.tap_warps, wide.tap_groups, wide.workspace_slices) == (8, 1, wide.split)
    assert (thin.tap_warps, thin.tap_groups, thin.workspace_slices) == (1, 1, 8 * thin.split)
    four = C.conv_plan("wgrad", 18, 40, (4, 4, 4), (2, 2, 2), (9, 8, 10), BF16, 2)
    assert (four.tap_warps, four.tap_groups, four.co_tile, four.co_tiles) == (8, 2, 24, 2)


def test_plan_refuses_what_it_cannot_plan():
    assert C.conv_plan("fwd", 16, 16, (5, 5, 5), (1, 1, 1), (8,) * 3, BF16).route == "thin"
    with pytest.raises(ValueError):
        C.conv_plan("dgrad", 16, 16, (3, 3, 3), (1, 1, 1), (8,) * 3, BF16)
    with pytest.raises(TypeError):
        C.conv_plan("fwd", 16, 16, (3, 3, 3), (1, 1, 1), (8,) * 3, torch.float16)


def test_wrapper_workspace_shape_matches_plan():
    for name in PATH_CONVS:
        plan = _plans(name, BF16)["wgrad"]
        ci, co, k = PATH_CONVS[name][:3]
        shape = C.wgrad_workspace_shape(plan, (co, ci, k, k, k))
        assert shape == (plan.workspace_slices, co, ci * k ** 3)
        assert math.prod(shape) * 4 == plan.workspace_bytes


@pytest.mark.parametrize("co,ci,k,co_tile", [(20, 19, (3, 1, 2), 24), (1, 16, (1, 1, 1), 8),
                                             (96, 32, (2, 2, 2), 48)])
def test_mma_weights_layout(rng, co, ci, k, co_tile):
    """[Ci chunk][Co tile][tap][co][16] bf16, zero-padded: what the tensor-core
    forward stages per chunk with 16-byte copies."""
    w = torch.from_numpy(rng.normal(size=(co, ci, *k)).astype(np.float32))
    wt = C.mma_weights(w, co_tile)
    chunks, tiles, taps = -(-ci // 16), -(-co // co_tile), math.prod(k)
    assert wt.shape == (chunks, tiles, taps, co_tile, 16) and wt.dtype == BF16
    assert wt.is_contiguous()
    flat = w.to(BF16).reshape(co, ci, taps)
    want = torch.zeros(chunks * 16, tiles * co_tile, taps, dtype=BF16)
    want[:ci, :co] = flat.permute(1, 0, 2)
    got = wt.permute(0, 4, 1, 3, 2).reshape(chunks * 16, tiles * co_tile, taps)
    assert torch.equal(got, want)
