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

import hashlib
import json
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
        return plan.op != "wgrad" or 1 <= plan.split <= 65535
    if plan.tap_chunks:  # route 2: one n tile of FOLD_N columns
        ok = plan.co_tile == C.FOLD_N and 0 < plan.smem_bytes <= C.MAX_SMEM
        return ok and (plan.op != "wgrad" or 1 <= plan.split <= 65535)
    if plan.k_pairs:  # route 3: one input channel (K2: the forward of g of one channel)
        ok = (plan.co_tile % 8 == 0 and 8 <= plan.co_tile <= C.PAIR_MAX_CO_TILE
              and 0 < plan.smem_bytes <= C.MAX_SMEM)
        return ok and (plan.op != "wgrad" or 1 <= plan.split <= 65535)
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
    """... and only its weight gradient has a workspace: one slice of
    partial tiles per block along the voxels."""
    ci, co, k = PATH_CONVS[name][:3]
    for part, plan in _plans(name, torch.float32).items():
        assert plan.route == "f32", (part, plan)
        assert _kernel_takes(plan), (part, plan)
        want = plan.split * co * ci * k ** 3 * 4 if part == "wgrad" else 0
        assert plan.workspace_bytes == want and plan.workspace_bytes <= C.WORKSPACE_CAP


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


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_wrapper_workspace_shape_matches_plan(dtype):
    for name in PATH_CONVS:
        plan = _plans(name, dtype)["wgrad"]
        ci, co, k = PATH_CONVS[name][:3]
        shape = C.wgrad_workspace_shape(plan, (co, ci, k, k, k))
        assert shape == (plan.workspace_slices, co, ci * k ** 3)
        assert math.prod(shape) * 4 == plan.workspace_bytes


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("ci,co,k,dims,batch", [(1, 32, 7, 128, 1), (32, 1, 7, 128, 1),
                                                (64, 32, 4, 64, 3), (3, 5, 2, 3, 1)])
def test_cuda_core_wgrad_split(dtype, ci, co, k, dims, batch):
    """The CUDA-core weight gradient (float32; bfloat16 above 64 taps where
    neither tensor-core body above 64 taps takes the shape) fills the card
    with blocks along the voxels, no more blocks than voxel chunks, each with
    a slice of the workspace: the ResNet generator's 343-tap convs, a 64-tap
    one in f32 and a tiny one. In bfloat16 the ResNet's head (32 -> 1) takes
    the tap chunks and its stem (1 -> 32) route 3, whose blocks split the
    bricks the same way (route 3's for each Co tile), one slice each."""
    plan = C.conv_plan("wgrad", ci, co, (k,) * 3, (1, 1, 1), (dims,) * 3, dtype, batch)
    if dtype == BF16 and k ** 3 <= C.MMA_MAX_TAPS:
        assert plan.route == "mma"
        return
    ncols = ci * k ** 3
    if dtype == BF16 and ci >= C.CI_CHUNK and co * k <= C.FOLD_N:
        assert plan.route == "mma" and plan.tap_chunks == k and _kernel_takes(plan)
        chunks = -(-ci // C.CI_CHUNK)
        bricks = batch * math.prod(-(-dims // b) for b in plan.brick)
        assert plan.split <= bricks
        assert plan.split * chunks >= min(C.WGRAD_TARGET_BLOCKS, bricks * chunks)
        assert plan.workspace_slices == plan.split
        assert plan.workspace_bytes == plan.split * co * ncols * 4 <= C.WORKSPACE_CAP
        return
    if dtype == BF16 and ci == 1:
        assert plan.route == "mma" and plan.body == 3 and _kernel_takes(plan)
        bricks = batch * math.prod(-(-dims // b) for b in plan.brick)
        assert plan.split <= bricks
        assert plan.split * plan.co_tiles >= min(C.WGRAD_TARGET_BLOCKS, bricks * plan.co_tiles)
        assert plan.workspace_slices == plan.split
        assert plan.workspace_bytes == plan.split * co * ncols * 4 <= C.WORKSPACE_CAP
        return
    assert plan.route in ("f32", "thin") and _kernel_takes(plan)
    mt, nt = min(C.WGRAD_CORE_TILES,  # the least padded tile, first on a tie, as the source
                 key=lambda t: -(-co // t[0]) * t[0] * -(-ncols // t[1]) * t[1])
    tiles = -(-co // mt) * -(-ncols // nt)
    chunks = -(-batch * dims ** 3 // C.WGRAD_CORE_CHUNK)
    assert plan.split <= chunks
    assert plan.split * tiles >= min(C.WGRAD_CORE_TARGET_BLOCKS, chunks * tiles)
    assert plan.workspace_slices == plan.split
    assert plan.workspace_bytes == plan.split * co * ncols * 4 <= C.WORKSPACE_CAP


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


# The ResNet generator's 343-tap convs at 3 x 128^3: (Ci, Co) of the stem and
# the head, 7^3 reflect-padded by 3
RESNET_343 = {"stem_conv": (1, 32), "head": (32, 1)}
DIMS = (N,) * 3
PADS3 = ((3, 3),) * 3


def _resnet_plans(name, dtype):
    ci, co = RESNET_343[name]
    k, s = (7, 7, 7), (1, 1, 1)
    return {"fwd": C.conv_plan("fwd", ci, co, k, s, DIMS, dtype, BATCH),
            "dgrad": C.conv_plan("dgrad", ci, co, k, s, DIMS, dtype, BATCH, in_dims=DIMS,
                                 pads=PADS3, pad_mode="reflect"),
            "wgrad": C.conv_plan("wgrad", ci, co, k, s, DIMS, dtype, BATCH)}


def test_resnet_head_takes_the_tap_chunks():
    """The head (32 -> 1): K1 and K3 on the tensor cores in 7 tap chunks of
    (7, 1, 7) taps (each within MMA_MAX_TAPS), the kz taps on N, columns of
    16 z positions giving 10 outputs each; at most half the issued MMA work
    padding (measured 0.46: 7 of 8 N columns, 10 of 16 rows, 128 of 130 z),
    shared memory for two blocks an SM, the workspace within its cap."""
    plans = _resnet_plans("head", BF16)
    for op in ("fwd", "wgrad"):
        p = plans[op]
        assert (p.route, p.body, p.tap_chunk, p.tap_chunks) == ("mma", 2, (7, 1, 7), 7), p
        assert math.prod(p.tap_chunk) <= C.MMA_MAX_TAPS < 343
        assert p.brick == (4, 8, 10) and (p.co_tile, p.co_tiles) == (C.FOLD_N, 1)
        assert p.pad_share <= 0.5, p
        assert 2 * p.smem_bytes <= C.MAX_SMEM and _kernel_takes(p)
    assert plans["fwd"].smem_bytes == 10 * 14 * 16 * 32 + 2 * 49 * 8 * 32
    w = plans["wgrad"]
    assert w.workspace_slices == w.split and w.workspace_bytes <= C.WORKSPACE_CAP
    assert w.workspace_bytes == w.split * 32 * 343 * 4
    assert w.split * 2 >= C.WGRAD_TARGET_BLOCKS  # two 16-channel chunks


def test_resnet_stem_forward_takes_route_3():
    """The stem's K1 (1 -> 32): the tensor cores with the (dx, dy) pairs on K
    (49 padded to 64: four k-steps), Co = 32 in one tile of four n tiles,
    bricks of 4 x 8 columns of 16 z outputs (128 = 8 of them: no ragged
    column); its issued work the 64 / 49 pairs' padding, 0.234; shared
    memory (the staged f32 outputs, 32 x (512 + 4) floats, above the 7
    halo copies and the weights) for two blocks an SM."""
    p = _resnet_plans("stem_conv", BF16)["fwd"]
    assert (p.route, p.body, p.k_pairs, p.tap_chunks) == ("mma", 3, 64, 0), p
    assert p.brick == (4, 8, 16) and (p.co_tile, p.co_tiles) == (32, 1)
    assert p.pad_share == pytest.approx(1 - 49 / 64)
    assert p.smem_bytes == max(7 * 10 * 14 * 32 + 7 * 64 * 32 * 2, 32 * (512 + 4) * 4)
    assert 2 * p.smem_bytes <= C.MAX_SMEM and _kernel_takes(p)


def test_resnet_input_gradients_take_the_forward_bodies():
    """K2 at 343 taps runs a forward body over the padded positions (134^3):
    the head's (dx 32 <- g 1) route 3, a Ci tile of 32; the stem's (dx 1 <-
    g 32) the tap chunks, route 2 (Ci * kz = 7 <= 8). The plan's contract is
    the CUDA-core plan's: one launch and one fold launch, the same parity
    order, fold positions and fold buffer."""
    stem, head = _resnet_plans("stem_conv", BF16), _resnet_plans("head", BF16)
    h, s = head["dgrad"], stem["dgrad"]
    assert (h.route, h.body, h.k_pairs, h.co_tile, h.co_tiles) == ("mma", 3, 64, 32, 1), h
    assert h.brick == (4, 8, 16)
    assert (s.route, s.body, s.tap_chunk, s.tap_chunks, s.co_tile) == \
        ("mma", 2, (7, 1, 7), 7, C.FOLD_N), s
    assert s.brick == (4, 8, 10)
    for name, p in (("head", h), ("stem_conv", s)):
        ci, co = RESNET_343[name]
        thin = C.conv_plan("dgrad", ci, co, (7, 7, 7), (1, 1, 1), DIMS, BF16, BATCH,
                           in_dims=DIMS, pads=PADS3, pad_mode="reflect", thin_max_ci=0)
        f32 = C.conv_plan("dgrad", ci, co, (7, 7, 7), (1, 1, 1), DIMS, torch.float32, BATCH,
                          in_dims=DIMS, pads=PADS3, pad_mode="reflect")
        fold = (0, 1, 2, 4, 5, 6, 127, 128, 129, 131, 132, 133)
        want = ((((0, 0, 0), (7, 7, 7), (134,) * 3),), (fold,) * 3,
                BATCH * ci * 3 * 12 * 134 ** 2 * 4, 2)
        for q in (p, thin, f32):
            assert (q.parities, q.fold, q.fold_bytes, q.launches) == want, q
        assert 0 < p.pad_share < 0.5 and 2 * p.smem_bytes <= C.MAX_SMEM and _kernel_takes(p)


def test_resnet_stem_wgrad_takes_route_3():
    """The stem's K3 (1 -> 32): route 3's GEMM transposed, the (dx, dy)
    pairs on M (49 padded to 64: four m tiles), Co = 32 on N in one tile,
    a column's 16 z positions on K, on the forward's bricks (4 x 8 columns
    of 16 z outputs, 128 = 8 of them); the same issued work, pad share
    0.234; shared memory the 7 halo copies and g's 32 columns of the Co
    tile, for two blocks an SM; the (sample, brick) pairs split over
    WGRAD_TARGET_BLOCKS blocks, one workspace slice each. float32 keeps the
    CUDA-core route."""
    p = _resnet_plans("stem_conv", BF16)["wgrad"]
    assert p == C.conv_plan("wgrad", 1, 32, (7, 7, 7), (1, 1, 1), (128, 128, 128), BF16, 3)
    assert (p.route, p.body, p.k_pairs, p.tap_chunks) == ("mma", 3, 64, 0), p
    assert p.brick == (4, 8, 16) and (p.co_tile, p.co_tiles) == (32, 1)
    assert p.pad_share == pytest.approx(1 - 49 / 64)
    assert p.smem_bytes == 7 * 10 * 14 * 32 + 32 * 32 * 32
    bricks = BATCH * 32 * 16 * 8
    assert p.split == min(C.WGRAD_TARGET_BLOCKS, bricks) and p.workspace_slices == p.split
    assert p.workspace_bytes == p.split * 32 * 343 * 4 <= C.WORKSPACE_CAP
    assert 2 * p.smem_bytes <= C.MAX_SMEM and _kernel_takes(p)
    f32 = _resnet_plans("stem_conv", torch.float32)["wgrad"]
    assert (f32.route, f32.body, f32.k_pairs) == ("f32", 0, 0), f32


@pytest.mark.parametrize("co,k,dims,batch", [
    (32, (7, 7, 7), (20, 18, 22), 2),   # the stem at a ragged size: few bricks
    (40, (5, 5, 5), (9, 10, 11), 1),    # two Co tiles of 24
    (8, (8, 8, 8), (128, 128, 128), 3),  # one n tile, 64 pairs
    (20, (6, 5, 4), (33, 17, 40), 1),   # 30 pairs: two m tiles
])
def test_pair_wgrad_plan_workspace(co, k, dims, batch):
    """Route 3's K3: one workspace slice per block along the voxels, the
    wrapper's workspace (split, Co, taps), its bytes, and the split capped
    by the bricks and the card's target (over the Co tiles)."""
    p = C.conv_plan("wgrad", 1, co, k, (1, 1, 1), dims, BF16, batch)
    assert p.body == 3 and _kernel_takes(p), p
    taps = math.prod(k)
    assert p.workspace_slices == p.split
    assert C.wgrad_workspace_shape(p, (co, 1, *k)) == (p.split, co, taps)
    assert p.workspace_bytes == p.split * co * taps * 4
    bricks = batch * math.prod(-(-n // b) for n, b in zip(dims, p.brick))
    assert p.split == min(-(-C.WGRAD_TARGET_BLOCKS // p.co_tiles), bricks)
    assert p.k_pairs == -(-k[0] * k[1] // 16) * 16


@pytest.mark.parametrize("op,ci,co,k,stride", [
    ("fwd", 1, 32, (7, 7, 7), (2, 2, 2)),    # route 3: strided
    ("fwd", 1, 32, (7, 7, 7), (1, 2, 1)),    # route 3: strided on one axis
    ("fwd", 2, 32, (7, 7, 7), (1, 1, 1)),    # two input channels, Co * kz = 224
    ("fwd", 3, 16, (5, 5, 5), (1, 1, 1)),    # three input channels
    ("dgrad", 2, 2, (7, 7, 7), (1, 1, 1)),   # g of two channels, dx Ci * kz = 14
    ("dgrad", 32, 1, (7, 7, 7), (1, 1, 2)),  # strided: a parity of 7 x 7 x 4 taps
    ("dgrad", 1, 32, (7, 7, 7), (2, 1, 1)),  # strided: a parity of 4 x 7 x 7 taps
    ("wgrad", 1, 32, (7, 7, 7), (2, 2, 2)),  # route 3's K3: strided
    ("wgrad", 1, 32, (7, 7, 7), (1, 1, 2)),  # strided on one axis
    ("wgrad", 2, 32, (7, 7, 7), (1, 1, 1)),  # two input channels, Co * kz = 224
])
def test_pair_routes_refuse_what_they_do_not_take(op, ci, co, k, stride):
    """Above 64 taps route 3 takes a unit-stride forward or weight gradient
    of one input channel, and K2 the forward bodies at unit stride only: the
    rest keeps the CUDA-core body."""
    dims = (20, 18, 22)
    pads = tuple((kk // 2, kk // 2) for kk in k)
    out = tuple((n + 2 * (kk // 2) - kk) // s + 1 for n, kk, s in zip(dims, k, stride))
    kw = dict(in_dims=dims, pads=pads, pad_mode="reflect") if op == "dgrad" else {}
    p = C.conv_plan(op, ci, co, k, stride, out, BF16, 2, **kw)
    assert (p.route, p.body, p.k_pairs, p.tap_chunks) == ("thin", 0, 0, 0), p
    assert _kernel_takes(p)


def test_pair_route_takes_other_shapes_above_64_taps():
    """Route 3 at 5^3 (25 pairs: two k-steps), 6 x 5 x 4 (30 pairs) and 8^3
    (64 pairs, four k-steps), Co of 8 to 40 (tiles of up to 32), K3 on the
    same tiles, bricks and issued work as K1, and K2 of g with one channel at
    the same kernels."""
    for co, k, tile, tiles in ((8, (5, 5, 5), 8, 1), (20, (6, 5, 4), 24, 1),
                               (40, (8, 8, 8), 24, 2), (64, (7, 7, 7), 32, 2)):
        dims = (20, 18, 22)
        p = C.conv_plan("fwd", 1, co, k, (1, 1, 1), dims, BF16, 2)
        assert (p.body, p.co_tile, p.co_tiles) == (3, tile, tiles), p
        assert p.k_pairs == -(-k[0] * k[1] // 16) * 16 and _kernel_takes(p)
        wg = C.conv_plan("wgrad", 1, co, k, (1, 1, 1), dims, BF16, 2)
        assert (wg.body, wg.co_tile, wg.co_tiles, wg.k_pairs, wg.brick, wg.pad_share) == \
            (3, tile, tiles, p.k_pairs, p.brick, p.pad_share), wg
        assert _kernel_takes(wg)
        pads = tuple((kk // 2, kk - 1 - kk // 2) for kk in k)
        d = C.conv_plan("dgrad", co, 1, k, (1, 1, 1), dims, BF16, 2, in_dims=dims, pads=pads,
                        pad_mode="zeros")
        assert (d.body, d.co_tile, d.co_tiles, d.launches) == (3, tile, tiles, 1), d


@pytest.mark.parametrize("name", sorted(RESNET_343))
def test_resnet_343_taps_in_float32_take_the_f32_route(name):
    for op, p in _resnet_plans(name, torch.float32).items():
        assert p.route == "f32" and p.tap_chunks == 0 and _kernel_takes(p), (op, p)


@pytest.mark.parametrize("op,ci,co,k,stride", [
    ("fwd", 32, 2, (7, 7, 7), (1, 1, 1)),    # Co * kz = 14 > 8
    ("fwd", 32, 1, (7, 7, 7), (2, 2, 2)),    # strided
    ("wgrad", 8, 1, (7, 7, 7), (1, 1, 1)),   # Ci < 16
    ("wgrad", 32, 1, (5, 5, 5), (1, 2, 1)),  # strided
])
def test_tap_chunks_refuse_what_they_do_not_take(op, ci, co, k, stride):
    out = tuple(-(-20 // s) for s in stride)
    assert C.conv_plan(op, ci, co, k, stride, out, BF16, 2).route == "thin"


def test_tap_chunks_take_other_shapes_above_64_taps():
    """5^3 and 8^3 kernels at Co = 1, and Co = 3 with kz = 2 (6 columns)."""
    for ci, co, k in ((48, 1, (5, 5, 5)), (16, 1, (8, 8, 8)), (16, 3, (7, 7, 2))):
        for op in ("fwd", "wgrad"):
            p = C.conv_plan(op, ci, co, k, (1, 1, 1), (20, 18, 22), BF16, 2)
            assert p.tap_chunks == k[1] and p.brick[2] == C.FOLD_ROWS - k[2] + 1, (op, k)
            assert _kernel_takes(p), p


# A frozen copy of the plans from before the tap chunks existed: every
# kernel conv of config 2 (gen_IS, disc_I) and config 4 (the two V-Nets) at
# batch 3, 128^3, chip_smoke.py phase 2's and phase 10's shapes: (Ci, Co,
# k, stride, padding, pad_mode, input edge), then a digest of each plan
# (bfloat16 fwd, dgrad, wgrad, then float32) over the fields they had. No
# plan of 64 taps or fewer changes.
P1 = ((1, 1),) * 3
FROZEN_FIELDS = ("op", "route", "brick", "ci_chunk", "co_tile", "co_tiles", "tap_warps",
                 "tap_groups", "split", "workspace_bytes", "smem_bytes", "pad_share",
                 "parities", "fold", "fold_bytes", "launches", "shared_halo")
FROZEN_PLANS = {
    "disc_I.conv0": ((1, 64, 4, 2, P1, "reflect", 128),
        ("a0ebca161a111da6", "95ad2e48caef8f14", "e9f40c66f945e691",
         "071e28bcfcb05637", "f92f50c17776317e", "760f9c0dbaa46867")),
    "gen_IS.dec0.block1.conv": ((48, 16, 3, 1, P1, "reflect", 128),
        ("d841274b0ef6763d", "c74ed93a2e4ecf65", "4bcbc780c033d1b9",
         "071e28bcfcb05637", "bd36f738aecd0d09", "ef93b1e8b555b4c3")),
    "gen_IS.dec0.block2.conv": ((16, 16, 3, 1, P1, "reflect", 128),
        ("d841274b0ef6763d", "f7c9b0d6fe40366d", "826297a2e4154120",
         "071e28bcfcb05637", "a3c558cddad38ffa", "0706d10b1a603417")),
    "gen_IS.dec0.shortcut": ((48, 16, 1, 1, "same", "zeros", 128),
        ("9afcfec61866c331", "47a9d9398b07b28b", "8c1c7a501c1fb167",
         "071e28bcfcb05637", "f1b7be769b17ab8d", "ab7ed9b37b3ccaa1")),
    "gen_IS.dec1.block1.conv": ((96, 32, 3, 1, P1, "reflect", 64),
        ("b1873ce61e03046e", "fe5571665b39967d", "03a495d1eb8edb0d",
         "071e28bcfcb05637", "5c229dbea2f32bdc", "a5fa1482d0eadebf")),
    "gen_IS.dec1.block2.conv": ((32, 32, 3, 1, P1, "reflect", 64),
        ("b1873ce61e03046e", "3d2180ecf8989eab", "558ec41789a7236a",
         "071e28bcfcb05637", "6f91ea53a7104b6b", "3d2d865aff5177ef")),
    "gen_IS.dec1.shortcut": ((96, 32, 1, 1, "same", "zeros", 64),
        ("352a27d603b4cffb", "b45df68cc7e83489", "81ca527be2fc1e17",
         "071e28bcfcb05637", "43078ef0f3cb0f91", "917e8cb098b46370")),
    "gen_IS.dec2.block2.conv": ((64, 64, 3, 1, P1, "reflect", 32),
        ("e6af62e8e6a82f40", "a6c3971350215dc9", "abf9d0ef38c46110",
         "071e28bcfcb05637", "0b15ed60eecf5cea", "ba039d5c1a69f779")),
    "gen_IS.enc1.block1.conv": ((16, 32, 3, 2, P1, "reflect", 128),
        ("1bb7325a3c287739", "e44dbf72b1a1d111", "da3ddbf2b9a4d6d4",
         "071e28bcfcb05637", "3f9b7447130cdef2", "7e31418d042df95f")),
    "gen_IS.enc1.block2.conv": ((32, 32, 3, 1, P1, "reflect", 64),
        ("b1873ce61e03046e", "3d2180ecf8989eab", "558ec41789a7236a",
         "071e28bcfcb05637", "6f91ea53a7104b6b", "3d2d865aff5177ef")),
    "gen_IS.enc1.shortcut": ((16, 32, 1, 2, "same", "zeros", 128),
        ("352a27d603b4cffb", "92ec12f489ca1ea4", "27156728f7ed6e70",
         "071e28bcfcb05637", "766422762739ef7c", "07ecedc1ce32db53")),
    "gen_IS.enc2.block1.conv": ((32, 64, 3, 2, P1, "reflect", 64),
        ("7d567f43819f973d", "6b88f6a5713ecae4", "22464c27c775a4e9",
         "071e28bcfcb05637", "d1dfefe498527cae", "450b79312f5e9ddd")),
    "gen_IS.enc2.block2.conv": ((64, 64, 3, 1, P1, "reflect", 32),
        ("e6af62e8e6a82f40", "a6c3971350215dc9", "abf9d0ef38c46110",
         "071e28bcfcb05637", "0b15ed60eecf5cea", "ba039d5c1a69f779")),
    "gen_IS.enc2.shortcut": ((32, 64, 1, 2, "same", "zeros", 64),
        ("3af33b3f1f23e378", "d863dc9108ff4c82", "8528dbcd7928f520",
         "071e28bcfcb05637", "824df946eeda2b9a", "1692c39c3d5bda98")),
    "gen_IS.head": ((16, 1, 1, 1, "same", "zeros", 128),
        ("0ecf997d5c4f862d", "31a559575ab46ffb", "c22d2ca67b2ae962",
         "071e28bcfcb05637", "f1b7be769b17ab8d", "a4accac5c8e5f57b")),
    "gen_IS.stem.conv1": ((1, 16, 3, 1, P1, "reflect", 128),
        ("a0ebca161a111da6", "edd80207c74d5e05", "09490e4770df04b9",
         "071e28bcfcb05637", "a8700f8b4a8c7bb0", "431f6183f191423c")),
    "gen_IS.stem.conv_block.conv": ((16, 16, 3, 1, P1, "reflect", 128),
        ("d841274b0ef6763d", "f7c9b0d6fe40366d", "826297a2e4154120",
         "071e28bcfcb05637", "a3c558cddad38ffa", "0706d10b1a603417")),
    "gen_IS.stem.shortcut": ((1, 16, 1, 1, "same", "zeros", 128),
        ("a0ebca161a111da6", "733984a6971b4f2e", "1a66a56a1adbef14",
         "071e28bcfcb05637", "f1b7be769b17ab8d", "a4accac5c8e5f57b")),
    "vnet_i2s.down0.conv0": ((1, 32, 3, 1, P1, "reflect", 128),
        ("a0ebca161a111da6", "edd80207c74d5e05", "c428da15c307c7ab",
         "071e28bcfcb05637", "a8700f8b4a8c7bb0", "126217bbda14a343")),
    "vnet_i2s.down0.conv1": ((32, 32, 3, 1, P1, "reflect", 128),
        ("b1873ce61e03046e", "4d4542afb1323ef5", "558ec41789a7236a",
         "071e28bcfcb05637", "9e091f2bb76f74c9", "3d2d865aff5177ef")),
    "vnet_i2s.down1.conv0": ((32, 64, 3, 1, P1, "reflect", 64),
        ("e6af62e8e6a82f40", "3d2180ecf8989eab", "02d62ac6d5136a81",
         "071e28bcfcb05637", "6f91ea53a7104b6b", "450b79312f5e9ddd")),
    "vnet_i2s.down1.conv1": ((64, 64, 3, 1, P1, "reflect", 64),
        ("e6af62e8e6a82f40", "14a153ea3d39c527", "abf9d0ef38c46110",
         "071e28bcfcb05637", "3b7d56e1e7967be7", "ba039d5c1a69f779")),
    "vnet_i2s.head": ((32, 1, 1, 1, "same", "zeros", 128),
        ("0ecf997d5c4f862d", "31a559575ab46ffb", "af13196c518439ad",
         "071e28bcfcb05637", "f1b7be769b17ab8d", "d2c563c913283bbd")),
    "vnet_i2s.up2.conv1": ((64, 64, 3, 1, P1, "reflect", 64),
        ("e6af62e8e6a82f40", "14a153ea3d39c527", "abf9d0ef38c46110",
         "071e28bcfcb05637", "3b7d56e1e7967be7", "ba039d5c1a69f779")),
    "vnet_i2s.up3.conv0": ((64, 32, 3, 1, P1, "reflect", 128),
        ("b1873ce61e03046e", "dbec5b52b1f767f0", "4eab63e22d44056d",
         "071e28bcfcb05637", "890100d3fc49e964", "450b79312f5e9ddd")),
    "vnet_i2s.up3.conv1": ((32, 32, 3, 1, P1, "reflect", 128),
        ("b1873ce61e03046e", "4d4542afb1323ef5", "558ec41789a7236a",
         "071e28bcfcb05637", "9e091f2bb76f74c9", "3d2d865aff5177ef")),
    "vnet_i2s.upconv3": ((64, 32, 3, 1, "same", "zeros", 128),
        ("b1873ce61e03046e", "06accbae590f06d3", "4eab63e22d44056d",
         "071e28bcfcb05637", "8bd4653b92a17e8b", "450b79312f5e9ddd")),
    "vnet_s2i.down0.conv0": ((1, 16, 3, 1, P1, "reflect", 128),
        ("a0ebca161a111da6", "edd80207c74d5e05", "09490e4770df04b9",
         "071e28bcfcb05637", "a8700f8b4a8c7bb0", "431f6183f191423c")),
    "vnet_s2i.down0.conv1": ((16, 16, 3, 1, P1, "reflect", 128),
        ("d841274b0ef6763d", "f7c9b0d6fe40366d", "826297a2e4154120",
         "071e28bcfcb05637", "a3c558cddad38ffa", "0706d10b1a603417")),
    "vnet_s2i.down1.conv0": ((16, 32, 3, 1, P1, "reflect", 64),
        ("b1873ce61e03046e", "789adb75fb04cb29", "cb53eddf321a83c5",
         "071e28bcfcb05637", "97246c4ecd66f34e", "7e31418d042df95f")),
    "vnet_s2i.down1.conv1": ((32, 32, 3, 1, P1, "reflect", 64),
        ("b1873ce61e03046e", "3d2180ecf8989eab", "558ec41789a7236a",
         "071e28bcfcb05637", "6f91ea53a7104b6b", "3d2d865aff5177ef")),
    "vnet_s2i.down2.conv0": ((32, 64, 3, 1, P1, "reflect", 32),
        ("e6af62e8e6a82f40", "77f8e497aef0fba7", "02d62ac6d5136a81",
         "071e28bcfcb05637", "2e09516569d4a6b0", "450b79312f5e9ddd")),
    "vnet_s2i.down2.conv1": ((64, 64, 3, 1, P1, "reflect", 32),
        ("e6af62e8e6a82f40", "a6c3971350215dc9", "abf9d0ef38c46110",
         "071e28bcfcb05637", "0b15ed60eecf5cea", "ba039d5c1a69f779")),
    "vnet_s2i.head": ((16, 1, 1, 1, "same", "zeros", 128),
        ("0ecf997d5c4f862d", "31a559575ab46ffb", "c22d2ca67b2ae962",
         "071e28bcfcb05637", "f1b7be769b17ab8d", "a4accac5c8e5f57b")),
    "vnet_s2i.up1.conv1": ((64, 64, 3, 1, P1, "reflect", 32),
        ("e6af62e8e6a82f40", "a6c3971350215dc9", "abf9d0ef38c46110",
         "071e28bcfcb05637", "0b15ed60eecf5cea", "ba039d5c1a69f779")),
    "vnet_s2i.up2.conv0": ((64, 32, 3, 1, P1, "reflect", 64),
        ("b1873ce61e03046e", "14a153ea3d39c527", "4eab63e22d44056d",
         "071e28bcfcb05637", "3b7d56e1e7967be7", "450b79312f5e9ddd")),
    "vnet_s2i.up2.conv1": ((32, 32, 3, 1, P1, "reflect", 64),
        ("b1873ce61e03046e", "3d2180ecf8989eab", "558ec41789a7236a",
         "071e28bcfcb05637", "6f91ea53a7104b6b", "3d2d865aff5177ef")),
    "vnet_s2i.up3.conv0": ((32, 16, 3, 1, P1, "reflect", 128),
        ("d841274b0ef6763d", "4d4542afb1323ef5", "fb3b4f70c325ee31",
         "071e28bcfcb05637", "9e091f2bb76f74c9", "7e31418d042df95f")),
    "vnet_s2i.up3.conv1": ((16, 16, 3, 1, P1, "reflect", 128),
        ("d841274b0ef6763d", "f7c9b0d6fe40366d", "826297a2e4154120",
         "071e28bcfcb05637", "a3c558cddad38ffa", "0706d10b1a603417")),
}


def _digest(plan):
    fields = {f: getattr(plan, f) for f in FROZEN_FIELDS}
    return hashlib.sha256(json.dumps(fields, sort_keys=True).encode()).hexdigest()[:16]


def test_frozen_plans_cover_configs_2_and_4():
    """Config 2's 17 + 1 kernel convs (the table above) and config 4's 9 +
    12 (the V-Nets)."""
    prefix = lambda n: "disc_I." + n[5:] if n.startswith("disc.") else "gen_IS." + n  # noqa: E731
    config2 = {prefix(n): v for n, v in PATH_CONVS.items()}
    for name, (ci, co, k, s, padding, pad_mode, n) in config2.items():
        assert FROZEN_PLANS[name][0] == (ci, co, k, s, padding, pad_mode, n), name
    rest = sorted(set(FROZEN_PLANS) - set(config2))
    assert [n.split(".")[0] for n in rest] == ["vnet_i2s"] * 9 + ["vnet_s2i"] * 12


@pytest.mark.parametrize("name", sorted(FROZEN_PLANS))
def test_plans_of_configs_2_and_4_equal_the_frozen_copy(name):
    (ci, co, k, s, padding, pad_mode, n), want = FROZEN_PLANS[name]
    k, s, dims = (k,) * 3, (s,) * 3, (n,) * 3
    pads = C.norm_padding(padding, k, s, dims)
    out = tuple((d + lo + hi - kk) // ss + 1 for d, (lo, hi), kk, ss in zip(dims, pads, k, s))
    got = []
    for dtype in (BF16, torch.float32):
        for op in ("fwd", "dgrad", "wgrad"):
            kw = dict(in_dims=dims, pads=pads, pad_mode=pad_mode) if op == "dgrad" else {}
            plan = C.conv_plan(op, ci, co, k, s, out, dtype, BATCH, **kw)
            assert plan.tap_chunks == 0 and plan.tap_chunk == (), plan
            got.append(_digest(plan))
    assert tuple(got) == want
