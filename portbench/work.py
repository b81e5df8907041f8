"""The work of a step or a patch, counted from the configuration's layer
shapes alone, and the table of peaks (``peaks.json``).

The reference networks run once on the ``meta`` device (shapes, no data)
with a record of every conv, transposed conv, InstanceNorm and BatchNorm
call: input, weight and output shapes, and whether the input and the weight
need a gradient. From it:

- conv FLOPs: 2 B Co Ci k^3 (output voxels) for the forward, and the same for
  each of the input gradient (dgrad) and weight gradient (wgrad) that the
  step needs: nothing recomputed, whatever route, library or precision runs
  the conv; a transposed conv's: 2 B Ci Co k^3 (input voxels), each input
  voxel spread over k^3 output voxels of Co channels;
- conv bytes, each operand once in the compute dtype: forward x + w + y,
  dgrad dy + w + dx, wgrad x + dy and dw in float32;
- norm bytes, of an InstanceNorm or a BatchNorm alike: forward x read and y
  written, backward x and dy read and dx written, in the compute dtype;
- the roofline bound of each conv pass, max(FLOPs / peak FLOP/s, bytes /
  peak bytes/s), summed.
"""

from __future__ import annotations

import functools
import json
import math
import os
from typing import Iterable, List

import torch


@functools.lru_cache(maxsize=1)
def peaks() -> dict:
    """The card's published peaks (``peaks.json``)."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")) as f:
        return json.load(f)


class Work:
    def __init__(self):
        self.conv_flops = 0.0
        self.conv_bound_s = 0.0
        self.norm_bytes = 0.0

    def scaled(self, n: float) -> "Work":
        w = Work()
        w.conv_flops, w.conv_bound_s, w.norm_bytes = (n * self.conv_flops,
                                                      n * self.conv_bound_s,
                                                      n * self.norm_bytes)
        return w

    @property
    def norm_bound_s(self) -> float:
        return self.norm_bytes / peaks()["hbm_bytes_per_s"]


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / peaks()["bf16_flops_per_s"], nbytes / peaks()["hbm_bytes_per_s"])


def conv_passes(x_shape, w_shape, y_shape, needs_dx: bool, needs_dw: bool, act_bytes: int,
                transposed: bool = False):
    """[(pass, FLOPs, bytes)] of one conv (``transposed``: a transposed conv,
    its weight (Ci, Co, k, k, k)): the forward, and dgrad / wgrad where a
    gradient is needed."""
    x, w, y = (math.prod(s) for s in (x_shape, w_shape, y_shape))
    # 2 B Co out_vox Ci k^3; transposed, 2 B Ci in_vox Co k^3
    flops = 2.0 * (x if transposed else y) * math.prod(w_shape[1:])
    out = [("fwd", flops, (x + w + y) * act_bytes)]
    if needs_dx:
        out.append(("dgrad", flops, (y + w + x) * act_bytes))
    if needs_dw:
        out.append(("wgrad", flops, (x + y) * act_bytes + w * 4))
    return out


def instnorm_bytes(shape, needs_dx: bool, act_bytes: int) -> float:
    n = math.prod(shape)
    return (2 + (3 if needs_dx else 0)) * n * act_bytes


def tally(records: Iterable, act_bytes: int, backward: bool = True) -> Work:
    """The ``Work`` of a record of conv ("conv", "conv_transpose") and norm
    ("in", "bn") calls; without ``backward`` only forwards count."""
    w = Work()
    for rec in records:
        if rec[0] in ("conv", "conv_transpose"):
            kind, xs, ws, ys, dx, dw = rec
            for _, flops, nbytes in conv_passes(xs, ws, ys, dx and backward, dw and backward,
                                                act_bytes, kind == "conv_transpose"):
                w.conv_flops += flops
                w.conv_bound_s += bound_s(flops, nbytes)
        elif rec[0] in ("in", "bn"):
            _, shape, dx = rec
            w.norm_bytes += instnorm_bytes(shape, dx and backward, act_bytes)
        else:
            raise ValueError(f"no work count for a {rec[0]!r} record")
    return w


def dtype_bytes(fields: dict) -> int:
    return 2 if fields.get("compute_dtype", "float32") in ("bfloat16", "bf16") else 4


def train_step_work(fields: dict, batch: int, patch) -> Work:
    """One train step's work (4 generator and 6 discriminator calls, the
    backward passes they need)."""
    from portbench.reference.draws import Draws
    from portbench.reference.layers import Ctx
    from portbench.reference.step import compute_losses, specs

    records: List = []
    meta = torch.device("meta")
    P = {n: {k: torch.empty(shape, device=meta).requires_grad_() for k, (shape, _) in s.items()}
         for n, s in specs(fields).items()}
    x = torch.empty((batch, *patch, 1), device=meta)
    compute_losses(fields, P, x, x, Draws(None, meta, torch.float32), 0.1,
                   Ctx(record=records), ckpt=False)
    return tally(records, dtype_bytes(fields))


def generator_work(fields: dict, patch, role: str = "i2s") -> Work:
    """One gen_IS forward of one patch."""
    from portbench.reference.draws import Draws
    from portbench.reference.layers import Ctx
    from portbench.reference.nets import kind

    net = kind(fields["gen_i2s"] if role == "i2s" else fields["gen_s2i"])
    meta = torch.device("meta")
    P = {k: torch.empty(shape, device=meta) for k, (shape, _) in net.spec(fields, role).leaves.items()}
    records: List = []
    net.forward(P, torch.empty((1, *patch, 1), device=meta), Ctx(record=records),
                Draws(None, meta, torch.float32).segment(), False, 0.0)
    return tally(records, dtype_bytes(fields), backward=False)
