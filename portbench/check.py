"""The comparisons that decide ``correct``, each number against its limit
(``limits/<workload>.json``; a number without a limit is reported under
``readings`` and not compared).

Training (the first steps of the run, which set-up drives through the
window's own call and feed, against the reference's same steps):

- ``loss``: the widest relative gap |program - reference| / |reference| of
  every loss of every compared step; ``loss1``: of the first step's;
- by leaf, |norm_program - norm_reference| / max(norm_reference, the median
  leaf's norm_reference), of the first gradient as the optimizer got it
  (clipped): ``grad1`` the worst leaf, ``grad1_median`` the median leaf,
  ``grad1_net_median`` the median over the four networks of each one's
  median leaf; ``grad_net``: the widest relative gap of a network's whole
  gradient norm;
- the same by leaf of each leaf's change over the compared steps:
  ``change`` the worst leaf, ``change_median`` the median leaf; leaves whose
  reference gradient is under a thousandth of the median leaf's (nought but
  rounding, as a bias under a norm) are left out.

Predict (a stitched volume of the window against the reference's stitch of
the same input): ``max_gap`` and ``rms_gap``, the widest and the root mean
square voxel gap, as shares of the output's 0-255 range.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict

import numpy as np

GRAD_FLOOR = 1e-3  # a leaf's reference gradient under this share of the median is no signal


def rel_gap(a: float, b: float) -> float:
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-12)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys) -> Dict[str, float]:
    """|prog - ref| / max(ref, the median ref over ``keys``) of each leaf."""
    scale = float(np.median([ref[k] for k in keys]))
    out = {}
    for k in keys:
        gap = abs(prog.get(k, math.nan) - ref[k]) / max(ref[k], scale, 1e-30)
        out[k] = gap if math.isfinite(gap) else math.inf
    return out


def by_net(leaves: Dict[str, float]) -> Dict[str, list]:
    """The values of "net/leaf" keys, grouped by network."""
    out: Dict[str, list] = {}
    for k, v in leaves.items():
        out.setdefault(k.split("/")[0], []).append(v)
    return out


def net_norms(leaves: Dict[str, float]) -> Dict[str, float]:
    """Each network's whole norm from its leaves' norms ("net/leaf" keys)."""
    return {net: math.sqrt(sum(v * v for v in vs)) for net, vs in by_net(leaves).items()}


def train_numbers(prog, ref) -> Dict[str, float]:
    """``prog`` and ``ref``: ``reference.step.Readings`` (the program's taken
    from its state, the reference's computed)."""
    if len(prog.losses) != len(ref.losses):
        return {k: math.inf for k in ("loss", "loss1", "grad1", "grad1_median",
                                      "grad1_net_median", "grad_net", "change", "change_median")}
    loss = [max(rel_gap(p[k], r[k]) for k in r) for p, r in zip(prog.losses, ref.losses)]
    grad1 = leaf_gaps(prog.grad1, ref.grad1, list(ref.grad1))
    med = float(np.median(list(ref.grad1.values())))
    moving = [k for k, g in ref.grad1.items() if g >= GRAD_FLOOR * med]
    change = leaf_gaps(prog.change, ref.change, moving)
    pn, rn = net_norms(prog.grad1), net_norms(ref.grad1)
    return {"loss": max(loss), "loss1": loss[0], "grad1": max(grad1.values()),
            "grad1_median": float(np.median(list(grad1.values()))),
            "grad1_net_median": float(np.median([np.median(v) for v in by_net(grad1).values()])),
            "grad_net": max(rel_gap(pn.get(k, math.nan), v) for k, v in rn.items()),
            "change": max(change.values()),
            "change_median": float(np.median(list(change.values())))}


def predict_numbers(prog: np.ndarray, ref: np.ndarray) -> Dict[str, float]:
    if prog.shape != ref.shape:
        return {"max_gap": math.inf, "rms_gap": math.inf}
    d = prog.astype(np.float64) - ref.astype(np.float64)
    if not np.isfinite(d).all():
        return {"max_gap": math.inf, "rms_gap": math.inf}
    return {"max_gap": float(np.abs(d).max()) / 255.0,
            "rms_gap": float(np.sqrt(np.mean(d * d))) / 255.0}


def load_limits(root: str, workload: str) -> Dict[str, float]:
    with open(os.path.join(root, "portbench", "limits", f"{workload}.json")) as f:
        return json.load(f)["limits"]


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): every number that has a limit
    is at or under it (a limit without its number fails)."""
    checks = {k: {"value": numbers.get(k, math.nan), "limit": v} for k, v in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
