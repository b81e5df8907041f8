"""The predict mix: ``vangan_torch.inference.stitcher.stitch_subvolumes`` with
``gen_IS``, as ``inference.mapping.run_mapping`` calls it for each volume
(``complete=True``, symmetric padding by ``pad_factor``, a Gaussian blend,
``batch`` patches a generator call), over ``volumes`` seeded volumes made at
set-up on the host and stitched back to back.

Set-up warms every generator shape up on one ``warm_size`` volume at the
same stride and batch. The window stitches the volumes in turn until the
deadline; the volume in flight then finishes and counts.
``predict_mvox_per_s`` is the input voxels of every volume stitched / the
time from the window's start to the last volume's return to the host.

With ``trace`` the profiler covers the window's first volume on the device
(the per-layer metrics) and its second with the host's operators too (the
names of the idle gaps); the window runs on until both are done. Then one of
the window's volumes, drawn from the seed, is compared whole with the
reference's stitch of the same input.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import check, data, trace, weights, work
from portbench.reference import stitch as ref_stitch
from portbench.reference.draws import Draws
from portbench.reference.layers import Ctx
from portbench.reference.nets import kind
from portbench.run_support import build_gan, no_tf32


def _stitch(h, gen, vol):
    from vangan_torch.inference.stitcher import stitch_subvolumes

    tr = h.traffic
    k = tr["patch"]
    return stitch_subvolumes(gen, vol, (tr["batch"], k, k, k, 1), stride=(tr["stride"],) * 3,
                             complete=True, padFactor=tr["pad_factor"], blend=tr["blend"],
                             batch_size=tr["batch"], save=False, device=h.device)


def volume_seed(seed: int, i: int) -> int:
    return int(np.random.SeedSequence([seed, i]).generate_state(1)[0])


def run(h) -> dict:
    tr, dev = h.traffic, h.device
    gan, fields, init = build_gan(h, SUBVOL_PATCH_SIZE=(tr["patch"],) * 3)
    del init
    gen_is = gan.gen_IS_batched

    def gen(x):
        with torch.profiler.record_function("portbench.gen_IS"):
            return gen_is(x)

    vols = [data.volume(tr["size"], volume_seed(h.seed, i), dev) for i in range(tr["volumes"])]
    h.mark("volumes")
    _stitch(h, gen, data.volume(tr["warm_size"], volume_seed(h.seed, tr["volumes"]), dev))
    h.mark("warm-up")

    window = trace.Window() if h.trace else None
    labels = trace.Window(host=True) if h.trace else None
    outs = []
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    setup_s = t0 - h.t_start
    h.mark("window start")
    while True:
        i = len(outs)
        traced = (window, labels)[i] if window is not None and i < 2 else None
        if traced is not None:
            traced.start()
        with torch.profiler.record_function("portbench.stitch_volume"):
            outs.append(_stitch(h, gen, vols[i % len(vols)]))
        if traced is not None:
            traced.stop()
        if time.perf_counter() - t0 >= h.seconds and (window is None or i >= 1):
            break
    t1 = time.perf_counter()
    vox = sum(vols[i % len(vols)][..., 0].size for i in range(len(outs)))
    failed = sum(1 for o in outs if not np.isfinite(o).all())
    out = {"setup_s": setup_s, "attempted": len(outs), "failed": failed,
           "e2e": {"predict_mvox_per_s": vox / (t1 - t0) / 1e6},
           "window": {"seconds": t1 - t0, "volumes": len(outs)},
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else 0)}
    if window is not None:
        shape = vols[0].shape[:3]
        out["trace"] = {"kind": "predict", "summary": window.summary(),
                        "labelled": labels.summary(), "volumes": 1,
                        "work": work.generator_work(fields, (tr["patch"],) * 3)
                        .scaled(unique_patches(shape, tr))}

    pick = int(np.random.default_rng(h.seed).integers(len(outs)))
    prog = outs[pick]
    del gan, gen_is, outs, window, labels
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t2 = time.perf_counter()
    ref = reference_volume(h, fields, vols[pick % len(vols)])
    out["window"]["reference_s"] = time.perf_counter() - t2
    out["numbers"] = check.predict_numbers(prog, ref)
    return out


def unique_patches(shape, tr) -> int:
    k, s = tr["patch"], tr["stride"]
    n = 1
    for size in shape:
        n *= len(set(ref_stitch.origins(size + 2 * int(tr["pad_factor"] * size), k, s)))
    return n


def reference_volume(h, fields: dict, vol: np.ndarray, quant=None) -> np.ndarray:
    """The reference's stitch of ``vol``: gen_IS from the run's seeded weights
    in float32 (``quant``: its convs' operands rounded to that dtype)."""
    from portbench.reference.step import specs

    tr, dev = h.traffic, h.device
    P = weights.make(specs(fields), h.seed, dev)["gen_IS"]
    net = kind(fields["gen_i2s"])
    ctx, seg = Ctx(quant=quant), Draws(None, dev, torch.float32).segment()

    def gen(x):
        return net.forward(P, x, ctx, seg, False, 0.0)

    with no_tf32():
        return ref_stitch.stitch(gen, vol, tr["patch"], tr["stride"], tr["pad_factor"],
                                 tr["batch"], dev)
