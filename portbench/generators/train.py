"""The training mix: ``vangan_torch.vangan.train``, the epoch function that
``training.loop.fit`` runs, on a seeded feed of unpaired patch batches.

Set-up builds one ``VanGan`` from the seeded weights, and drives its first
``compared_steps`` steps through ``train`` and the feed, one call a step, on
rows that all differ, keeping what the comparison reads: each step's losses,
each leaf's first gradient as the optimizer got it (Adam's first moment after
one step is (1 - b1) g), and each leaf's change after those steps. These
steps also warm up every shape of the window. The window then runs ``train``
on the same object and feed until the deadline.

End-to-end metrics of the window (from a ``synchronize()`` at its start to
the completion of its last step):

- ``train_patches_per_s``: batch x the steps completed / the window's time;
- ``train_step_p90_ms``: the 90th percentile of the gaps between CUDA events
  that the feed records on the stream as it hands each batch over (and once
  after the last step): each step's time as the device paced it, with any
  host stall in it.

With ``trace`` the profiler covers steps ``trace_from`` to ``trace_from +
trace_steps`` of the window on the device (the per-layer metrics), then
``label_steps`` more with the host's operators (the names of the idle gaps);
the feed runs on past the deadline until both are complete. Then the
reference follows the compared steps.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import check, data, trace, weights, work
from portbench.reference import step as ref_step
from portbench.run_support import build_gan, no_tf32


class _NoSummary:
    def scalar(self, *args, **kwargs) -> None:
        pass


class _Stamps:
    """CUDA events on the current stream (host clock on the CPU)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks: List = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def gaps_ms(self) -> List[float]:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [1e3 * (b - a) for a, b in zip(self.marks, self.marks[1:])]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def run(h) -> dict:
    from vangan_torch import vangan as vg

    tr, dev = h.traffic, h.device
    batch, patch, noise = tr["batch"], tuple(tr["patch"]), tr["noise_std"]
    gan, fields, init = build_gan(h, BATCH_SIZE=batch, SUBVOL_PATCH_SIZE=patch)
    pool = data.train_pool(tr["pool"], patch, h.seed, dev)
    h.mark("pool")
    feed = data.Feed(pool, batch, h.seed)
    summary = _NoSummary()

    # the compared steps, through the window's own call and feed
    losses: List[Dict[str, float]] = []
    grad1: Dict[str, float] = {}
    for k in range(tr["compared_steps"]):
        res = vg.train(feed, gan, summary, 0, steps=1, training=True, noise_std=noise)
        losses.append({key: v[0] for key, v in res.items()})
        if k == 0:
            grad1 = first_gradients(gan)
    prog = ref_step.Readings(losses, grad1, changes(gan, init))
    del init
    h.mark("compared steps")

    # the window
    stamps = _Stamps(dev)
    window = trace.Window() if h.trace else None
    labels = trace.Window(host=True) if h.trace else None
    t_from, t_to = tr["trace_from"], tr["trace_from"] + tr["trace_steps"]
    t_end = t_to + tr["label_steps"]

    def on_batch(i: int) -> None:
        if window is not None and i == t_from:
            window.start()
        if window is not None and i == t_to:
            window.stop()
            labels.start()
        if window is not None and i == t_end:
            labels.stop()
        stamps.mark()

    feed.on_batch = on_batch
    feed.on_end = lambda i: stamps.mark()
    feed.handed = 0
    _sync(dev)
    t0 = time.perf_counter()
    setup_s = t0 - h.t_start
    h.mark("window start")
    feed.deadline = t0 + h.seconds
    if window is not None:  # the traced stretch completes whatever the deadline
        feed.deadline = None
        results = vg.train(feed, gan, summary, 1, steps=t_end + 1, training=True,
                           noise_std=noise)
        feed.deadline = t0 + h.seconds
        more = vg.train(feed, gan, summary, 1, training=True, noise_std=noise)
        for key in results:
            results[key] += more.get(key, [])
    else:
        results = vg.train(feed, gan, summary, 1, training=True, noise_std=noise)
    _sync(dev)
    t1 = time.perf_counter()
    steps = len(next(iter(results.values()))) if results else 0
    gaps = stamps.gaps_ms()
    failed = sum(1 for i in range(steps)
                 if not all(math.isfinite(v[i]) for v in results.values()))
    out = {"setup_s": setup_s, "attempted": steps, "failed": failed,
           "e2e": {"train_patches_per_s": batch * steps / (t1 - t0),
                   "train_step_p90_ms": float(np.percentile(gaps, 90)) if gaps else math.nan},
           "window": {"seconds": t1 - t0, "steps": steps},
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else 0)}
    if window is not None:
        out["trace"] = {"kind": "train", "summary": window.summary(),
                        "labelled": labels.summary(), "steps": tr["trace_steps"],
                        "work": work.train_step_work(fields, batch, patch)
                        .scaled(tr["trace_steps"])}

    # free the program's state, then the reference follows the compared steps
    del gan, feed, results, window, labels
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t2 = time.perf_counter()
    ref = reference_readings(h, fields, pool, batch, len(losses))
    out["window"]["reference_s"] = time.perf_counter() - t2
    out["numbers"] = check.train_numbers(prog, ref)
    return out


def first_gradients(gan) -> Dict[str, float]:
    """Each parameter's gradient norm as the optimizer got it, after one step
    (Adam's first moment is then (1 - b1) g); buffers have none."""
    out = {}
    for name in ref_step.NETWORKS:
        opt = gan.state.opt[name]
        for pname, p in gan.nets[name].named_parameters():
            m = opt.state[p]["exp_avg"] if p in opt.state else torch.zeros_like(p)
            out[f"{name}/{pname}"] = float(m.norm()) / (1.0 - opt.defaults["betas"][0])
    return out


def changes(gan, init) -> Dict[str, float]:
    """Each parameter's change from ``init`` (parameters only)."""
    return {f"{name}/{pname}": float((p.detach() - init[name][pname]).norm())
            for name in ref_step.NETWORKS for pname, p in gan.nets[name].named_parameters()}


def reference_readings(h, fields: dict, pool, batch: int, n_steps: int, quant=None,
                       rows=None) -> ref_step.Readings:
    """The reference's readings of the first ``n_steps`` steps of the run of
    seed ``h.seed``: the same weights, rows and draws, made anew from the seed
    (``quant``: its convs' operands rounded to that dtype; ``rows``: only the
    first rows of each batch)."""
    dev = h.device
    P0 = weights.make(ref_step.specs(fields), h.seed, dev)
    feed = data.Feed(pool, batch, h.seed)
    batches = [tuple(t[:rows].to(dev) for t in next(feed)) for _ in range(n_steps)]
    gen = torch.Generator(device=dev).manual_seed(h.seed + 1)
    with no_tf32():
        return ref_step.run_steps(fields, P0, batches, gen, h.traffic["noise_std"],
                                  h.steps_per_epoch, quant=quant, ckpt=dev.type == "cuda")
