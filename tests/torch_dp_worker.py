"""What each rank runs in the data-parallel tests (``test_torch_parallel*.py``).

``vangan_torch.parallel.spawn`` starts the ranks, which import this module
and ``vangan_torch`` only: no JAX, no flax, no test module that imports them.
``run(group, jobs)`` runs each job, ``name -> (function name, keyword
arguments)``, on every rank in the same order and returns ``name -> result``
(CPU tensors and plain values), with ``"jax_imported"``.
"""

import sys
import time

import torch

from vangan_torch.config import VanGanConfig
from vangan_torch.inference.stitcher import stitch_subvolumes
from vangan_torch.models.discriminator import PatchGANDiscriminator3D
from vangan_torch.models.layers import BatchNorm
from vangan_torch.models.resunet import ResUNet3D
from vangan_torch.models.vnet import VNet3D
from vangan_torch.parallel import all_reduce_grads, all_reduce_mean, rows
from vangan_torch.training import step
from vangan_torch.training.state import NETWORKS
from vangan_torch.vangan import VanGan

STEPS_PER_EPOCH = 3  # test_torch_train_step's


def tiny_models(dtype=torch.float32):
    """``test_train_step.tiny_models(deterministic=True)`` in the port (no
    noise, no dropout), seeded; in ``dtype``."""
    g = torch.Generator().manual_seed(0)
    disc = dict(filters=8, use_dropout=False, use_input_noise=False, use_layer_noise=False)
    gen = dict(upsample_mode="simple", generator=g)
    models = {"gen_IS": ResUNet3D(4, 2, **gen), "gen_SI": ResUNet3D(4, 2, **gen),
              "disc_I": PatchGANDiscriminator3D(**disc, generator=g),
              "disc_S": PatchGANDiscriminator3D(**disc, generator=g)}
    for m in models.values():
        m.to(dtype)
        m.dtype = dtype
    return models


def tiny_gan(cfg_kw, states=None, group=None, dtype=torch.float32):
    """A CPU ``VanGan`` of ``tiny_models`` with ``states`` (state_dicts by
    network) loaded, as one rank of ``group`` or alone."""
    models = tiny_models(dtype)
    if states is not None:
        for name, sd in states.items():
            models[name].load_state_dict(sd)
    return VanGan(VanGanConfig(**cfg_kw), device="cpu", models=models,
                  steps_per_epoch=STEPS_PER_EPOCH, group=group)


def _flat(tensors):
    return torch.cat([t.detach().reshape(-1) for t in tensors])


def grads_and_losses(gan, real_I, real_S, group=None):
    """The four restricted gradients (flat, one per network) and the loss
    dict of one training forward on the rank's rows of the global batch
    (``micro_batches`` slices of them), averaged over the ranks of ``group``."""
    sl = rows(group, len(real_I))
    grads, result = step.compute_grads(gan.nets, gan.cfg, gan.scales,
                                       torch.from_numpy(real_I[sl]),
                                       torch.from_numpy(real_S[sl]), 0.0, gan.generator,
                                       micro=gan.cfg.micro_batches)
    grads = {n: _flat(all_reduce_grads(group, grads[n])) for n in NETWORKS}
    result = all_reduce_mean(group, result)
    return grads, {k: float(v) for k, v in result.items()}


def grads_rank(group, cfg_kw, states, real_I, real_S, dtype=torch.float32):
    """The averaged gradients and losses of one training forward."""
    grads, losses = grads_and_losses(tiny_gan(cfg_kw, states, group, dtype), real_I, real_S,
                                     group)
    return {"grads": grads, "losses": losses}


def step_rank(group, cfg_kw, states, real_I, real_S, dtype=torch.float32):
    """On the tiny networks: the averaged gradients and losses, the test
    step, then one ``distributed_train_step`` on the global batch and the
    parameters after it, and the first draws of the rank's generator."""
    gan = tiny_gan(cfg_kw, states, group, dtype)
    g = torch.Generator()
    g.set_state(gan.generator.get_state())
    draws = torch.rand(8, generator=g)
    grads, losses = grads_and_losses(gan, real_I, real_S, group)
    test = {k: float(v) for k, v in gan.distributed_test_step(real_I, real_S).items()}
    after = gan.distributed_train_step(real_I, real_S, 0.0, True)
    return {"grads": grads, "losses": losses, "test": test,
            "step_losses": {k: float(v) for k, v in after.items()},
            "params": {n: _flat(gan.nets[n].parameters()) for n in NETWORKS},
            "state_dicts": {n: gan.nets[n].state_dict() for n in NETWORKS},
            "counts": dict(gan.state.counts), "draws": draws}


def vnet_rank(group, kw, state, x, gy):
    """The s2i V-Net in float64 and training mode on the rank's rows of
    ``x``, its BatchNorms across the ranks: the rows of its output, the
    input's cotangent and the parameters' gradient of sum(y gy) over the
    global batch (the averaged gradient times the world), and the moved
    running statistics."""
    net = VNet3D(**kw, output_activation="tanh")
    net.load_state_dict(state)
    net.double()
    net.dtype = torch.float64
    for m in net.modules():
        if isinstance(m, BatchNorm):
            m.group = group
    sl = rows(group, len(x))
    xs = torch.from_numpy(x[sl]).requires_grad_()
    y = net(xs, True, torch.Generator())
    (y * torch.from_numpy(gy[sl])).sum().backward()
    grads = all_reduce_grads(group, [p.grad for p in net.parameters()])
    return {"y": y.detach(), "dx": xs.grad,
            "grads": {n: g * group.world for (n, _), g in zip(net.named_parameters(), grads)},
            "buffers": {n: b.clone() for n, b in net.named_buffers()}}


def stitch_rank(group, state, vol, stride, batch_size):
    """gen_IS (the tiny ResU-Net) stitched over ``vol`` with the rank's share
    of the patches; rank 0's volume, None on the others."""
    gen = tiny_models()["gen_IS"].eval()
    gen.load_state_dict(state)
    with torch.inference_mode():
        return stitch_subvolumes(gen, vol, (batch_size, 16, 16, 16, 1), stride=stride,
                                 complete=True, padFactor=0.25, save=False,
                                 batch_size=batch_size, device="cpu", group=group)


def sleep_rank(group, seconds):
    time.sleep(seconds)


def fail_rank(group):
    """Rank 1 raises once both ranks are joined; rank 0 waits for it in a
    barrier it never leaves."""
    group.barrier()
    if group.rank == 1:
        raise ValueError("rank 1 failed on purpose")
    group.barrier()


def run(group, jobs):
    torch.set_num_threads(1)
    out = {name: globals()[fn](group, **kw) for name, (fn, kw) in jobs.items()}
    out["jax_imported"] = any(m == "jax" or m.startswith(("jax.", "flax", "vangan_tpu"))
                              for m in sys.modules)
    return out
