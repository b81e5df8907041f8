"""The VAN-GAN loss graph, the train step and the test step.

Counterpart of ``vangan_tpu.training.step.make_step_fns``' ``compute_losses``,
``train_step`` and ``test_step`` (step.py:176-448). ``compute_losses`` is one
forward of the whole CycleGAN graph (vangan.py:270-353). The JAX package
differentiates one combined scalar with ``stop_gradient`` where the
reference's per-optimizer ``var_list`` discards gradients; the port puts a
``.detach()`` at each of those places, so ONE ``backward()`` of the combined
scalar yields exactly the four restricted gradients (the JAX package's
``backward_mode="combined"``; its two-phase, split and remat variants exist
for TPU compile limits and 16 GB of HBM, and are not ported):

- the cycles feed the inner generator's detached output to the outer one
  (step.py:230,234);
- in training, each fake is judged twice with the same noise: by the
  discriminator with detached parameters (its gradient reaches the
  generator only) and by the live discriminator on the detached fake (its
  gradient reaches the discriminator only) (step.py:277-280).

With ``cfg.wasserstein`` the adversarial losses are the Wasserstein ones and,
from the second step (``gp_scale``), each critic's loss adds the gradient
penalty on its own domain inside the differentiated scalar, as the JAX
package has it (step.py:283-318; the reference adds it outside its tape, on
disc_S for both domains). A spectral norm stores its power iteration at
each training call of a critic, in JAX's order (real, then each fake's two
judgements), but not at the penalty's calls, whose state JAX discards.

With ``cfg.micro_batches`` = m the train step accumulates gradients, as
``vangan_tpu.parallel.jit_microbatch_step`` (parallel.py:74-147; m = 1 is
one slice, the whole batch at the given scales, JAX's plain step): the batch
runs as m interleaved slices ``x[i::m]``, each one forward and one backward
of the combined scalar at ``LossScales.for_micro(m)``, whose gradients add
up in the parameters' float32 ``.grad`` (each slice's graph is freed before
the next starts, so the step peaks at one slice's activations); the loss
dicts are summed, every float buffer (BatchNorm running statistics,
spectral-norm vectors) starts each slice where the step found it and ends at
the mean of the slices' results, and one all-reduce and one optimizer update
follow. The slices draw their noise, dropout and penalty weights in turn
from the step's generator (JAX folds the slice's index into the step key).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from vangan_torch.losses import (
    LossScales,
    cycle_loss,
    cycle_reconstruction,
    cycle_seg_loss,
    discriminator_loss_fn,
    generator_loss_fn,
    gradient_penalty,
    identity_loss,
    wasserstein_discriminator_loss,
    wasserstein_generator_loss,
)
from vangan_torch.monitor.profiling import span
from vangan_torch.parallel import Group, all_reduce_grads, all_reduce_mean
from vangan_torch.training.state import NETWORKS, TrainState

RESULT_KEYS = ("total_IS_loss", "total_SI_loss", "D_I_loss", "D_S_loss", "gen_IS_loss",
               "gen_SI_loss", "cycle_gen_SIS_loss", "cycle_gen_ISI_loss", "seg_loss",
               "reconstruction_loss_I")


def judged_twice(disc: nn.Module, fake: torch.Tensor, noise_std: float,
                 generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """(D with detached parameters on ``fake``, D on the detached ``fake``),
    both in training mode and with the same noise and dropout draws."""
    start = generator.get_state()
    frozen = {k: v.detach() for k, v in disc.named_parameters()}
    gen_branch = torch.func.functional_call(disc, frozen, (fake, True, noise_std, generator))
    generator.set_state(start)
    dis_branch = disc(fake.detach(), True, noise_std, generator)
    return gen_branch, dis_branch


def compute_losses(nets: Dict[str, nn.Module], cfg, scales: LossScales,
                   real_I: torch.Tensor, real_S: torch.Tensor, train: bool = False,
                   noise_std: float = 0.0, generator: Optional[torch.Generator] = None,
                   gp_scale: float = 0.0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One forward of the CycleGAN graph on (B, X, Y, Z, 1) batches: returns
    (the sum of the four totals, the result dict of the JAX step). Its phases
    are the spans ``step.generators``, ``step.cycle_losses``,
    ``step.discriminators``, ``step.adversarial_losses`` and, with a gradient
    penalty, ``step.gradient_penalty`` (``monitor.profiling``). In training
    with ``cfg.wasserstein`` and a ``gp_scale`` other than 0, each critic's
    loss adds ``gp_scale`` times its gradient penalty (at 0 the JAX step adds
    0 times the penalty; the port skips computing it)."""
    # A -> B, B -> A (vangan.py:295-297), then the cycles (vangan.py:300-308),
    # in the JAX package's order: a BatchNorm generator moves its running
    # statistics at each call in training (step.py:218-236)
    with span("step.generators"):
        fake_S = nets["gen_IS"](real_I, train, generator)
        fake_I = nets["gen_SI"](real_S, train, generator)
        cycled_S = nets["gen_IS"](fake_I.detach(), train, generator)
        cycled_I = nets["gen_SI"](fake_S.detach(), train, generator)

    with span("step.cycle_losses"):
        cycle_loss_I = cycle_loss(scales, real_S, cycled_S, typ=cfg.cycle_loss_I_type)
        seg_loss = cycle_seg_loss(scales, real_S, cycled_S)
        cycle_loss_S = cycle_loss(scales, real_I, cycled_I, typ=cfg.cycle_loss_S_type)
        reconstruction_loss = cycle_reconstruction(scales, real_I, cycled_I)

        # identity (vangan.py:310-312; off by default): each term in its own
        # generator's total, as the JAX package routes it (step.py:243-265)
        id_IS_loss = id_SI_loss = None
        if cfg.use_identity_loss:
            same_S = nets["gen_IS"](real_S, train, generator)
            same_I = nets["gen_SI"](real_I, train, generator)
            typ_IS = None if cfg.identity_loss_IS_type == "mae" else cfg.identity_loss_IS_type
            typ_SI = None if cfg.identity_loss_SI_type == "mae" else cfg.identity_loss_SI_type
            id_IS_loss = identity_loss(scales, real_S, same_S, typ=typ_IS)
            id_SI_loss = identity_loss(scales, real_I, same_I, typ=typ_SI)

    # discriminator outputs (vangan.py:315-319)
    with span("step.discriminators"):
        disc_real_S = nets["disc_S"](real_S, train, noise_std, generator)
        disc_real_I = nets["disc_I"](real_I, train, noise_std, generator)
        if train:
            disc_fake_S_gen, disc_fake_S_dis = judged_twice(nets["disc_S"], fake_S, noise_std,
                                                            generator)
            disc_fake_I_gen, disc_fake_I_dis = judged_twice(nets["disc_I"], fake_I, noise_std,
                                                            generator)
        else:
            # no noise, no dropout: the two judgements of a fake are the same
            # value (XLA CSEs them in the JAX step), so each runs once
            disc_fake_S_gen = disc_fake_S_dis = nets["disc_S"](fake_S.detach())
            disc_fake_I_gen = disc_fake_I_dis = nets["disc_I"](fake_I.detach())

    # adversarial losses (vangan.py:322-332)
    with span("step.adversarial_losses"):
        if cfg.wasserstein:
            gen_IS_loss = wasserstein_generator_loss(scales, disc_fake_S_gen)
            gen_SI_loss = wasserstein_generator_loss(scales, disc_fake_I_gen)
            disc_I_loss = wasserstein_discriminator_loss(scales, disc_real_I, disc_fake_I_dis)
            disc_S_loss = wasserstein_discriminator_loss(scales, disc_real_S, disc_fake_S_dis)
        else:
            gen_IS_loss = generator_loss_fn(scales, disc_fake_S_gen)
            gen_SI_loss = generator_loss_fn(scales, disc_fake_I_gen)
            disc_I_loss = discriminator_loss_fn(scales, disc_real_I, disc_fake_I_dis)
            disc_S_loss = discriminator_loss_fn(scales, disc_real_S, disc_fake_S_dis)

        total_loss_I = gen_IS_loss + cycle_loss_I + seg_loss
        total_loss_S = gen_SI_loss + cycle_loss_S + reconstruction_loss
        if id_IS_loss is not None:
            total_loss_I = total_loss_I + id_IS_loss
            total_loss_S = total_loss_S + id_SI_loss

    # WGAN-GP on the matching critic, trained with its own noise and dropout
    # draws, storing no spectral-norm state (step.py:283-318)
    if cfg.wasserstein and train and gp_scale:
        def critic(name):
            return lambda x: nets[name](x, True, noise_std, generator, update_stats=False)

        with span("step.gradient_penalty"):
            disc_I_loss = disc_I_loss + gp_scale * gradient_penalty(
                scales, critic("disc_I"), real_I, fake_I, generator)
            disc_S_loss = disc_S_loss + gp_scale * gradient_penalty(
                scales, critic("disc_S"), real_S, fake_S, generator)

    result = dict(zip(RESULT_KEYS, (
        total_loss_I, total_loss_S, disc_I_loss, disc_S_loss, gen_IS_loss, gen_SI_loss,
        cycle_loss_I, cycle_loss_S, seg_loss, reconstruction_loss)))
    if id_IS_loss is not None:
        result["identity_IS_loss"] = id_IS_loss
        result["identity_SI_loss"] = id_SI_loss
    return total_loss_I + total_loss_S + disc_I_loss + disc_S_loss, result


def test_step(nets: Dict[str, nn.Module], cfg, scales: LossScales, real_I: torch.Tensor,
              real_S: torch.Tensor, group: Optional[Group] = None) -> Dict[str, torch.Tensor]:
    """Loss evaluation without gradients (vangan.py:442-457): noise σ 0, not
    training. With ``group``, on the rank's shard (``scales`` the rank's),
    the losses averaged over the ranks: the JAX step's replicated result."""
    with torch.inference_mode():
        result = compute_losses(nets, cfg, scales, real_I, real_S, train=False)[1]
        return all_reduce_mean(group, result)


def compute_grads(nets: Dict[str, nn.Module], cfg, scales: LossScales, real_I: torch.Tensor,
                  real_S: torch.Tensor, noise_std: float, generator: torch.Generator,
                  gp_scale: float = 0.0, micro: int = 1
                  ) -> Tuple[Dict[str, List[torch.Tensor]], Dict[str, torch.Tensor]]:
    """The four restricted gradients of a training forward (one list per
    network, in ``parameters()`` order; zeros where a parameter got none) and
    the loss dict, from one ``backward()`` of the combined scalar per slice
    ``x[i::micro]`` at ``scales.for_micro(micro)``, summed, each slice
    starting from the float buffers as they were, which end at the mean of
    the slices' results (see the module note; vangan_tpu
    parallel.py:112-129). ``micro`` 1 is one slice: the whole batch at
    ``scales``, the buffers as its forward left them. Each slice is a
    ``step.forward`` span (``compute_losses``' phases) and a
    ``step.backward`` span."""
    for net in nets.values():
        net.zero_grad(set_to_none=True)
    scales = scales.for_micro(micro)
    buffers = [b for net in nets.values() for b in net.buffers() if b.is_floating_point()]
    start = [b.clone() for b in buffers]
    result, moved = None, None
    for i in range(micro):
        if i:
            with torch.no_grad():
                for b, b0 in zip(buffers, start):
                    b.copy_(b0)
        # views: each network casts its input to the compute dtype, a copy
        with span("step.forward"):
            total, res = compute_losses(nets, cfg, scales, real_I[i::micro], real_S[i::micro],
                                        train=True, noise_std=noise_std, generator=generator,
                                        gp_scale=gp_scale)
        with span("step.backward"):
            total.backward()
        del total  # no slice's graph is held through the next slice
        res = {k: v.detach() for k, v in res.items()}
        result = res if result is None else {k: result[k] + res[k] for k in result}
        moved = ([b.clone() for b in buffers] if moved is None else
                 [m.add_(b) for m, b in zip(moved, buffers)])
    with torch.no_grad():
        for b, m in zip(buffers, moved):
            b.copy_(m / micro)
    grads = {name: [torch.zeros_like(p) if p.grad is None else p.grad
                    for p in nets[name].parameters()] for name in NETWORKS}
    for net in nets.values():
        net.zero_grad(set_to_none=True)
    return grads, result


def train_step(nets: Dict[str, nn.Module], cfg, scales: LossScales, state: TrainState,
               real_I: torch.Tensor, real_S: torch.Tensor, noise_std: float, update_gen: bool,
               generator: torch.Generator, group: Optional[Group] = None
               ) -> Dict[str, torch.Tensor]:
    """One optimisation step of all four networks (vangan.py:380-440): the
    gradients of ``compute_grads``, then each network's Adam update (clipped
    on the LSGAN path). With ``update_gen`` False the generators' parameters
    and optimizer states stay as they were (step.py:416-433); BatchNorm
    running statistics and spectral-norm vectors, moved by the forward,
    advance either way, as the JAX step stores them (step.py:436). The
    gradient penalty weighs ``cfg.gp_weight`` from the second step of the
    run (step.py:355-358). With ``group`` the batch is the rank's shard and
    ``scales`` the rank's: each network's gradients, and the loss dict, are
    averaged over the ranks before the update (the clip acts on the global
    gradient, as JAX's), then every rank applies the same update. With
    ``cfg.micro_batches`` > 1 the gradients and losses are accumulated over
    the slices of the (rank's) batch first (see the module note): one
    all-reduce and one update a step: the spans ``step.all_reduce`` (with a
    group) and ``step.optimizer``. Returns the loss dict (0-d tensors on the
    device)."""
    gp_scale = cfg.gp_weight if cfg.wasserstein and state.step > 0 else 0.0
    grads, result = compute_grads(nets, cfg, scales, real_I, real_S, noise_std, generator,
                                  gp_scale, cfg.micro_batches)
    updated = [name for name in NETWORKS if update_gen or not name.startswith("gen")]
    if group is not None:
        with span("step.all_reduce"):
            grads = {name: all_reduce_grads(group, grads[name]) for name in updated}
            result = all_reduce_mean(group, result)
    with span("step.optimizer"):
        for name in updated:
            state.apply(name, grads[name])
        state.step += 1
    return result
