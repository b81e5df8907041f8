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
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from vangan_torch.losses import (
    LossScales,
    cycle_loss,
    cycle_reconstruction,
    cycle_seg_loss,
    discriminator_loss_fn,
    generator_loss_fn,
    identity_loss,
)
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


def _no_mark(name: str) -> None:
    pass


def compute_losses(nets: Dict[str, nn.Module], cfg, scales: LossScales,
                   real_I: torch.Tensor, real_S: torch.Tensor, train: bool = False,
                   noise_std: float = 0.0, generator: Optional[torch.Generator] = None,
                   mark: Callable[[str], None] = _no_mark
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One forward of the CycleGAN graph on (B, X, Y, Z, 1) batches: returns
    (the sum of the four totals, the result dict of the JAX step). ``mark(name)``
    is called at the end of each phase ("generators", "cycle_losses",
    "discriminators", "adversarial_losses"); a benchmark records a CUDA event
    there."""
    # A -> B, B -> A (vangan.py:295-297), then the cycles (vangan.py:300-308),
    # in the JAX package's order: a BatchNorm generator moves its running
    # statistics at each call in training (step.py:218-236)
    fake_S = nets["gen_IS"](real_I, train, generator)
    fake_I = nets["gen_SI"](real_S, train, generator)
    cycled_S = nets["gen_IS"](fake_I.detach(), train, generator)
    cycled_I = nets["gen_SI"](fake_S.detach(), train, generator)
    mark("generators")

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
    mark("cycle_losses")

    # discriminator outputs (vangan.py:315-319)
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
    mark("discriminators")

    # LSGAN adversarial losses (vangan.py:322-332); WGAN is refused by the config
    gen_IS_loss = generator_loss_fn(scales, disc_fake_S_gen)
    gen_SI_loss = generator_loss_fn(scales, disc_fake_I_gen)
    disc_I_loss = discriminator_loss_fn(scales, disc_real_I, disc_fake_I_dis)
    disc_S_loss = discriminator_loss_fn(scales, disc_real_S, disc_fake_S_dis)

    total_loss_I = gen_IS_loss + cycle_loss_I + seg_loss
    total_loss_S = gen_SI_loss + cycle_loss_S + reconstruction_loss
    if id_IS_loss is not None:
        total_loss_I = total_loss_I + id_IS_loss
        total_loss_S = total_loss_S + id_SI_loss

    mark("adversarial_losses")
    result = dict(zip(RESULT_KEYS, (
        total_loss_I, total_loss_S, disc_I_loss, disc_S_loss, gen_IS_loss, gen_SI_loss,
        cycle_loss_I, cycle_loss_S, seg_loss, reconstruction_loss)))
    if id_IS_loss is not None:
        result["identity_IS_loss"] = id_IS_loss
        result["identity_SI_loss"] = id_SI_loss
    return total_loss_I + total_loss_S + disc_I_loss + disc_S_loss, result


def test_step(nets: Dict[str, nn.Module], cfg, scales: LossScales, real_I: torch.Tensor,
              real_S: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Loss evaluation without gradients (vangan.py:442-457): noise σ 0, not training."""
    with torch.inference_mode():
        return compute_losses(nets, cfg, scales, real_I, real_S, train=False)[1]


def compute_grads(nets: Dict[str, nn.Module], cfg, scales: LossScales, real_I: torch.Tensor,
                  real_S: torch.Tensor, noise_std: float, generator: torch.Generator,
                  mark: Callable[[str], None] = _no_mark
                  ) -> Tuple[Dict[str, List[torch.Tensor]], Dict[str, torch.Tensor]]:
    """The four restricted gradients of one training forward (one list per
    network, in ``parameters()`` order; zeros where a parameter got none) and
    the loss dict, from one ``backward()`` of the combined scalar."""
    for net in nets.values():
        net.zero_grad(set_to_none=True)
    total, result = compute_losses(nets, cfg, scales, real_I, real_S, train=True,
                                   noise_std=noise_std, generator=generator, mark=mark)
    total.backward()
    mark("backward")
    grads = {name: [torch.zeros_like(p) if p.grad is None else p.grad
                    for p in nets[name].parameters()] for name in NETWORKS}
    for net in nets.values():
        net.zero_grad(set_to_none=True)
    return grads, {k: v.detach() for k, v in result.items()}


def train_step(nets: Dict[str, nn.Module], cfg, scales: LossScales, state: TrainState,
               real_I: torch.Tensor, real_S: torch.Tensor, noise_std: float, update_gen: bool,
               generator: torch.Generator, mark: Callable[[str], None] = _no_mark
               ) -> Dict[str, torch.Tensor]:
    """One optimisation step of all four networks (vangan.py:380-440): the
    gradients of ``compute_grads``, then each network's clip + Adam. With
    ``update_gen`` False the generators' parameters and optimizer states stay
    as they were (step.py:416-433); BatchNorm running statistics, moved by
    the forward, advance either way, as the JAX step stores them
    (step.py:436). Returns the loss dict (0-d tensors on the device)."""
    grads, result = compute_grads(nets, cfg, scales, real_I, real_S, noise_std, generator,
                                  mark)
    for name in NETWORKS:
        if update_gen or not name.startswith("gen"):
            state.apply(name, grads[name])
    state.step += 1
    mark("optimizer")
    return result
