"""The VAN-GAN loss graph and the test step.

Counterpart of ``vangan_tpu.training.step.make_step_fns``' ``compute_losses``
and ``test_step`` (step.py:176-338, :440-448). ``compute_losses`` is one
forward of the whole CycleGAN graph (vangan.py:270-353). The JAX package
differentiates one combined scalar with ``stop_gradient`` where the
reference's per-optimizer ``var_list`` discards gradients; the port puts a
``.detach()`` at each of those places, so the backward passes of the train
step (not ported yet, ROADMAP.md Queue 1, train-step slice) need no other
change to this graph:

- the cycles feed the inner generator's detached output to the outer one
  (step.py:230,234);
- in training, each fake is judged twice with the same noise: by the
  discriminator with detached parameters (its gradient reaches the
  generator only) and by the live discriminator on the detached fake (its
  gradient reaches the discriminator only) (step.py:277-280).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

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
                   noise_std: float = 0.0, generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One forward of the CycleGAN graph on (B, X, Y, Z, 1) batches: returns
    (the sum of the four totals, the result dict of the JAX step)."""
    # A -> B, B -> A (vangan.py:295-297), then the cycles (vangan.py:300-308)
    fake_S = nets["gen_IS"](real_I)
    fake_I = nets["gen_SI"](real_S)
    cycled_S = nets["gen_IS"](fake_I.detach())
    cycled_I = nets["gen_SI"](fake_S.detach())

    cycle_loss_I = cycle_loss(scales, real_S, cycled_S, typ=cfg.cycle_loss_I_type)
    seg_loss = cycle_seg_loss(scales, real_S, cycled_S)
    cycle_loss_S = cycle_loss(scales, real_I, cycled_I, typ=cfg.cycle_loss_S_type)
    reconstruction_loss = cycle_reconstruction(scales, real_I, cycled_I)

    # identity (vangan.py:310-312; off by default): each term in its own
    # generator's total, as the JAX package routes it (step.py:243-265)
    id_IS_loss = id_SI_loss = None
    if cfg.use_identity_loss:
        same_S = nets["gen_IS"](real_S)
        same_I = nets["gen_SI"](real_I)
        typ_IS = None if cfg.identity_loss_IS_type == "mae" else cfg.identity_loss_IS_type
        typ_SI = None if cfg.identity_loss_SI_type == "mae" else cfg.identity_loss_SI_type
        id_IS_loss = identity_loss(scales, real_S, same_S, typ=typ_IS)
        id_SI_loss = identity_loss(scales, real_I, same_I, typ=typ_SI)

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
