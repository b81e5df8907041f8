"""The VAN-GAN loss library, in torch.

Counterpart of ``vangan_tpu.losses.vangan_losses`` (the reference's
loss_functions.py), with its reduction contract:

- per-sample axes (MAE / MSE / L4): the sum of per-sample means over the
  global batch / GLOBAL_BATCH, i.e. the global mean (``reduce_mean_global``);
- ``axis=None`` (BCE cycle, SSIM reconstruction, the adversarial bce types,
  the Wasserstein values, GP): each replica contributed mean(local) /
  GLOBAL_BATCH and the replicas were summed, so the value is
  ``n_devices * global_mean / GLOBAL_BATCH`` (``reduce_mean_overall``).

These scale quirks are part of the reference's effective loss weights.

Under data parallelism each of k ranks holds ``GLOBAL_BATCH / k`` samples and
computes its losses with ``LossScales.for_rank(k)``: the global batch of its
share, one device, and ``groups / k`` clDice groups. The mean over the ranks
of each of its terms is then the global program's term (a sum of per-sample
means over the global batch, ``n_devices * global_mean / GLOBAL_BATCH``, a
mean over the groups), so the ranks average their gradients and losses.

Under gradient accumulation (``micro_batches`` = m) each slice computes its
losses with ``LossScales.for_micro(m)``: the same global batch, ``n_devices
/ m`` and ``lambda_topology / m``, the configured clDice groups. Each slice
divides by the whole batch, so the slices' terms SUM to the whole batch's
(per-sample terms exactly, the ``axis=None`` ones because equal slices
partition the batch), except clDice, which each slice groups over its own
samples (JAX's ``micro_scales``, training/step.py:486-504). On rank r of k
the two compose as ``for_rank(k).for_micro(m)``: batch G/k, ``n_devices / (k
m)`` (1/m where k is N_DEVICES), ``lambda_topology / m`` and ``groups / k``
groups; the ranks average and the slices sum, which gives JAX's micro step
on the data mesh (each slice's rows sharded over the devices, clDice grouped
by device within the slice).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from vangan_torch.losses.cldice import soft_dice_cldice_grouped, soft_dice_cldice_loss
from vangan_torch.ops.norms import min_max_norm
from vangan_torch.ops.ssim import ssim3d_loss_map

_BCE_EPS = 1e-7  # keras backend epsilon


@dataclass(frozen=True)
class LossScales:
    """The cross-replica loss-scaling contract and the lambda weights."""

    global_batch_size: int
    n_devices: int
    lambda_cycle: float = 10.0
    lambda_identity: float = 5.0
    lambda_reconstruction: float = 5.0
    lambda_topology: float = 5.0
    cldice_iters: int = 15
    cldice_alpha: float = 0.5
    cldice_groups: Optional[int] = None  # defaults to n_devices
    use_pallas_skeleton: bool = False  # the skeleton kernel (ops.skeleton)

    @property
    def groups(self) -> int:
        return self.cldice_groups if self.cldice_groups is not None else self.n_devices

    def for_rank(self, world: int) -> "LossScales":
        """The scales of one of ``world`` equal shards, whose losses average
        over the ranks to these scales' losses of the whole batch (see the
        module note). ``world`` is ``n_devices`` and divides the batch and
        the groups (``VanGanConfig.rank_batch`` checks them)."""
        return dataclasses.replace(self, global_batch_size=self.global_batch_size // world,
                                   n_devices=self.n_devices // world,
                                   cldice_groups=self.groups // world)

    def for_micro(self, micro: int) -> "LossScales":
        """The scales of one of ``micro`` equal slices of the batch, whose
        losses sum over the slices (see the module note). The clDice groups
        are pinned at these scales' ``groups``: ``n_devices`` becomes a
        fraction, and the default would follow it."""
        return dataclasses.replace(self, n_devices=self.n_devices / micro,
                                   lambda_topology=self.lambda_topology / micro,
                                   cldice_groups=self.groups)

    @classmethod
    def from_config(cls, cfg) -> "LossScales":
        return cls(global_batch_size=cfg.GLOBAL_BATCH_SIZE, n_devices=cfg.N_DEVICES,
                   lambda_cycle=cfg.lambda_cycle, lambda_identity=cfg.lambda_identity,
                   lambda_reconstruction=cfg.lambda_reconstruction,
                   lambda_topology=cfg.lambda_topology, cldice_iters=cfg.cldice_iters,
                   cldice_alpha=cfg.cldice_alpha, cldice_groups=cfg.cldice_groups,
                   use_pallas_skeleton=cfg.use_pallas_skeleton)


def _sample_axes(x: torch.Tensor) -> tuple:
    return tuple(range(1, x.dim()))


def reduce_mean_global(scales: LossScales, x: torch.Tensor) -> torch.Tensor:
    """Sum of per-sample means / global batch (loss_functions.py:8-22)."""
    axes = _sample_axes(x)
    per_sample = torch.mean(x, dim=axes) if axes else x
    return torch.sum(per_sample) / scales.global_batch_size


def reduce_mean_overall(scales: LossScales, x: torch.Tensor) -> torch.Tensor:
    """The summed-over-replicas value of ``reduce_mean(..., axis=None)``."""
    return torch.mean(x) * scales.n_devices / scales.global_batch_size


# --- elementary distances (loss_functions.py:26-83) ---


def MSLE(scales: LossScales, real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    return reduce_mean_global(scales, torch.square(torch.log(real + 1.0) - torch.log(fake + 1.0)))


def MAE(scales: LossScales, y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    return reduce_mean_global(scales, torch.abs(y_true - y_pred))


def MSE(scales: LossScales, y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    return reduce_mean_global(scales, torch.square(y_true - y_pred))


def L4(scales: LossScales, y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    return reduce_mean_global(scales, torch.pow(y_true - y_pred, 4))


def bce_elementwise(y_true: torch.Tensor, y_prob: torch.Tensor) -> torch.Tensor:
    """Keras BinaryCrossentropy on probabilities, reduction NONE: clipped to
    [1e-7, 1 - 1e-7], averaged over the trailing (channel) axis."""
    p = torch.clamp(y_prob, _BCE_EPS, 1.0 - _BCE_EPS)
    bce = -(y_true * torch.log(p) + (1.0 - y_true) * torch.log(1.0 - p))
    return torch.mean(bce, dim=-1)


def _bce_logits(y_true: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    return (torch.clamp_min(logits, 0.0) - logits * y_true
            + torch.log1p(torch.exp(-torch.abs(logits))))


def bce_from_logits(y_true: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Keras BinaryCrossentropy(from_logits=True), reduction NONE."""
    return torch.mean(_bce_logits(y_true, logits), dim=-1)


def bfce_from_logits(y_true: torch.Tensor, logits: torch.Tensor, gamma: float = 2.0
                     ) -> torch.Tensor:
    """Keras BinaryFocalCrossentropy(from_logits=True): gamma 2, no class balancing."""
    p = torch.sigmoid(logits)
    p_t = y_true * p + (1.0 - y_true) * (1.0 - p)
    return torch.mean(torch.pow(1.0 - p_t, gamma) * _bce_logits(y_true, logits), dim=-1)


# --- composite VAN-GAN losses ---


def cycle_loss(scales: LossScales, real_image: torch.Tensor, cycled_image: torch.Tensor,
               typ: Optional[str] = None) -> torch.Tensor:
    """Cycle-consistency loss (loss_functions.py:164-190): None MAE, 'mse',
    'L4' with per-sample reduction; any other type (the 'bce' of the seg cycle)
    is probability BCE on per-sample min-max-normalised volumes with the
    overall-mean quirk. All times lambda_cycle."""
    if typ is None:
        return MAE(scales, real_image, cycled_image) * scales.lambda_cycle
    if typ == "mse":
        return MSE(scales, real_image, cycled_image) * scales.lambda_cycle
    if typ == "L4":
        return L4(scales, real_image, cycled_image) * scales.lambda_cycle
    axes = _sample_axes(real_image)
    real = min_max_norm(real_image, axis=axes)
    cycled = min_max_norm(cycled_image, axis=axes)
    return reduce_mean_overall(scales, bce_elementwise(real, cycled)) * scales.lambda_cycle


def cycle_reconstruction(scales: LossScales, real_image: torch.Tensor,
                         cycled_image: torch.Tensor) -> torch.Tensor:
    """SSIM reconstruction loss on per-sample min-max-normalised volumes
    (loss_functions.py:194-208); overall-mean quirk; times lambda_reconstruction."""
    axes = _sample_axes(real_image)
    loss_map = ssim3d_loss_map(min_max_norm(real_image, axis=axes),
                               min_max_norm(cycled_image, axis=axes), max_val=1.0)
    return reduce_mean_overall(scales, loss_map) * scales.lambda_reconstruction


def cycle_seg_loss(scales: LossScales, real_image: torch.Tensor,
                   cycled_image: torch.Tensor) -> torch.Tensor:
    """Dice + clDice seg cycle loss (loss_functions.py:212-226): lambda_topology
    times the mean of the per-group losses."""
    axes = _sample_axes(real_image)
    per = soft_dice_cldice_grouped(
        min_max_norm(real_image, axis=axes), min_max_norm(cycled_image, axis=axes),
        groups=scales.groups, iters=scales.cldice_iters, alpha=scales.cldice_alpha,
        use_kernel=scales.use_pallas_skeleton)
    return per * scales.lambda_topology


def identity_loss(scales: LossScales, real_image: torch.Tensor, same_image: torch.Tensor,
                  typ: Optional[str] = None) -> torch.Tensor:
    """Identity loss (loss_functions.py:230-252): MAE times lambda_identity, or
    'cldice' on globally min-max-normalised tensors (plain skeleton, as the
    JAX package runs it)."""
    if typ is None:
        return scales.lambda_identity * MAE(scales, real_image, same_image)
    if typ == "cldice":
        loss_fn = soft_dice_cldice_loss(iters=scales.cldice_iters, alpha=scales.cldice_alpha)
        value = loss_fn(min_max_norm(real_image), min_max_norm(same_image))
        return reduce_mean_overall(scales, value) * scales.lambda_identity
    raise ValueError(f"unknown identity loss type {typ!r}")


def generator_loss_fn(scales: LossScales, fake_image: torch.Tensor, typ: Optional[str] = None,
                      from_logits: bool = True) -> torch.Tensor:
    """Adversarial generator loss (loss_functions.py:256-286); the default is
    LSGAN MSE(1, D(fake)) with per-sample reduction."""
    if typ is None:
        return MSE(scales, torch.ones_like(fake_image), fake_image)
    if typ not in ("bce", "bfce"):
        raise ValueError(f"unknown generator loss type {typ!r}")
    fake = fake_image
    if from_logits:
        fn = bce_from_logits if typ == "bce" else bfce_from_logits
    else:
        fake = min_max_norm(fake, axis=_sample_axes(fake))
        fn = bce_elementwise
    return reduce_mean_overall(scales, fn(torch.ones_like(fake), fake))


def discriminator_loss_fn(scales: LossScales, real_image: torch.Tensor,
                          fake_image: torch.Tensor, typ: Optional[str] = None,
                          from_logits: bool = True) -> torch.Tensor:
    """Adversarial discriminator loss (loss_functions.py:290-322); the default
    is LSGAN 0.5 [MSE(1, D(real)) + MSE(0, D(fake))] with per-sample reduction."""
    if typ is None:
        return 0.5 * (MSE(scales, torch.ones_like(real_image), real_image)
                      + MSE(scales, torch.zeros_like(fake_image), fake_image))
    real, fake = real_image, fake_image
    if not from_logits:
        real, fake = min_max_norm(real), min_max_norm(fake)
        fn = bce_elementwise
    else:
        fn = bce_from_logits if typ == "bce" else bfce_from_logits
    loss = (fn(torch.ones_like(real), real) + fn(torch.zeros_like(fake), fake)) * 0.5
    return reduce_mean_overall(scales, loss)


def wasserstein_generator_loss(scales: LossScales, prob_fake_is_real: torch.Tensor
                               ) -> torch.Tensor:
    """-E[D(fake)] with the axis=None quirk (loss_functions.py:341-355)."""
    return -reduce_mean_overall(scales, prob_fake_is_real)


def wasserstein_discriminator_loss(scales: LossScales, prob_real_is_real: torch.Tensor,
                                   prob_fake_is_real: torch.Tensor) -> torch.Tensor:
    """-E[D(real) - D(fake)] with the axis=None quirk (loss_functions.py:325-338)."""
    return -reduce_mean_overall(scales, prob_real_is_real - prob_fake_is_real)


def gradient_penalty(scales: LossScales, disc_apply: Callable[[torch.Tensor], torch.Tensor],
                     real: torch.Tensor, fake: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
    """WGAN-GP (vangan.py:355-378), as the JAX package computes it
    (vangan_losses.py:254-281): interpolation weights alpha ~ *Normal*, one per
    sample, drawn from ``generator`` unless given; ``interp = real + alpha
    (fake - real)`` with the fake detached; the input gradient of
    ``disc_apply(interp).sum()``, kept differentiable (``create_graph``);
    its norm over each sample with the 1e-12 inside the root; then
    ``(norm - 1)^2`` with the axis=None quirk. The caller passes the critic
    that matches the domain (the reference routes both through disc_S)."""
    shape = (real.shape[0],) + (1,) * (real.dim() - 1)
    if alpha is None:
        alpha = torch.randn(shape, generator=generator, device=real.device, dtype=real.dtype)
    interp = (real + alpha.reshape(shape) * (fake.detach() - real)).detach().requires_grad_()
    with torch.enable_grad():
        grads, = torch.autograd.grad(disc_apply(interp).sum(), interp, create_graph=True)
    norm = torch.sqrt(grads.square().sum(dim=_sample_axes(grads)) + 1.0e-12)
    return reduce_mean_overall(scales, (norm - 1.0) ** 2)
