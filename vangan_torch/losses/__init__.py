"""The VAN-GAN losses in torch (counterpart of ``vangan_tpu.losses``)."""

from vangan_torch.losses.cldice import (  # noqa: F401
    soft_clDice_loss,
    soft_dice,
    soft_dice_cldice_grouped,
    soft_dice_cldice_loss,
)
from vangan_torch.losses.vangan_losses import (  # noqa: F401
    L4,
    MAE,
    MSE,
    MSLE,
    LossScales,
    bce_elementwise,
    bce_from_logits,
    bfce_from_logits,
    cycle_loss,
    cycle_reconstruction,
    cycle_seg_loss,
    discriminator_loss_fn,
    generator_loss_fn,
    gradient_penalty,
    identity_loss,
    reduce_mean_global,
    reduce_mean_overall,
    wasserstein_discriminator_loss,
    wasserstein_generator_loss,
)
