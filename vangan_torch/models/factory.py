"""Model factory: the network configurations of ``vangan_tpu.models.factory``."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from vangan_torch.models.discriminator import PatchGANDiscriminator3D
from vangan_torch.models.resnet_generator import ResNetGenerator3D
from vangan_torch.models.resunet import ResUNet3D
from vangan_torch.models.vnet import VNet3D


def compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype in ("bfloat16", "bf16") else torch.float32


def build_generator(kind: str, cfg, role: str = "i2s",
                    generator: Optional[torch.Generator] = None) -> nn.Module:
    """Build a generator ('i2s' imaging->segmentation or 's2i'), as
    vangan.py:88-164 configures it (``vangan_tpu.models.factory``): 'resUnet',
    'vnet' (the s2i V-Net with BatchNorm, deconv upsampling and f filters;
    the i2s V-Net with InstanceNorm, nearest upsampling and 2f) or 'resnet'.
    Parameters are drawn from ``generator``. Each is called as
    ``net(x, train=False, generator=None)``."""
    if role not in ("i2s", "s2i"):
        raise ValueError(f"role must be 'i2s' or 's2i', got {role!r}")
    dtype, f = compute_dtype(cfg), cfg.gen_filters
    if kind == "resnet":
        return ResNetGenerator3D(filters=2 * f, num_downsampling_blocks=3,
                                 num_residual_blocks=6, num_upsample_blocks=3, dtype=dtype,
                                 generator=generator)
    if kind == "vnet":
        i2s = role == "i2s"
        return VNet3D(use_batch_norm=not i2s, upsample_mode="simple" if i2s else "deconv",
                      dropout=0.5, dropout_type="spatial", use_attention_gate=False,
                      filters=2 * f if i2s else f, num_layers=4, addnoise=False, dtype=dtype,
                      generator=generator)
    if kind == "resUnet":
        return ResUNet3D(filters=f, num_layers=4, upsample_mode="simple",
                         use_attention_gate=False, dtype=dtype, generator=generator)
    raise ValueError(f"Generator type not recognised: {kind!r}")


def build_discriminator(cfg, generator: Optional[torch.Generator] = None
                        ) -> PatchGANDiscriminator3D:
    """PatchGAN discriminator with the VanGan defaults (vangan.py:167-192):
    input and layer noise of σ ``cfg.layer_noise``, spatial dropout 0.2, no
    spectral norm; parameters are drawn from ``generator``."""
    return PatchGANDiscriminator3D(
        filters=cfg.disc_filters, use_dropout=True, dropout_rate=0.2,
        wasserstein=cfg.wasserstein, use_SN=False, use_input_noise=True,
        use_layer_noise=True, noise_std=cfg.layer_noise, dtype=compute_dtype(cfg),
        generator=generator)
