"""Model factory: the network configurations of ``vangan_tpu.models.factory``."""

from __future__ import annotations

from typing import Optional

import torch

from vangan_torch.models.discriminator import PatchGANDiscriminator3D
from vangan_torch.models.resunet import ResUNet3D


def compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype in ("bfloat16", "bf16") else torch.float32


def build_generator(kind: str, cfg, role: str = "i2s",
                    generator: Optional[torch.Generator] = None) -> ResUNet3D:
    """Build a generator ('i2s' imaging->segmentation or 's2i'), as
    vangan.py:88-164 configures it; parameters are drawn from ``generator``."""
    if role not in ("i2s", "s2i"):
        raise ValueError(f"role must be 'i2s' or 's2i', got {role!r}")
    if kind == "resUnet":
        return ResUNet3D(filters=cfg.gen_filters, num_layers=4, upsample_mode="simple",
                         use_attention_gate=False, dtype=compute_dtype(cfg),
                         generator=generator)
    if kind in ("resnet", "vnet"):
        raise NotImplementedError(
            f"generator {kind!r} is not ported yet "
            "(ROADMAP.md Queue 1, other families and modes)")
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
