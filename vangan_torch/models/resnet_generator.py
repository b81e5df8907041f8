"""CycleGAN-style 3-D ResNet generator (generator.py:7-73).

Counterpart of ``vangan_tpu.models.resnet_generator.ResNetGenerator3D``, the
shape-preserving form the JAX package builds (see its module note): a 7^3
reflect-padded stem conv + InstanceNorm (he_normal gamma) + ReLU + spatial
dropout, stride-2 3^3 reflect-padded downsampling convs (each + IN + ReLU +
spatial dropout), identity residual blocks, nearest upsample + 4^3 'same'
conv (TF SAME: pads (1, 2) per axis) + IN + ReLU, and a 7^3 reflect-padded
tanh head with bias.

Public input and output keep the JAX layout ``(B, X, Y, Z, 1)``; inside, the
model runs on ``(B, C, X, Y, Z)``. It computes in ``dtype`` and returns
float32. Dropout acts only with ``train``, drawing from the ``generator``
passed to the call.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from vangan_torch.models.layers import (
    ConvND,
    CycleGANResidualBlock,
    InstanceNorm,
    KernelSwitch,
    spatial_dropout,
    uniform_pads,
    upsample_nearest,
)


class ResNetGenerator3D(KernelSwitch, nn.Module):
    def __init__(self, filters: int = 32, num_downsampling_blocks: int = 2,
                 num_residual_blocks: int = 6, num_upsample_blocks: int = 2,
                 stem_dropout: float = 0.5, downsample_dropout: float = 0.2,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_downsampling_blocks = num_downsampling_blocks
        self.num_residual_blocks = num_residual_blocks
        self.num_upsample_blocks = num_upsample_blocks
        self.stem_dropout = stem_dropout
        self.downsample_dropout = downsample_dropout
        self.dtype = dtype
        g = generator
        f = filters
        self.stem_conv = ConvND(1, f, 7, 1, padding=uniform_pads(3), pad_mode="reflect",
                                use_bias=False, generator=g)
        self.stem_inorm = InstanceNorm(f, act="relu", gamma_init="he_normal", generator=g)
        for i in range(num_downsampling_blocks):
            setattr(self, f"down{i}", ConvND(f, 2 * f, 3, 2, padding=uniform_pads(1),
                                             pad_mode="reflect", use_bias=False, generator=g))
            f *= 2
            setattr(self, f"down_inorm{i}", InstanceNorm(f, act="relu", gamma_init="he_normal",
                                                         generator=g))
        for i in range(num_residual_blocks):
            setattr(self, f"res{i}", CycleGANResidualBlock(f, generator=g))
        for i in range(num_upsample_blocks):
            setattr(self, f"up{i}", ConvND(f, f // 2, 4, 1, padding="same", use_bias=False,
                                           generator=g))
            f //= 2
            setattr(self, f"up_inorm{i}", InstanceNorm(f, act="relu", gamma_init="he_normal",
                                                       generator=g))
        self.head = ConvND(f, 1, 7, 1, padding=uniform_pads(3), pad_mode="reflect",
                           use_bias=True, generator=g)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, X, Y, Z, c = x.shape
        if c != 1:
            raise ValueError(f"ResNetGenerator3D takes one input channel, got shape "
                             f"{tuple(x.shape)}")
        x = x.to(self.dtype).reshape(b, 1, X, Y, Z)
        x = self.stem_inorm(self.stem_conv(x))
        x = spatial_dropout(x, self.stem_dropout, train, generator)
        for i in range(self.num_downsampling_blocks):
            x = getattr(self, f"down_inorm{i}")(getattr(self, f"down{i}")(x))
            x = spatial_dropout(x, self.downsample_dropout, train, generator)
        for i in range(self.num_residual_blocks):
            x = getattr(self, f"res{i}")(x)
        for i in range(self.num_upsample_blocks):
            x = getattr(self, f"up_inorm{i}")(getattr(self, f"up{i}")(upsample_nearest(x, 2)))
        return torch.tanh(self.head(x).reshape(b, X, Y, Z, 1).float())
