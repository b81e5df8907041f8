"""Deep residual 3-D U-Net generator — the default VAN-GAN generator.

Counterpart of ``vangan_tpu.models.resunet.ResUNet3D`` (resunet_model.py:
185-249): filter ladder ``[f, 2f, 4f, 8f, 16f]``, stem, ``num_layers``
stride-2 pre-activation residual encoder blocks, a two-block bridge,
nearest-upsample + concat ``[upsampled, skip]`` + residual decoder blocks and
a 1^3 tanh head, as the factory builds it (no dropout or input noise: the
generators serve without them). Public input and output keep the JAX layout
``(B, X, Y, Z, 1)``; inside, the model runs on ``(B, C, X, Y, Z)``, which for
C = 1 is a reshape. It computes in ``dtype`` and returns float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from vangan_torch.models.layers import (
    ConvND,
    KernelSwitch,
    PreActConvBlock,
    ResUNetResidualBlock,
    Stem,
    upsample_nearest,
)


class ResUNet3D(KernelSwitch, nn.Module):
    def __init__(self, filters: int = 16, num_layers: int = 4,
                 upsample_mode: str = "simple", use_attention_gate: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if upsample_mode != "simple":
            raise NotImplementedError(
                f"upsample_mode={upsample_mode!r} is not ported yet "
                "(ROADMAP.md Queue 1, other families and modes)")
        if use_attention_gate:
            raise NotImplementedError(
                "use_attention_gate=True is not ported yet "
                "(ROADMAP.md Queue 1, other families and modes)")
        self.num_layers = num_layers
        self.dtype = dtype
        f = [filters * 2**i for i in range(num_layers + 1)]
        g = generator
        self.stem = Stem(1, f[0], generator=g)
        for e in range(1, num_layers + 1):
            setattr(self, f"enc{e}", ResUNetResidualBlock(f[e - 1], f[e], strides=2, generator=g))
        self.bridge1 = PreActConvBlock(f[-1], f[-1], use_bias=False, generator=g)
        self.bridge2 = PreActConvBlock(f[-1], f[-1], generator=g)
        for d in reversed(range(num_layers)):
            setattr(self, f"dec{d}", ResUNetResidualBlock(f[d + 1] + f[d], f[d], generator=g))
        self.head = ConvND(f[0], 1, 1, 1, padding="same", use_bias=True, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, X, Y, Z, c = x.shape
        if c != 1:
            raise ValueError(f"ResUNet3D takes one input channel, got shape {tuple(x.shape)}")
        x = x.to(self.dtype).reshape(b, 1, X, Y, Z)
        x = self.stem(x)
        skips = [x]
        for e in range(1, self.num_layers + 1):
            x = getattr(self, f"enc{e}")(x)
            skips.append(x)
        x = self.bridge2(self.bridge1(x))
        for d in reversed(range(self.num_layers)):
            x = torch.cat([upsample_nearest(x, 2), skips[d]], dim=1)
            x = getattr(self, f"dec{d}")(x)
        return torch.tanh(self.head(x).reshape(b, X, Y, Z, 1).float())
