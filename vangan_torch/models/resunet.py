"""Deep residual 3-D U-Net generator — the default VAN-GAN generator.

Counterpart of ``vangan_tpu.models.resunet.ResUNet3D`` (resunet_model.py:
185-249): filter ladder ``[f, 2f, 4f, 8f, 16f]``, stem, ``num_layers``
stride-2 pre-activation residual encoder blocks, a two-block bridge,
upsample + concat ``[upsampled, skip]`` + residual decoder blocks and a 1^3
head, with the JAX package's options and defaults. ``upsample_mode``:
``"deconv"`` (a 2^3 stride-2 ``ConvTranspose``, he_normal init, as
resunet.py:94-107) or ``"simple"`` (nearest upsample, what the factory
builds); ``use_attention_gate`` concatenates the upsampled features with an
attention-gated skip (``AttentionConcat``). In training,
``use_input_noise`` adds Gaussian noise of σ 0.2 to the input, and encoder
block e applies ``dropout_type`` dropout (``"spatial"``, ``"standard"`` or
``"none"``) of rate ``dropout + (e - 1) dropout_change_per_layer`` to its
output, both drawn from the generator passed to the call; the factory's
generators have neither. ``output_activation`` is ``"tanh"``, ``"sigmoid"``
or None. Public input and output keep the JAX layout ``(B, X, Y, Z, 1)``;
inside, the model runs on ``(B, C, X, Y, Z)``, which for C = 1 is a
reshape. With ``dims=2`` (the DIMENSIONS=2 mode) it is the 2-D network on
``(B, H, W, 1)`` images, run as depth-1 volumes (``layers.spatial``). It
computes in ``dtype`` and returns float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from vangan_torch.models.layers import (
    AttentionConcat,
    ConvND,
    ConvTranspose,
    GaussianNoise,
    KernelSwitch,
    PreActConvBlock,
    ResUNetResidualBlock,
    Stem,
    from_volume,
    head_activation,
    to_volume,
    upsample_nearest,
)


class ResUNet3D(KernelSwitch, nn.Module):
    def __init__(self, filters: int = 16, num_layers: int = 4,
                 upsample_mode: str = "deconv", use_attention_gate: bool = False,
                 dropout: float = 0.2, dropout_change_per_layer: float = 0.0,
                 dropout_type: Optional[str] = "none",
                 output_activation: Optional[str] = "tanh", use_input_noise: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, dims: int = 3):
        super().__init__()
        if upsample_mode not in ("deconv", "simple"):
            raise ValueError(f"upsample_mode must be 'deconv' or 'simple', got {upsample_mode!r}")
        self.dims = dims
        self.num_layers = num_layers
        self.upsample_mode = upsample_mode
        self.use_attention_gate = use_attention_gate
        self.activation = head_activation(output_activation)
        self.input_noise = GaussianNoise(0.2) if use_input_noise else None
        self.dtype = dtype
        f = [filters * 2**i for i in range(num_layers + 1)]
        kw = dict(generator=generator, dims=dims)
        self.stem = Stem(1, f[0], **kw)
        for e in range(1, num_layers + 1):
            setattr(self, f"enc{e}", ResUNetResidualBlock(
                f[e - 1], f[e], strides=2, dropout_type=dropout_type,
                dropout=dropout + (e - 1) * dropout_change_per_layer, **kw))
        self.bridge1 = PreActConvBlock(f[-1], f[-1], use_bias=False, **kw)
        self.bridge2 = PreActConvBlock(f[-1], f[-1], **kw)
        for d in reversed(range(num_layers)):
            if upsample_mode == "deconv":
                setattr(self, f"deconv{d}", ConvTranspose(f[d + 1], f[d + 1], 2, 2,
                                                          kernel_init="he_normal", **kw))
            if use_attention_gate:
                setattr(self, f"attn{d}", AttentionConcat(f[d + 1], f[d], **kw))
            setattr(self, f"dec{d}", ResUNetResidualBlock(f[d + 1] + f[d], f[d], **kw))
        self.head = ConvND(f[0], 1, 1, 1, padding="same", use_bias=True, **kw)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``train`` turns the input noise and the encoder's dropout on,
        drawn from ``generator``."""
        x = x.to(self.dtype)
        if self.input_noise is not None:
            x = self.input_noise(x, train, generator=generator)
        x = to_volume(x, self.dims, "ResUNet3D")
        x = self.stem(x)
        skips = [x]
        for e in range(1, self.num_layers + 1):
            x = getattr(self, f"enc{e}")(x, train, generator)
            skips.append(x)
        x = self.bridge2(self.bridge1(x))
        for d in reversed(range(self.num_layers)):
            if self.upsample_mode == "deconv":
                x = getattr(self, f"deconv{d}")(x)
            else:
                x = upsample_nearest(x, 2, self.dims)
            if self.use_attention_gate:
                x = getattr(self, f"attn{d}")(x, skips[d])
            else:
                x = torch.cat([x, skips[d]], dim=1)
            x = getattr(self, f"dec{d}")(x)
        return self.activation(from_volume(self.head(x), self.dims).float())
