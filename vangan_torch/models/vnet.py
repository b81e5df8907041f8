"""Customisable V-Net / 3-D U-Net generator (vnet_model.py:149-268).

Counterpart of ``vangan_tpu.models.vnet.VNet3D``: two-conv blocks per level,
max-pool downsampling, 2^3 stride-2 ``ConvTranspose`` ('deconv') or nearest
upsample + 3^3 zero-padded 'same' conv ('simple') upsampling, optional
attention-gated skips and a 1^3 head. The reference's quirk is kept: each
conv's ReLU comes *before* the norm (vnet_model.py:119-130), so an
InstanceNorm runs with no activation epilogue and the ReLU is its own op.
The i2s role uses InstanceNorm and biased convs, the s2i role BatchNorm
(running statistics in buffers) and convs without bias.

Public input and output keep the JAX layout ``(B, X, Y, Z, 1)``; inside, the
model runs on ``(B, C, X, Y, Z)``. With ``dims=2`` it is the 2-D network on
``(B, H, W, 1)`` images, run as depth-1 volumes. It computes in ``dtype`` and returns
float32. ``train`` selects the batch statistics of BatchNorm (and moves its
buffers) and turns dropout on, which draws from the ``generator`` passed to
the call.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from vangan_torch.models.layers import (
    AttentionConcat,
    BatchNorm,
    ConvND,
    ConvTranspose,
    InstanceNorm,
    KernelSwitch,
    from_volume,
    make_dropout,
    max_pool_2x,
    to_volume,
    uniform_pads,
    upsample_nearest,
)


class VNetConvBlock(nn.Module):
    """Two reflect-padded 3^3 convs, each conv -> ReLU -> norm, with dropout
    after the first (vnet.py:45-83)."""

    def __init__(self, in_channels: int, filters: int, use_batch_norm: bool = True,
                 dropout: float = 0.3, dropout_type: str = "spatial",
                 generator: Optional[torch.Generator] = None, dims: int = 3):
        super().__init__()
        self.use_batch_norm = use_batch_norm
        for i, ci in enumerate((in_channels, filters)):
            setattr(self, f"conv{i}", ConvND(ci, filters, 3, 1, padding=uniform_pads(1, dims),
                                             pad_mode="reflect", use_bias=not use_batch_norm,
                                             generator=generator, dims=dims))
            if use_batch_norm:
                setattr(self, f"bn{i}", BatchNorm(filters))
            else:
                setattr(self, f"in{i}", InstanceNorm(filters))
        self.dropout = make_dropout(dropout_type, dropout) if dropout > 0.0 else None

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(2):
            x = F.relu(getattr(self, f"conv{i}")(x))
            if self.use_batch_norm:
                x = getattr(self, f"bn{i}")(x, train)
            else:
                x = getattr(self, f"in{i}")(x)
            if i == 0 and self.dropout is not None:
                x = self.dropout(x, train=train, generator=generator)
        return x


class VNet3D(KernelSwitch, nn.Module):
    """V-Net generator (vnet.py:86-178) as the factory configures it: one
    output class with tanh, the same dropout rate in every encoder block and
    the bottleneck, none on the upsampling side."""

    def __init__(self, use_batch_norm: bool = True, upsample_mode: str = "deconv",
                 dropout: float = 0.5, dropout_type: str = "spatial",
                 use_attention_gate: bool = False, filters: int = 16, num_layers: int = 4,
                 addnoise: bool = False, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, dims: int = 3):
        super().__init__()
        if addnoise:
            # the JAX package draws it from PRNGKey(0) at eval time (vnet.py:104-113)
            raise NotImplementedError("addnoise=True (the V-Net's input noise) is not ported "
                                      "yet (ROADMAP.md Queue 1, other families and modes)")
        if upsample_mode not in ("deconv", "simple"):
            raise ValueError(f"upsample_mode must be 'deconv' or 'simple', got {upsample_mode!r}")
        self.num_layers = num_layers
        self.upsample_mode = upsample_mode
        self.use_attention_gate = use_attention_gate
        self.dtype = dtype
        self.dims = dims
        kw = dict(generator=generator, dims=dims)
        block = dict(use_batch_norm=use_batch_norm, dropout_type=dropout_type, **kw)
        ci, f = 1, filters
        for layer in range(num_layers):
            setattr(self, f"down{layer}", VNetConvBlock(ci, f, dropout=dropout, **block))
            ci, f = f, 2 * f
        self.bottleneck = VNetConvBlock(ci, f, dropout=dropout, **block)
        for i in range(num_layers):
            ci, f = f, f // 2
            if upsample_mode == "deconv":
                setattr(self, f"deconv{i}", ConvTranspose(ci, f, 2, 2, **kw))
            else:
                setattr(self, f"upconv{i}", ConvND(ci, f, 3, 1, padding="same", **kw))
            if use_attention_gate:
                setattr(self, f"attn{i}", AttentionConcat(f, f, **kw))
            setattr(self, f"up{i}", VNetConvBlock(2 * f, f, dropout=0.0, **block))
        self.head = ConvND(f, 1, 1, 1, padding="same", **kw)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = to_volume(x.to(self.dtype), self.dims, "VNet3D")
        skips = []
        for layer in range(self.num_layers):
            x = getattr(self, f"down{layer}")(x, train, generator)
            skips.append(x)
            x = max_pool_2x(x, self.dims)
        x = self.bottleneck(x, train, generator)
        for i, skip in enumerate(reversed(skips)):
            if self.upsample_mode == "deconv":
                x = getattr(self, f"deconv{i}")(x)
            else:
                x = getattr(self, f"upconv{i}")(upsample_nearest(x, 2, self.dims))
            if self.use_attention_gate:
                x = getattr(self, f"attn{i}")(x, skip)
            else:
                x = torch.cat([x, skip], dim=1)
            x = getattr(self, f"up{i}")(x, train, generator)
        return torch.tanh(from_volume(self.head(x), self.dims).float())
