"""Customisable V-Net / 3-D U-Net generator (vnet_model.py:149-268).

Counterpart of ``vangan_tpu.models.vnet.VNet3D``: two-conv blocks per level,
max-pool downsampling, 2^3 stride-2 ``ConvTranspose`` ('deconv') or nearest
upsample + 3^3 zero-padded 'same' conv ('simple') upsampling, optional
attention-gated skips and a 1^3 head. The reference's quirk is kept: each
conv's ReLU comes *before* the norm (vnet_model.py:119-130), so an
InstanceNorm runs with no activation epilogue and the ReLU is its own op.
The i2s role uses InstanceNorm and biased convs, the s2i role BatchNorm
(running statistics in buffers) and convs without bias.

Public input is ``(B, X, Y, Z, 1)`` and output ``(B, X, Y, Z, num_classes)``,
the JAX layout; inside, the model runs on ``(B, C, X, Y, Z)``. With
``dims=2`` it is the 2-D network on ``(B, H, W, 1)`` images, run as depth-1
volumes. It computes in ``dtype`` and returns float32. ``train`` selects the
batch statistics of BatchNorm (and moves its buffers) and turns dropout on,
which draws from the ``generator`` passed to the call.

With ``addnoise`` the input goes through the reference's noise branch
(vnet_model.py:203-209, vnet.py:104-113 of the JAX package): per-sample
min-max normalised, plus ``-0.475 + 0.06 N(0, 1)``, plus the input, clipped
to [0, 1] and mapped to [-1, 1]. In training N is drawn from the call's
generator; in eval the JAX package draws it from ``PRNGKey(0)``, a stream
torch cannot reproduce, so the port draws it from a generator seeded 0: a
fixed tensor per shape and device, of the same distribution.
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
    head_activation,
    make_dropout,
    max_pool_2x,
    to_volume,
    uniform_pads,
    upsample_nearest,
)
from vangan_torch.ops.norms import min_max_norm, rescale_arr


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
    """V-Net generator (vnet.py:86-178) with the JAX package's options and
    defaults: ``num_classes`` output channels, ``output_activation``
    (``"sigmoid"``, ``"tanh"`` or None), dropout of rate ``dropout + l
    dropout_change_per_layer`` in encoder block l and the bottleneck's rate
    ``dropout + num_layers dropout_change_per_layer``; with
    ``use_dropout_on_upsampling`` the decoder's rate starts from the
    bottleneck's and drops by the change before each up block, else the up
    blocks have none; and the ``addnoise`` input branch (module note)."""

    def __init__(self, use_batch_norm: bool = True, upsample_mode: str = "deconv",
                 dropout: float = 0.5, dropout_type: str = "spatial",
                 use_attention_gate: bool = False, filters: int = 16, num_layers: int = 4,
                 addnoise: bool = False, num_classes: int = 1,
                 output_activation: Optional[str] = "sigmoid",
                 dropout_change_per_layer: float = 0.0,
                 use_dropout_on_upsampling: bool = False, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, dims: int = 3):
        super().__init__()
        if upsample_mode not in ("deconv", "simple"):
            raise ValueError(f"upsample_mode must be 'deconv' or 'simple', got {upsample_mode!r}")
        self.num_layers = num_layers
        self.upsample_mode = upsample_mode
        self.use_attention_gate = use_attention_gate
        self.addnoise = addnoise
        self.activation = head_activation(output_activation)
        self.dtype = dtype
        self.dims = dims
        kw = dict(generator=generator, dims=dims)
        block = dict(use_batch_norm=use_batch_norm, dropout_type=dropout_type, **kw)
        ci, f, rate = 1, filters, dropout
        for layer in range(num_layers):
            setattr(self, f"down{layer}", VNetConvBlock(ci, f, dropout=rate, **block))
            ci, f, rate = f, 2 * f, rate + dropout_change_per_layer
        self.bottleneck = VNetConvBlock(ci, f, dropout=rate, **block)
        # the decoder's rates, as vnet.py:137-149 keeps them
        change = dropout_change_per_layer if use_dropout_on_upsampling else 0.0
        if not use_dropout_on_upsampling:
            rate = 0.0
        for i in range(num_layers):
            ci, f, rate = f, f // 2, rate - change
            if upsample_mode == "deconv":
                setattr(self, f"deconv{i}", ConvTranspose(ci, f, 2, 2, **kw))
            else:
                setattr(self, f"upconv{i}", ConvND(ci, f, 3, 1, padding="same", **kw))
            if use_attention_gate:
                setattr(self, f"attn{i}", AttentionConcat(f, f, **kw))
            setattr(self, f"up{i}", VNetConvBlock(2 * f, f, dropout=rate, **block))
        self.head = ConvND(f, num_classes, 1, 1, padding="same", **kw)

    def standard_normal(self, x: torch.Tensor, train: bool,
                        generator: Optional[torch.Generator]) -> torch.Tensor:
        """The N(0, 1) draw of the ``addnoise`` branch, of ``x``'s shape, dtype
        and device: from ``generator`` in training, else from a generator
        seeded 0 (the module note)."""
        if not train:
            generator = torch.Generator(device=x.device).manual_seed(0)
        elif generator is None:
            raise ValueError("VNet3D's addnoise in training draws from an explicit "
                             "torch.Generator; pass generator=")
        return torch.randn(x.shape, dtype=x.dtype, device=x.device, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.addnoise:
            noise = -0.475 + 0.06 * self.standard_normal(x, train, generator)
            x = min_max_norm(x, axis=tuple(range(1, x.dim()))) + noise + x
            x = rescale_arr(torch.clamp(x, 0.0, 1.0), -0.5, 0.5)
        x = to_volume(x, self.dims, "VNet3D")
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
        return self.activation(from_volume(self.head(x), self.dims).float())
