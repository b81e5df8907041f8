"""torch building blocks of the ResU-Net generator and the PatchGAN discriminator.

Counterparts of ``vangan_tpu.models.layers`` on torch's ``(B, C, X, Y, Z)``
layout. Submodules carry the flax names (``conv``, ``norm_act.inorm``,
``shortcut``, ...) and parameters are created in flax's shapes, so a flax
parameter tree maps onto ``state_dict`` by a rename and a transpose
(``vangan_torch.weights``). Parameters are float32; a conv runs in its input's
dtype (the compute dtype) with the weight cast to it, and InstanceNorm keeps
its statistics in float32.

Each ``ConvND`` and ``InstanceNorm`` has a ``use_kernels`` switch: True (the
default) sends the op to the hand-written kernels where the JAX package sends
it to Pallas (convs with ``max(Ci, Co) < 128``; every InstanceNorm), forward
and, where a gradient is needed, backward; False runs the plain torch version
and its autograd everywhere, for comparing the two on the card.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from vangan_torch.ops.conv3d import conv3d, conv3d_plain, norm_padding, norm_stride
from vangan_torch.ops.instnorm import instance_norm_act, instance_norm_act_plain

# Convs at or above this channel count go to torch (cuDNN), as the JAX package
# sends them to XLA (vangan_tpu/models/layers.py ConvND._plain_conv).
KERNEL_MAX_CHANNELS = 128


def he_normal_(t: torch.Tensor, fan_in: int,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Keras/flax he_normal: truncated normal in [-2, 2] std, std corrected
    so the truncated distribution has variance 2 / fan_in."""
    std = (2.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def uniform_pads(p: int) -> Tuple[Tuple[int, int], ...]:
    return ((p, p),) * 3


class KernelSwitch:
    """``set_use_kernels`` for a network of ``ConvND`` / ``InstanceNorm`` layers."""

    def set_use_kernels(self, enabled: bool):
        """Route every conv and InstanceNorm through the hand-written kernels
        (True, the default) or through the plain torch versions (False)."""
        for m in self.modules():
            if hasattr(m, "use_kernels"):
                m.use_kernels = enabled
        return self


class ConvND(nn.Module):
    """3-D conv with flax ``nn.Conv`` parameters (``weight`` in torch's
    (Co, Ci, kx, ky, kz), optional ``bias``), padding 'same' | 'valid' |
    explicit widths, ``pad_mode`` 'zeros' | 'reflect'."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Union[int, Sequence[int]] = 3,
                 strides: Union[int, Sequence[int]] = 1, padding="same",
                 pad_mode: str = "zeros", use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        k = (kernel_size,) * 3 if isinstance(kernel_size, int) else tuple(kernel_size)
        self.kernel_size = k
        self.strides = norm_stride(strides)
        self.padding = padding
        self.pad_mode = pad_mode
        self.use_kernels = True
        w = torch.empty(features, in_channels, *k)
        self.weight = nn.Parameter(he_normal_(w, in_channels * k[0] * k[1] * k[2], generator))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        co, ci = self.weight.shape[:2]
        if self.use_kernels and max(ci, co) < KERNEL_MAX_CHANNELS:
            return conv3d(x, self.weight, self.bias, self.strides, self.padding,
                          self.pad_mode)
        pads = norm_padding(self.padding, self.kernel_size, self.strides, x.shape[2:])
        return conv3d_plain(x, self.weight, self.bias, self.strides, pads, self.pad_mode)


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalisation over X, Y, Z (eps 1e-3, learned
    ``weight`` = flax ``scale`` and ``bias``) with an activation epilogue."""

    def __init__(self, channels: int, act: str = "none", epsilon: float = 1e-3,
                 leaky_slope: float = 0.2):
        super().__init__()
        self.act = act
        self.epsilon = epsilon
        self.leaky_slope = leaky_slope
        self.use_kernels = True
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fn = instance_norm_act if self.use_kernels else instance_norm_act_plain
        return fn(x, self.weight, self.bias, self.epsilon, self.act, self.leaky_slope)


class NormAct(nn.Module):
    """InstanceNorm followed by an optional ReLU (resunet_model.py:23-39)."""

    def __init__(self, channels: int, act: bool = True):
        super().__init__()
        self.inorm = InstanceNorm(channels, act="relu" if act else "none")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.inorm(x)


class PreActConvBlock(nn.Module):
    """norm-act -> reflect-padded conv (resunet_model.py:42-66). ``use_bias``
    is False where the conv feeds another InstanceNorm, which cancels a bias
    exactly (the JAX package's dead-bias rule)."""

    def __init__(self, in_channels: int, filters: int, kernel_size: int = 3,
                 strides: int = 1, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm_act = NormAct(in_channels)
        self.conv = ConvND(in_channels, filters, kernel_size, strides,
                           padding=uniform_pads(kernel_size // 2), pad_mode="reflect",
                           use_bias=use_bias, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(self.norm_act(x))


class Stem(nn.Module):
    """ResU-Net stem: conv + pre-act conv block + 1^3-projected identity
    (resunet_model.py:69-100)."""

    def __init__(self, in_channels: int, filters: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = ConvND(in_channels, filters, 3, 1, padding=uniform_pads(1),
                            pad_mode="reflect", use_bias=False, generator=generator)
        self.conv_block = PreActConvBlock(filters, filters, generator=generator)
        self.shortcut = ConvND(in_channels, filters, 1, 1, padding="same", use_bias=False,
                               generator=generator)
        self.shortcut_norm = NormAct(filters, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_block(self.conv1(x)) + self.shortcut_norm(self.shortcut(x))


class ResUNetResidualBlock(nn.Module):
    """Pre-activation residual block with projected shortcut
    (resunet_model.py:103-143); the generators serve with no dropout."""

    def __init__(self, in_channels: int, filters: int, strides: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.block1 = PreActConvBlock(in_channels, filters, strides=strides,
                                      use_bias=False, generator=generator)
        self.block2 = PreActConvBlock(filters, filters, generator=generator)
        self.shortcut = ConvND(in_channels, filters, 1, strides, padding="same",
                               use_bias=False, generator=generator)
        self.shortcut_norm = NormAct(filters, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.shortcut_norm(self.shortcut(x)) + self.block2(self.block1(x))


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Keras UpSampling3D (nearest-neighbour repeat) on (B, C, X, Y, Z)."""
    return F.interpolate(x, scale_factor=factor, mode="nearest")


def _need_generator(generator: Optional[torch.Generator], what: str) -> torch.Generator:
    if generator is None:
        raise ValueError(f"{what} in training draws from an explicit torch.Generator; "
                         "pass generator=")
    return generator


class GaussianNoise(nn.Module):
    """Additive Gaussian noise, active only in training (layers.py:308-327).

    σ is given on each call (the epoch schedule of the discriminator noise);
    ``stddev`` is the default. In eval, or at σ = 0, it returns ``x`` itself.
    """

    def __init__(self, stddev: float = 0.1):
        super().__init__()
        self.stddev = stddev

    def forward(self, x: torch.Tensor, train: bool = False, stddev: Optional[float] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        std = self.stddev if stddev is None else stddev
        if not train or std == 0:
            return x
        noise = torch.randn(x.shape, dtype=x.dtype, device=x.device,
                            generator=_need_generator(generator, "GaussianNoise"))
        return x + std * noise


def spatial_dropout(x: torch.Tensor, rate: float, train: bool = False,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Keras SpatialDropout3D on (B, C, X, Y, Z) (layers.py:330-335): in
    training each (b, c) channel is dropped whole with probability ``rate``
    and kept ones are scaled by 1 / (1 - rate), as flax ``nn.Dropout`` with the
    spatial axes broadcast does."""
    if not train or rate == 0:
        return x
    keep = 1.0 - rate
    u = torch.rand((*x.shape[:2], 1, 1, 1), device=x.device,
                   generator=_need_generator(generator, "spatial_dropout"))
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class DiscDownsample(nn.Module):
    """PatchGAN downsample block (layers.py:524-576, no spectral norm): layer
    noise, a 4^3 conv without bias — stride 2 on a reflect pad of 1
    (``padding='valid'``) or stride 1 TF SAME with zeros (``'same'``, pads
    (1, 2)) — then InstanceNorm + LeakyReLU 0.2 and spatial dropout.

    The reflect pad is folded into the conv, so the noise is drawn on the
    unpadded tensor: the order of the JAX package's default layout (NXCYZ, see
    its ConvND divergence note). In eval both orders are the same function.
    """

    def __init__(self, in_channels: int, filters: int, kernel_size: int = 4,
                 strides: int = 2, padding: str = "valid", use_dropout: bool = True,
                 dropout_rate: float = 0.2, use_layer_noise: bool = False,
                 noise_std: float = 0.1, leaky_slope: float = 0.2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if padding == "valid":
            pad, pad_mode = uniform_pads(1), "reflect"
        elif padding == "same":
            pad, pad_mode = "same", "zeros"
        else:
            raise ValueError(f"padding must be 'valid' or 'same', got {padding!r}")
        self.use_dropout = use_dropout
        self.dropout_rate = dropout_rate
        self.noise = GaussianNoise(noise_std) if use_layer_noise else None
        self.conv = ConvND(in_channels, filters, kernel_size, strides, padding=pad,
                           pad_mode=pad_mode, use_bias=False, generator=generator)
        self.inorm = InstanceNorm(filters, act="leaky_relu", leaky_slope=leaky_slope)

    def forward(self, x: torch.Tensor, train: bool = False, noise_std: Optional[float] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.noise is not None:
            x = self.noise(x, train, noise_std, generator)
        x = self.inorm(self.conv(x))
        if self.use_dropout:
            x = spatial_dropout(x, self.dropout_rate, train, generator)
        return x
