"""torch building blocks of the generators (ResU-Net, V-Net, ResNet) and the
PatchGAN discriminator.

Counterparts of ``vangan_tpu.models.layers`` on torch's ``(B, C, X, Y, Z)``
layout. Submodules carry the flax names (``conv``, ``norm_act.inorm``,
``shortcut``, ...) and parameters are created in flax's shapes, so a flax
parameter tree maps onto ``state_dict`` by a rename and a transpose
(``vangan_torch.weights``). Parameters are float32; a conv runs in its input's
dtype (the compute dtype) with the weight cast to it, and InstanceNorm and
BatchNorm keep their statistics in float32. Layers whose behaviour differs
in training (dropout, noise, BatchNorm) take an explicit ``train`` argument,
not ``module.training``, and draw from an explicit ``torch.Generator``.

A 2-D network (``dims=2``, the DIMENSIONS=2 mode) runs on depth-1 volumes
``(B, C, 1, H, W)``: a kernel extent or stride ``k`` is ``(1, k, k)`` on
them, pads are ``(0, 0)`` on the depth axis, and a weight is
``(Co, Ci, 1, kh, kw)`` with fan-in ``Ci * kh * kw``. A 2-D conv is exactly
the 3-D conv of a depth-1 volume with a ``(1, kh, kw)`` kernel and a 2-D
InstanceNorm reduces the same H * W plane, so 2-D layers run the same
kernels as 3-D ones (the JAX package sends them to XLA instead).

Each ``ConvND`` and ``InstanceNorm`` has a ``use_kernels`` switch: True (the
default) sends the op to the hand-written kernels where the JAX package sends
it to Pallas (convs with ``max(Ci, Co) < 128``; every InstanceNorm), forward
and, where a gradient is needed, backward; False runs the plain torch version
and its autograd everywhere, for comparing the two on the card.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from vangan_torch.monitor.profiling import span
from vangan_torch.ops.autograd import once_differentiable
from vangan_torch.ops.conv3d import conv3d, conv3d_plain, norm_padding
from vangan_torch.ops.instnorm import instance_norm_act, instance_norm_act_plain

# Convs at or above this channel count go to torch (cuDNN), as the JAX package
# sends them to XLA (vangan_tpu/models/layers.py ConvND._plain_conv).
KERNEL_MAX_CHANNELS = 128


def variance_scaling_(t: torch.Tensor, fan_in: int, scale: float,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's truncated-normal ``variance_scaling`` (fan_in): truncated at
    [-2, 2] std, std corrected so the truncated distribution has variance
    ``scale / fan_in``."""
    std = (scale / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def he_normal_(t: torch.Tensor, fan_in: int,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Keras/flax he_normal: variance 2 / fan_in."""
    return variance_scaling_(t, fan_in, 2.0, generator)


def spatial(v: Union[int, Sequence[int]], dims: int = 3) -> Tuple[int, int, int]:
    """A kernel extent, stride or factor (an int or one per spatial axis of
    the network) on the three axes of ``(B, C, X, Y, Z)``: in 2-D the depth-1
    axis gets 1."""
    t = (v,) * dims if isinstance(v, int) else tuple(v)
    if dims not in (2, 3) or len(t) not in (dims, 3):
        raise ValueError(f"{v!r} for a {dims}-D network")
    return (1,) * (3 - len(t)) + t


def uniform_pads(p: int, dims: int = 3) -> Tuple[Tuple[int, int], ...]:
    """Pads of ``p`` on each spatial axis of a ``dims``-D network, none on a
    2-D network's depth-1 axis."""
    return ((0, 0),) * (3 - dims) + ((p, p),) * dims


def to_volume(x: torch.Tensor, dims: int, what: str) -> torch.Tensor:
    """A public one-channel batch, ``(B, X, Y, Z, 1)`` or in 2-D
    ``(B, H, W, 1)``, as the ``(B, 1, X, Y, Z)`` the layers run on (in 2-D
    ``(B, 1, 1, H, W)``); a reshape."""
    if x.dim() != dims + 2 or x.shape[-1] != 1:
        axes = "X, Y, Z" if dims == 3 else "H, W"
        raise ValueError(f"{what} takes one input channel, (B, {axes}, 1), got shape "
                         f"{tuple(x.shape)}")
    return x.reshape(x.shape[0], 1, *(1,) * (3 - dims), *x.shape[1:-1])


def from_volume(y: torch.Tensor, dims: int) -> torch.Tensor:
    """``to_volume``'s inverse: ``(B, C, X, Y, Z)`` as the public
    ``(B, X, Y, Z, C)`` of a ``dims``-D network (in 2-D ``(B, C, 1, H, W)``
    as ``(B, H, W, C)``); a reshape for one channel."""
    if y.shape[1] == 1:
        return y.reshape(y.shape[0], *y.shape[5 - dims:], 1)
    y = y.movedim(1, -1)
    return y.reshape(y.shape[0], *y.shape[4 - dims:])


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
    explicit widths (three pairs, ``uniform_pads``), ``pad_mode`` 'zeros' |
    'reflect'; with ``dims=2`` the conv of a 2-D network on depth-1 volumes
    (flax's ``kernel`` (kh, kw, Ci, Co) is ``weight`` (Co, Ci, 1, kh, kw))."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Union[int, Sequence[int]] = 3,
                 strides: Union[int, Sequence[int]] = 1, padding="same",
                 pad_mode: str = "zeros", use_bias: bool = True,
                 generator: Optional[torch.Generator] = None, dims: int = 3):
        super().__init__()
        k = spatial(kernel_size, dims)
        self.dims = dims
        self.kernel_size = k
        self.strides = spatial(strides, dims)
        self.padding = padding
        self.pad_mode = pad_mode
        self.use_kernels = True
        w = torch.empty(features, in_channels, *k)
        self.weight = nn.Parameter(he_normal_(w, in_channels * k[0] * k[1] * k[2], generator))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor, weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The conv of ``x`` with ``weight`` (default ``self.weight``; a
        spectrally normalised one, see ``SpectralNorm``), in the span
        ``conv.forward`` on either route."""
        w = self.weight if weight is None else weight
        co, ci = w.shape[:2]
        with span("conv.forward"):
            if self.use_kernels and max(ci, co) < KERNEL_MAX_CHANNELS:
                return conv3d(x, w, self.bias, self.strides, self.padding, self.pad_mode)
            pads = norm_padding(self.padding, self.kernel_size, self.strides, x.shape[2:])
            return conv3d_plain(x, w, self.bias, self.strides, pads, self.pad_mode)


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalisation over X, Y, Z (eps 1e-3, learned
    ``weight`` = flax ``scale`` and ``bias``) with an activation epilogue.
    ``gamma_init`` is ``"ones"`` or ``"he_normal"`` (``he_normal_1d``, fan_in
    = channels: the ResNet generator's, generator.py:14,40)."""

    def __init__(self, channels: int, act: str = "none", epsilon: float = 1e-3,
                 leaky_slope: float = 0.2, gamma_init: str = "ones",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act = act
        self.epsilon = epsilon
        self.leaky_slope = leaky_slope
        self.use_kernels = True
        if gamma_init == "ones":
            gamma = torch.ones(channels)
        elif gamma_init == "he_normal":
            gamma = he_normal_(torch.empty(channels), channels, generator)
        else:
            raise ValueError(f"gamma_init must be 'ones' or 'he_normal', got {gamma_init!r}")
        self.weight = nn.Parameter(gamma)
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
                 generator: Optional[torch.Generator] = None, dims: int = 3):
        super().__init__()
        self.norm_act = NormAct(in_channels)
        self.conv = ConvND(in_channels, filters, kernel_size, strides,
                           padding=uniform_pads(kernel_size // 2, dims), pad_mode="reflect",
                           use_bias=use_bias, generator=generator, dims=dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(self.norm_act(x))


class Stem(nn.Module):
    """ResU-Net stem: conv + pre-act conv block + 1^3-projected identity
    (resunet_model.py:69-100)."""

    def __init__(self, in_channels: int, filters: int,
                 generator: Optional[torch.Generator] = None, dims: int = 3):
        super().__init__()
        self.conv1 = ConvND(in_channels, filters, 3, 1, padding=uniform_pads(1, dims),
                            pad_mode="reflect", use_bias=False, generator=generator, dims=dims)
        self.conv_block = PreActConvBlock(filters, filters, generator=generator, dims=dims)
        self.shortcut = ConvND(in_channels, filters, 1, 1, padding="same", use_bias=False,
                               generator=generator, dims=dims)
        self.shortcut_norm = NormAct(filters, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_block(self.conv1(x)) + self.shortcut_norm(self.shortcut(x))


class ResUNetResidualBlock(nn.Module):
    """Pre-activation residual block with projected shortcut
    (resunet_model.py:103-143), and ``dropout_type`` dropout of rate
    ``dropout`` on its output in training (layers.py:448-480 of the JAX
    package), drawn from the call's generator; the factory's generators have
    none."""

    def __init__(self, in_channels: int, filters: int, strides: int = 1,
                 dropout_type: Optional[str] = "none", dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None, dims: int = 3):
        super().__init__()
        self.block1 = PreActConvBlock(in_channels, filters, strides=strides,
                                      use_bias=False, generator=generator, dims=dims)
        self.block2 = PreActConvBlock(filters, filters, generator=generator, dims=dims)
        self.shortcut = ConvND(in_channels, filters, 1, strides, padding="same",
                               use_bias=False, generator=generator, dims=dims)
        self.shortcut_norm = NormAct(filters, act=False)
        self.dropout = make_dropout(dropout_type, dropout)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        out = self.shortcut_norm(self.shortcut(x)) + self.block2(self.block1(x))
        if self.dropout is not None:
            out = self.dropout(out, train=train, generator=generator)
        return out


def upsample_nearest(x: torch.Tensor, factor: int = 2, dims: int = 3) -> torch.Tensor:
    """Keras UpSampling3D (nearest-neighbour repeat) on (B, C, X, Y, Z); in
    2-D (UpSampling2D) on the H and W of depth-1 volumes."""
    return F.interpolate(x, scale_factor=spatial(factor, dims), mode="nearest")


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
    """Keras SpatialDropout3D on (B, C, X, Y, Z) (layers.py:330-335), and
    SpatialDropout2D on depth-1 volumes: in
    training each (b, c) channel is dropped whole with probability ``rate``
    and kept ones are scaled by 1 / (1 - rate), as flax ``nn.Dropout`` with the
    spatial axes broadcast does."""
    if not train or rate == 0:
        return x
    keep = 1.0 - rate
    u = torch.rand((*x.shape[:2], 1, 1, 1), device=x.device,
                   generator=_need_generator(generator, "spatial_dropout"))
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def standard_dropout(x: torch.Tensor, rate: float, train: bool = False,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Element-wise dropout, flax ``nn.Dropout`` without broadcast dims: in
    training each element is dropped with probability ``rate`` and kept ones
    are scaled by 1 / (1 - rate)."""
    if not train or rate == 0:
        return x
    keep = 1.0 - rate
    u = torch.rand(x.shape, device=x.device,
                   generator=_need_generator(generator, "standard_dropout"))
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def make_dropout(dropout_type: Optional[str], rate: float) -> Optional[Callable]:
    """The reference's dropout_type dispatch (layers.py:338-349):
    ``"spatial"`` | ``"standard"`` | ``"none"`` (or None, no layer). The
    result is called as ``do(x, train=..., generator=...)``."""
    if dropout_type == "spatial":
        return functools.partial(spatial_dropout, rate=rate)
    if dropout_type == "standard":
        return functools.partial(standard_dropout, rate=rate)
    if dropout_type in ("none", None):
        return None
    raise ValueError(f"dropout_type must be 'spatial', 'standard' or 'none', got {dropout_type!r}")


OUTPUT_ACTIVATIONS = {"tanh": torch.tanh, "sigmoid": torch.sigmoid, None: lambda x: x}


def head_activation(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    """A generator head's activation: ``"tanh"``, ``"sigmoid"`` or None (the
    identity); any other name raises, as the JAX package's heads do."""
    if name not in OUTPUT_ACTIVATIONS:
        raise ValueError(f"unknown output activation {name!r}")
    return OUTPUT_ACTIVATIONS[name]


def max_pool_2x(x: torch.Tensor, dims: int = 3) -> torch.Tensor:
    """MaxPooling3D(2) on (B, C, X, Y, Z) (vnet.py:35-42, VALID windows), in
    2-D MaxPooling2D(2) on depth-1 volumes. A tied window sends its gradient
    to its first element in X, Y, Z order, as ``reduce_window``'s does. In
    the span ``maxpool.forward``."""
    with span("maxpool.forward"):
        return F.max_pool3d(x, spatial(2, dims))


class _CrossRankBatchNorm(torch.autograd.Function):
    """Training-mode batch norm whose statistics run over every rank's batch
    (equal shards): the forward sums x and then (x - mean)^2 over the ranks,
    the backward the two per-channel gradient sums, sum(g) and sum(g xhat),
    as ``torch.nn.SyncBatchNorm`` does; the parameters' gradients stay the
    rank's own, to be averaged with the others'. Returns (y, mean, biased
    var); computes in ``weight``'s dtype and keeps x, mean and 1/std."""

    @staticmethod
    def forward(ctx, x, weight, bias, group, eps):
        dims = [d for d in range(x.dim()) if d != 1]
        shape = (1, -1) + (1,) * (x.dim() - 2)
        n = x.numel() // x.shape[1] * group.world
        mean = group.sum_(x.sum(dims, dtype=weight.dtype)) / n
        xc = x.to(weight.dtype) - mean.view(shape)
        var = group.sum_(xc.square().sum(dims)) / n
        invstd = torch.rsqrt(var + eps)
        y = torch.addcmul(bias.view(shape), xc, (invstd * weight).view(shape)).to(x.dtype)
        ctx.save_for_backward(x, mean, invstd, weight)
        ctx.group, ctx.n = group, n
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    @once_differentiable
    def backward(ctx, gy, _gmean, _gvar):
        x, mean, invstd, weight = ctx.saved_tensors
        dims = [d for d in range(x.dim()) if d != 1]
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xhat = (x.to(weight.dtype) - mean.view(shape)) * invstd.view(shape)
        g = gy.to(weight.dtype)
        sums = torch.cat([g.sum(dims), (g * xhat).sum(dims)])
        c = weight.numel()
        dbias, dweight = sums[:c].clone(), sums[c:].clone()
        ctx.group.sum_(sums)
        dx = (g - (sums[:c] / ctx.n).view(shape) - xhat * (sums[c:] / ctx.n).view(shape))
        dx = dx * (invstd * weight).view(shape)
        return dx.to(x.dtype), dweight, dbias, None, None


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` as the V-Net uses it (vnet.py:66-73): statistics
    per channel over (B, X, Y, Z) (a depth-1 volume's over (B, 1, H, W)),
    eps 1e-3 (Keras'), momentum 0.99, learned
    ``weight`` (flax ``scale``) and ``bias``, running ``mean`` and ``var``
    buffers (flax ``batch_stats``), all float32.

    With ``train`` it normalises by the batch's statistics and moves the
    buffers to ``0.99 * buffer + 0.01 * statistic`` with the biased variance
    (``F.batch_norm`` would move them by the unbiased one, so the update is
    made here, from the statistics ``native_batch_norm`` returns); without
    it, by the buffers. PyTorch's batch norm (a library op, as XLA's is in
    the JAX package) computes the statistics and the normalisation in
    float32 and keeps only the input and the statistics for the backward;
    flax computes the variance as E[x^2] - E[x]^2 in float32, which differs
    in rounding only.

    With ``group`` (a ``parallel.Group`` of more than one rank, set by
    ``VanGan``) the batch is the global one, as under the JAX package's
    data mesh: the statistics, and so the buffers, run over every rank's
    shard (``_CrossRankBatchNorm``), and the buffers stay equal on every
    rank. ``torch.nn.SyncBatchNorm`` would move them by the unbiased
    variance. Either path runs in the span ``batchnorm.forward``.
    """

    def __init__(self, channels: int, epsilon: float = 1e-3, momentum: float = 0.99):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))
        self.group = None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        with span("batchnorm.forward"):
            return self._forward(x, train)

    def _forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        # float32 parameters and statistics, float64 for a float64 input
        p = functools.partial(torch.Tensor.to, dtype=torch.promote_types(x.dtype, torch.float32))
        if not train:
            return F.batch_norm(x, p(self.mean), p(self.var), p(self.weight), p(self.bias),
                                False, 0.0, self.epsilon)
        if self.group is not None and self.group.world > 1:
            y, mean, var = _CrossRankBatchNorm.apply(x, p(self.weight), p(self.bias),
                                                     self.group, self.epsilon)
        else:
            y, mean, invstd = torch.native_batch_norm(x, p(self.weight), p(self.bias), None,
                                                      None, True, 0.0, self.epsilon)
            var = torch.clamp(invstd.detach().reciprocal().square() - self.epsilon, min=0.0)
        with torch.no_grad():
            self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * mean)
            self.var.copy_(self.momentum * self.var + (1 - self.momentum) * var)
        return y


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose`` with ``kernel_size == strides`` (the
    generators' 2^3 stride-2 upsampling, vnet.py:148, resunet.py:96): the
    windows do not overlap, so 'SAME' and 'VALID' both give ``s * n``.
    ``weight`` is torch's (Ci, Co, kx, ky, kz), flax's ``kernel``
    (kx, ky, kz, Ci, Co) flipped on its three spatial axes (flax does not
    flip; ``weights.py`` maps it), and ``bias``; in 2-D (Ci, Co, 1, kh, kw)
    and stride (1, s, s). ``kernel_init``:
    ``"lecun_normal"`` (flax's default) or ``"he_normal"``, fan_in Ci * taps. The
    forward runs in the span ``deconv.forward``."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 2,
                 strides: int = 2, kernel_init: str = "lecun_normal",
                 generator: Optional[torch.Generator] = None, dims: int = 3):
        super().__init__()
        if kernel_size != strides:
            raise ValueError(f"ConvTranspose takes kernel_size == strides, got {kernel_size}, "
                             f"{strides}")
        scales = {"lecun_normal": 1.0, "he_normal": 2.0}
        if kernel_init not in scales:
            raise ValueError(f"kernel_init must be one of {sorted(scales)}, got {kernel_init!r}")
        self.dims = dims
        self.strides = spatial(strides, dims)
        w = torch.empty(in_channels, features, *spatial(kernel_size, dims))
        self.weight = nn.Parameter(variance_scaling_(w, in_channels * kernel_size ** dims,
                                                     scales[kernel_init], generator))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("deconv.forward"):
            return F.conv_transpose3d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                                      stride=self.strides)


class AttentionGate(nn.Module):
    """Oktay attention gate (layers.py:487-505): ``inp_1 * sigmoid(conv_out(
    relu(conv1(inp_1) + conv2(inp_2))))``, 1^3 convs with bias."""

    def __init__(self, in1_channels: int, in2_channels: int, n_intermediate_filters: int,
                 generator: Optional[torch.Generator] = None, dims: int = 3):
        super().__init__()
        n = n_intermediate_filters
        conv = functools.partial(ConvND, kernel_size=1, strides=1, padding="same",
                                 generator=generator, dims=dims)
        self.conv1 = conv(in1_channels, n)
        self.conv2 = conv(in2_channels, n)
        self.conv_out = conv(n, 1)

    def forward(self, inp_1: torch.Tensor, inp_2: torch.Tensor) -> torch.Tensor:
        f = F.relu(self.conv1(inp_1) + self.conv2(inp_2))
        return inp_1 * torch.sigmoid(self.conv_out(f))


class AttentionConcat(nn.Module):
    """``[conv_below, gate(skip_connection, conv_below)]`` on channels
    (layers.py:508-521); the gate has as many intermediate filters as
    ``conv_below`` has channels."""

    def __init__(self, below_channels: int, skip_channels: int,
                 generator: Optional[torch.Generator] = None, dims: int = 3):
        super().__init__()
        self.gate = AttentionGate(skip_channels, below_channels, below_channels, generator, dims)

    def forward(self, conv_below: torch.Tensor, skip_connection: torch.Tensor) -> torch.Tensor:
        return torch.cat([conv_below, self.gate(skip_connection, conv_below)], dim=1)


class CycleGANResidualBlock(nn.Module):
    """The ResNet generator's post-activation residual block
    (layers.py:579-602): two reflect-padded 3^3 convs without bias, each
    followed by InstanceNorm with he_normal gamma (ReLU after the first),
    and an identity skip."""

    def __init__(self, dim: int, generator: Optional[torch.Generator] = None,
                 dims: int = 3):
        super().__init__()
        g = generator
        self.conv1 = ConvND(dim, dim, 3, 1, padding=uniform_pads(1, dims), pad_mode="reflect",
                            use_bias=False, generator=g, dims=dims)
        self.inorm1 = InstanceNorm(dim, act="relu", gamma_init="he_normal", generator=g)
        self.conv2 = ConvND(dim, dim, 3, 1, padding=uniform_pads(1, dims), pad_mode="reflect",
                            use_bias=False, generator=g, dims=dims)
        self.inorm2 = InstanceNorm(dim, gamma_init="he_normal", generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.inorm2(self.conv2(self.inorm1(self.conv1(x))))


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """flax ``nn.leaky_relu``: ``x`` where x >= 0 (slope 1 at 0), else slope * x."""
    return torch.where(x >= 0, x, slope * x)


def _l2_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + eps)


class SpectralNorm(nn.Module):
    """flax 0.12's ``nn.SpectralNorm`` (one power iteration, eps 1e-12) of the
    kernel of the conv named ``layer``, which keeps its own ``weight`` (and
    its bias, left unnormalised). The buffers ``u`` (1, Co) and ``sigma`` ()
    are flax's ``batch_stats`` ``<layer>/kernel/u`` and ``<layer>/kernel/sigma``.

    Each call, eval included, runs one power iteration from ``u`` on the
    kernel as a (k^3 Ci, Co) matrix (here (Co, Ci k^3), its transpose with the
    rows in another order, which gives the same u and sigma), with u and v
    detached, and returns ``weight / sigma``; with ``update_stats`` (training)
    it stores the new u and sigma."""

    def __init__(self, layer: str, features: int, eps: float = 1e-12,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layer = layer
        self.eps = eps
        self.register_buffer("u", torch.randn((1, features), generator=generator))
        self.register_buffer("sigma", torch.ones(()))

    def forward(self, weight: torch.Tensor, update_stats: bool) -> torch.Tensor:
        w = weight.reshape(weight.shape[0], -1)
        with torch.no_grad():
            v = _l2_normalize(self.u @ w, self.eps)
            u = _l2_normalize(v @ w.T, self.eps)
        sigma = (v @ w.T @ u.T)[0, 0]
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        return weight / torch.where(sigma != 0, sigma, torch.ones_like(sigma))


class DiscDownsample(nn.Module):
    """PatchGAN downsample block (layers.py:524-576): layer noise, a 4^3 conv
    without bias — stride 2 on a reflect pad of 1 (``padding='valid'``) or
    stride 1 TF SAME with zeros (``'same'``, pads (1, 2)) — then InstanceNorm
    + LeakyReLU 0.2, or with ``use_spec_norm`` the conv's kernel spectrally
    normalised and LeakyReLU 0.2 alone; then spatial dropout.

    The reflect pad is folded into the conv, so the noise is drawn on the
    unpadded tensor: the order of the JAX package's default layout (NXCYZ, see
    its ConvND divergence note). In eval both orders are the same function.
    """

    def __init__(self, in_channels: int, filters: int, kernel_size: int = 4,
                 strides: int = 2, padding: str = "valid", use_dropout: bool = True,
                 dropout_rate: float = 0.2, use_layer_noise: bool = False,
                 noise_std: float = 0.1, leaky_slope: float = 0.2,
                 use_spec_norm: bool = False, generator: Optional[torch.Generator] = None,
                 dims: int = 3):
        super().__init__()
        if padding == "valid":
            pad, pad_mode = uniform_pads(1, dims), "reflect"
        elif padding == "same":
            pad, pad_mode = "same", "zeros"
        else:
            raise ValueError(f"padding must be 'valid' or 'same', got {padding!r}")
        self.use_dropout = use_dropout
        self.dropout_rate = dropout_rate
        self.noise = GaussianNoise(noise_std) if use_layer_noise else None
        self.conv = ConvND(in_channels, filters, kernel_size, strides, padding=pad,
                           pad_mode=pad_mode, use_bias=False, generator=generator, dims=dims)
        self.leaky_slope = leaky_slope
        self.use_spec_norm = use_spec_norm
        if use_spec_norm:
            self.SpectralNorm_0 = SpectralNorm("conv", filters, generator=generator)
        else:
            self.inorm = InstanceNorm(filters, act="leaky_relu", leaky_slope=leaky_slope)

    def forward(self, x: torch.Tensor, train: bool = False, noise_std: Optional[float] = None,
                generator: Optional[torch.Generator] = None,
                update_stats: Optional[bool] = None) -> torch.Tensor:
        """``update_stats`` (default ``train``): whether a spectral norm
        stores its power iteration."""
        if self.noise is not None:
            x = self.noise(x, train, noise_std, generator)
        if self.use_spec_norm:
            w = self.SpectralNorm_0(self.conv.weight, train if update_stats is None
                                    else update_stats)
            x = leaky_relu(self.conv(x, w), self.leaky_slope)
        else:
            x = self.inorm(self.conv(x))
        if self.use_dropout:
            x = spatial_dropout(x, self.dropout_rate, train, generator)
        return x
