"""3-D PatchGAN discriminator.

Counterpart of ``vangan_tpu.models.discriminator.PatchGANDiscriminator3D``
(discriminator.py:7-124) without spectral norm and without the Wasserstein
head, which are not ported yet: input noise, ``conv0`` (4^3, stride 2,
reflect pad 1, no bias) + ``inorm0`` with LeakyReLU 0.2, three
``DiscDownsample`` blocks (stride 2, stride 2, stride 1 'same'), head noise
and a 3^3 'same' ``head`` conv to one logit channel. A 128^3 input gives
16^3 x 1 patch logits. Public input and output keep the JAX layout
``(B, X, Y, Z, 1)``; it computes in ``dtype`` and returns float32 logits.

Noise and dropout act only with ``train=True``; they draw from the
``torch.Generator`` passed to the call, and σ is passed per call.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from vangan_torch.models.layers import (
    ConvND,
    DiscDownsample,
    GaussianNoise,
    InstanceNorm,
    KernelSwitch,
    uniform_pads,
)


class PatchGANDiscriminator3D(KernelSwitch, nn.Module):
    def __init__(self, filters: int = 64, num_downsampling: int = 3,
                 use_dropout: bool = False, dropout_rate: float = 0.2,
                 wasserstein: bool = False, use_SN: bool = False,
                 use_input_noise: bool = False, use_layer_noise: bool = False,
                 noise_std: float = 0.1, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if use_SN:
            raise NotImplementedError("use_SN=True (spectral norm) is not ported yet "
                                      "(ROADMAP.md Queue 1, other families and modes)")
        if wasserstein:
            raise NotImplementedError("the Wasserstein head (w_dense) is not ported yet "
                                      "(ROADMAP.md Queue 1, other families and modes)")
        self.dtype = dtype
        g = generator
        self.input_noise = GaussianNoise(noise_std) if use_input_noise else None
        self.conv0 = ConvND(1, filters, 4, 2, padding=uniform_pads(1), pad_mode="reflect",
                            use_bias=False, generator=g)
        self.inorm0 = InstanceNorm(filters, act="leaky_relu")
        f = filters
        for block in range(num_downsampling):
            stride2 = block < 2  # discriminator.py:75-103
            setattr(self, f"down{block}", DiscDownsample(
                f, 2 * f, 4, 2 if stride2 else 1, "valid" if stride2 else "same",
                use_dropout, dropout_rate, use_layer_noise, noise_std, generator=g))
            f *= 2
        self.num_downsampling = num_downsampling
        self.head_noise = GaussianNoise(noise_std) if use_layer_noise else None
        self.head = ConvND(f, 1, 3, 1, padding="same", use_bias=True, generator=g)

    def forward(self, x: torch.Tensor, train: bool = False, noise_std: Optional[float] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, X, Y, Z, c = x.shape
        if c != 1:
            raise ValueError(f"the discriminator takes one channel, got shape {tuple(x.shape)}")
        x = x.to(self.dtype).reshape(b, 1, X, Y, Z)
        if self.input_noise is not None:
            x = self.input_noise(x, train, noise_std, generator)
        x = self.inorm0(self.conv0(x))
        for block in range(self.num_downsampling):
            x = getattr(self, f"down{block}")(x, train, noise_std, generator)
        if self.head_noise is not None:
            x = self.head_noise(x, train, noise_std, generator)
        x = self.head(x)
        return x.reshape(b, *x.shape[2:], 1).float()
