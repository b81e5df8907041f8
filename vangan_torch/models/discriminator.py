"""3-D PatchGAN discriminator.

Counterpart of ``vangan_tpu.models.discriminator.PatchGANDiscriminator3D``
(discriminator.py:7-124): input noise, ``conv0`` (4^3, stride 2, reflect pad
1) + ``inorm0`` with LeakyReLU 0.2, three ``DiscDownsample`` blocks (stride
2, stride 2, stride 1 'same'), head noise and a 3^3 'same' ``head`` conv to
one logit channel. A 128^3 input gives 16^3 x 1 patch logits. Public input
and output keep the JAX layout ``(B, X, Y, Z, 1)``; it computes in ``dtype``
and returns float32 logits. With ``dims=2`` it is the 2-D PatchGAN on
``(B, H, W, 1)`` images (4x4 and 3x3 convs), run as depth-1 volumes: a 128^2
input gives 16^2 x 1 logits.

With ``use_SN`` every conv but the head is spectrally normalised
(``layers.SpectralNorm``) and no InstanceNorm follows it: ``conv0`` then has
a live bias and LeakyReLU 0.2 alone. With ``wasserstein`` the critic's head
follows: the logits flattened in X, Y, Z order, dropout 0.2 (in training,
whatever ``use_dropout`` says) and ``w_dense``, a Linear to one score per
sample, ``(B, 1)``. flax infers the Dense's width at init; here it is the
head's voxel count for ``patch_size`` (its first ``dims`` sizes).

Noise and dropout act only with ``train=True``; they draw from the
``torch.Generator`` passed to the call, and σ is passed per call.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn

from vangan_torch.models.layers import (
    ConvND,
    DiscDownsample,
    GaussianNoise,
    InstanceNorm,
    KernelSwitch,
    SpectralNorm,
    from_volume,
    leaky_relu,
    standard_dropout,
    to_volume,
    uniform_pads,
    variance_scaling_,
)


def head_dims(patch_size: Sequence[int], num_downsampling: int = 3, dims: int = 3) -> tuple:
    """The head's spatial sizes for an input of the first ``dims`` sizes of
    ``patch_size`` (``SUBVOL_PATCH_SIZE``): conv0 and the first two blocks
    halve each (4 wide, stride 2, reflect pad 1), the rest keep it."""
    sizes = tuple(patch_size[:dims])
    for _ in range(1 + min(num_downsampling, 2)):
        sizes = tuple((n + 2 - 4) // 2 + 1 for n in sizes)
    return sizes


class PatchGANDiscriminator3D(KernelSwitch, nn.Module):
    def __init__(self, filters: int = 64, num_downsampling: int = 3,
                 use_dropout: bool = False, dropout_rate: float = 0.2,
                 wasserstein: bool = False, use_SN: bool = False,
                 use_input_noise: bool = False, use_layer_noise: bool = False,
                 noise_std: float = 0.1, dtype: torch.dtype = torch.float32,
                 patch_size: Optional[Sequence[int]] = None,
                 generator: Optional[torch.Generator] = None, dims: int = 3):
        super().__init__()
        if wasserstein and patch_size is None:
            raise ValueError("the Wasserstein head's w_dense needs the input's patch_size")
        self.dtype = dtype
        self.dims = dims
        g = generator
        self.input_noise = GaussianNoise(noise_std) if use_input_noise else None
        # without spectral norm conv0 feeds inorm0, which cancels a bias
        self.conv0 = ConvND(1, filters, 4, 2, padding=uniform_pads(1, dims), pad_mode="reflect",
                            use_bias=use_SN, generator=g, dims=dims)
        self.use_SN = use_SN
        if use_SN:
            self.SpectralNorm_0 = SpectralNorm("conv0", filters, generator=g)
        else:
            self.inorm0 = InstanceNorm(filters, act="leaky_relu")
        f = filters
        for block in range(num_downsampling):
            stride2 = block < 2  # discriminator.py:75-103
            setattr(self, f"down{block}", DiscDownsample(
                f, 2 * f, 4, 2 if stride2 else 1, "valid" if stride2 else "same",
                use_dropout, dropout_rate, use_layer_noise, noise_std, use_spec_norm=use_SN,
                generator=g, dims=dims))
            f *= 2
        self.num_downsampling = num_downsampling
        self.head_noise = GaussianNoise(noise_std) if use_layer_noise else None
        self.head = ConvND(f, 1, 3, 1, padding="same", use_bias=True, generator=g, dims=dims)
        self.w_dense = None
        if wasserstein:
            width = math.prod(head_dims(patch_size, num_downsampling, dims))
            self.w_dropout = 0.2  # discriminator.py:117, not governed by use_dropout
            self.w_dense = nn.Linear(width, 1)
            with torch.no_grad():
                variance_scaling_(self.w_dense.weight, width, 1.0, g)  # flax lecun_normal
                self.w_dense.bias.zero_()

    def forward(self, x: torch.Tensor, train: bool = False, noise_std: Optional[float] = None,
                generator: Optional[torch.Generator] = None,
                update_stats: Optional[bool] = None) -> torch.Tensor:
        """Patch logits (B, X', Y', Z', 1) (in 2-D (B, H', W', 1)), or the
        critic's (B, 1). With
        spectral norm, ``update_stats`` (default ``train``) says whether the
        power iterations are stored: the gradient penalty's calls train
        without storing them."""
        b = x.shape[0]
        stats = train if update_stats is None else update_stats
        x = to_volume(x.to(self.dtype), self.dims, "the discriminator")
        if self.input_noise is not None:
            x = self.input_noise(x, train, noise_std, generator)
        if self.use_SN:
            x = leaky_relu(self.conv0(x, self.SpectralNorm_0(self.conv0.weight, stats)))
        else:
            x = self.inorm0(self.conv0(x))
        for block in range(self.num_downsampling):
            x = getattr(self, f"down{block}")(x, train, noise_std, generator, stats)
        if self.head_noise is not None:
            x = self.head_noise(x, train, noise_std, generator)
        x = self.head(x)
        if self.w_dense is None:
            return from_volume(x, self.dims).float()
        x = standard_dropout(x.reshape(b, -1).float(), self.w_dropout, train, generator)
        return self.w_dense(x)
