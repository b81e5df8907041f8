"""The 3-D PatchGAN discriminator (psweens/VAN-GAN ``discriminator.py``
``get_discriminator``, f filters) as VAN-GAN trains it: Gaussian noise of
sigma ``noise_std`` on the input; a 4^3 stride-2 reflect-padded conv +
InstanceNorm + LeakyReLU 0.2; three blocks (stride 2, stride 2, stride 1
'same'), each Gaussian noise, a 4^3 conv without bias, IN + LeakyReLU 0.2
and spatial dropout 0.2; noise again, then a 3^3 'same' head with bias to
one logit channel. Noise and dropout act only in training."""

from portbench.reference.layers import (Spec, conv, from_volume, instance_norm, rounded,
                                        same_pads, spatial_dropout, to_volume, uniform)

BLOCKS = 3
DROPOUT = 0.2


def spec(fields: dict, role: str = "disc") -> Spec:
    f = fields["disc_filters"]
    s = Spec()
    s.conv("conv0", 1, f, 4, False)
    s.norm("inorm0", f)
    for b in range(BLOCKS):
        s.conv(f"down{b}.conv", f, 2 * f, 4, False)
        f *= 2
        s.norm(f"down{b}.inorm", f)
    s.conv("head", f, 1, 3, True)
    return s


def forward(P, x, ctx, seg, train=False, noise_std=0.0):
    def noise(h):
        if not train or noise_std == 0:
            return h
        return rounded(ctx, h + noise_std * seg.randn(h.shape))

    h = noise(rounded(ctx, to_volume(x)))
    h = instance_norm(ctx, conv(ctx, h, P["conv0.weight"], None, 2, uniform(1), "reflect"),
                      P["inorm0.weight"], P["inorm0.bias"], "leaky_relu")
    for b in range(BLOCKS):
        h = noise(h)
        if b < 2:
            h = conv(ctx, h, P[f"down{b}.conv.weight"], None, 2, uniform(1), "reflect")
        else:
            h = conv(ctx, h, P[f"down{b}.conv.weight"], None, 1, same_pads(h.shape[2:], 4, 1))
        h = instance_norm(ctx, h, P[f"down{b}.inorm.weight"], P[f"down{b}.inorm.bias"],
                          "leaky_relu")
        if train:
            h = spatial_dropout(ctx, h, DROPOUT, seg.rand((*h.shape[:2], 1, 1, 1)))
    h = noise(h)
    h = conv(ctx, h, P["head.weight"], P["head.bias"], 1, same_pads(h.shape[2:], 3, 1))
    return from_volume(h)
