"""The ResNet generator (psweens/VAN-GAN ``generator.py``
``get_resnet_generator``, CycleGAN's ResNet generator, Zhu et al. 2017) as
VAN-GAN builds it with 2f filters: a reflect-padded 7^3 stem conv +
InstanceNorm (he-normal gamma) + ReLU + spatial dropout 0.5; three stride-2
reflect-padded 3^3 convs, each + IN + ReLU + spatial dropout 0.2; six
identity residual blocks (two reflect-padded 3^3 convs, IN + ReLU after the
first, IN after the second); three nearest upsamplings, each + a 4^3 'same'
conv (zero pads 1, 2) + IN + ReLU; a reflect-padded 7^3 tanh head with bias.
No conv but the head has a bias."""

from portbench.reference.layers import (Spec, conv, from_volume, instance_norm, rounded,
                                        same_pads, spatial_dropout, to_volume, uniform,
                                        upsample)

DOWN, RES, UP = 3, 6, 3
STEM_DROPOUT, DOWN_DROPOUT = 0.5, 0.2


def spec(fields: dict, role: str) -> Spec:
    f = 2 * fields["gen_filters"]
    s = Spec()
    s.conv("stem_conv", 1, f, 7, False)
    s.norm("stem_inorm", f, ("he", f))
    for i in range(DOWN):
        s.conv(f"down{i}", f, 2 * f, 3, False)
        f *= 2
        s.norm(f"down_inorm{i}", f, ("he", f))
    for i in range(RES):
        s.conv(f"res{i}.conv1", f, f, 3, False)
        s.norm(f"res{i}.inorm1", f, ("he", f))
        s.conv(f"res{i}.conv2", f, f, 3, False)
        s.norm(f"res{i}.inorm2", f, ("he", f))
    for i in range(UP):
        s.conv(f"up{i}", f, f // 2, 4, False)
        f //= 2
        s.norm(f"up_inorm{i}", f, ("he", f))
    s.conv("head", f, 1, 7, True)
    return s


def forward(P, x, ctx, seg, train=False, noise_std=0.0):
    def norm(name, h, act):
        return instance_norm(ctx, h, P[f"{name}.weight"], P[f"{name}.bias"], act)

    def dropout(h, rate):
        if not train:
            return h
        return spatial_dropout(ctx, h, rate, seg.rand((*h.shape[:2], 1, 1, 1)))

    h = rounded(ctx, to_volume(x))
    h = norm("stem_inorm", conv(ctx, h, P["stem_conv.weight"], None, 1, uniform(3), "reflect"),
             "relu")
    h = dropout(h, STEM_DROPOUT)
    for i in range(DOWN):
        h = conv(ctx, h, P[f"down{i}.weight"], None, 2, uniform(1), "reflect")
        h = dropout(norm(f"down_inorm{i}", h, "relu"), DOWN_DROPOUT)
    for i in range(RES):
        r = norm(f"res{i}.inorm1", conv(ctx, h, P[f"res{i}.conv1.weight"], None, 1, uniform(1),
                                        "reflect"), "relu")
        r = norm(f"res{i}.inorm2", conv(ctx, r, P[f"res{i}.conv2.weight"], None, 1, uniform(1),
                                        "reflect"), "none")
        h = rounded(ctx, h + r)
    for i in range(UP):
        h = upsample(h)
        h = conv(ctx, h, P[f"up{i}.weight"], None, 1, same_pads(h.shape[2:], 4, 1))
        h = norm(f"up_inorm{i}", h, "relu")
    h = conv(ctx, h, P["head.weight"], P["head.bias"], 1, uniform(3), "reflect")
    return from_volume(h).tanh()
