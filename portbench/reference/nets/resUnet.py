"""The ResU-Net generator (psweens/VAN-GAN ``resunet_model.py``,
``ResUNet(filters, num_layers=4)``) as VAN-GAN builds it: filter ladder
f, 2f, 4f, 8f, 16f; a stem (3^3 conv, then a pre-activation block, plus a
1^3-projected identity); four stride-2 pre-activation residual encoder
blocks; a two-block bridge; nearest upsampling, concat [upsampled, skip]
and a residual decoder block per level; a 1^3 tanh head. Pre-activation
blocks are InstanceNorm + ReLU, then a reflect-padded 3^3 conv; a conv
that feeds another InstanceNorm has no bias. No dropout, no input noise."""

import torch

from portbench.reference.layers import (Spec, conv, from_volume, instance_norm, rounded,
                                        same_pads, to_volume, uniform, upsample)

LAYERS = 4


def spec(fields: dict, role: str) -> Spec:
    f = [fields["gen_filters"] * 2 ** i for i in range(LAYERS + 1)]
    s = Spec()
    s.conv("stem.conv1", 1, f[0], 3, False)
    s.norm("stem.conv_block.norm_act.inorm", f[0])
    s.conv("stem.conv_block.conv", f[0], f[0], 3, True)
    s.conv("stem.shortcut", 1, f[0], 1, False)
    s.norm("stem.shortcut_norm.inorm", f[0])

    def block(p, ci, co):
        s.norm(f"{p}.block1.norm_act.inorm", ci)
        s.conv(f"{p}.block1.conv", ci, co, 3, False)
        s.norm(f"{p}.block2.norm_act.inorm", co)
        s.conv(f"{p}.block2.conv", co, co, 3, True)
        s.conv(f"{p}.shortcut", ci, co, 1, False)
        s.norm(f"{p}.shortcut_norm.inorm", co)

    for e in range(1, LAYERS + 1):
        block(f"enc{e}", f[e - 1], f[e])
    s.norm("bridge1.norm_act.inorm", f[-1])
    s.conv("bridge1.conv", f[-1], f[-1], 3, False)
    s.norm("bridge2.norm_act.inorm", f[-1])
    s.conv("bridge2.conv", f[-1], f[-1], 3, True)
    for d in reversed(range(LAYERS)):
        block(f"dec{d}", f[d + 1] + f[d], f[d])
    s.conv("head", f[0], 1, 1, True)
    return s


def forward(P, x, ctx, seg, train=False, noise_std=0.0):
    def preact(p, h, stride=1):
        h = instance_norm(ctx, h, P[f"{p}.norm_act.inorm.weight"], P[f"{p}.norm_act.inorm.bias"],
                          "relu")
        return conv(ctx, h, P[f"{p}.conv.weight"], P.get(f"{p}.conv.bias"), stride, uniform(1),
                    "reflect")

    def shortcut(p, h, stride):
        h = conv(ctx, h, P[f"{p}.shortcut.weight"], None, stride, same_pads(h.shape[2:], 1, stride))
        return instance_norm(ctx, h, P[f"{p}.shortcut_norm.inorm.weight"],
                             P[f"{p}.shortcut_norm.inorm.bias"])

    def block(p, h, stride):
        return rounded(ctx, shortcut(p, h, stride)
                       + preact(f"{p}.block2", preact(f"{p}.block1", h, stride)))

    h = rounded(ctx, to_volume(x))
    h = rounded(ctx, preact("stem.conv_block", conv(ctx, h, P["stem.conv1.weight"], None, 1,
                                                    uniform(1), "reflect"))
                + shortcut("stem", h, 1))
    skips = [h]
    for e in range(1, LAYERS + 1):
        h = block(f"enc{e}", h, 2)
        skips.append(h)
    h = preact("bridge2", preact("bridge1", h))
    for d in reversed(range(LAYERS)):
        h = block(f"dec{d}", torch.cat([upsample(h), skips[d]], dim=1), 1)
    h = conv(ctx, h, P["head.weight"], P["head.bias"], 1, uniform(0))
    return from_volume(h).tanh()

