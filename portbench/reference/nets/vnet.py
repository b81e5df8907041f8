"""The V-Net / 3-D U-Net generator (psweens/VAN-GAN ``vnet_model.py``
``VNet``, after Milletari et al. 2016, arXiv:1606.04797, with max-pool
downsampling) as VAN-GAN builds it in both roles (``vangan.py``): four
levels, each a block of two reflect-padded 3^3 convs, each conv followed by
ReLU and *then* the norm (the reference's order), spatial dropout 0.5 after
the first norm of every encoder block and of the bottleneck, a 2^3 max-pool
down; a bottleneck block; per level up, an upsampling, concat [up, skip] and
a block without dropout; a 1^3 tanh head with bias.

- i2s (``gen_IS``): 2f filters (2f, 4f, 8f, 16f; 32f at the bottleneck),
  InstanceNorm (no activation) and convs with bias; up by nearest upsampling
  and a zero-padded 3^3 'same' conv with bias.
- s2i (``gen_SI``): f filters, Keras BatchNorm (eps 1e-3) and convs without
  bias; up by a 2^3 stride-2 transposed conv with bias.

Departures from ``vnet_model.py``:

- a training BatchNorm normalises by the batch's statistics and neither
  reads nor moves the running statistics (the program's state); in eval it
  reads them from ``P`` (``<name>.mean``, ``<name>.var``, as the spec's
  ``state`` names them), and raises where ``P`` lacks them;
- the dropout's uniforms come from the ``Segment`` in the program's draw
  shapes, ``(B, C, 1, 1, 1)``, and order (encoder blocks, then the
  bottleneck), not from TensorFlow's stream;
- the seeded weights are he-normal for every conv and transposed conv
  (``portbench/weights.py``), not Keras' initialisers;
- no ``addnoise`` input branch and no attention gates: VAN-GAN builds
  neither.
"""

import torch
import torch.nn.functional as F

from portbench.reference.layers import (Spec, batch_norm, conv, conv_transpose, from_volume,
                                        instance_norm, rounded, same_pads, spatial_dropout,
                                        to_volume, uniform, upsample)

LAYERS = 4
DROPOUT = 0.5
BN_EPS = 1e-3


def spec(fields: dict, role: str) -> Spec:
    bn = role == "s2i"
    f, ci = (1 if bn else 2) * fields["gen_filters"], 1
    s = Spec()

    def block(p, ci, co):
        for i, c in enumerate((ci, co)):
            s.conv(f"{p}.conv{i}", c, co, 3, not bn)
            if bn:
                s.batch_norm(f"{p}.bn{i}", co)
            else:
                s.norm(f"{p}.in{i}", co)

    for layer in range(LAYERS):
        block(f"down{layer}", ci, f)
        ci, f = f, 2 * f
    block("bottleneck", ci, f)
    for i in range(LAYERS):
        if bn:
            s.conv_transpose(f"deconv{i}", f, f // 2, 2)
        else:
            s.conv(f"upconv{i}", f, f // 2, 3, True)
        f //= 2
        block(f"up{i}", 2 * f, f)
    s.conv("head", f, 1, 1, True)
    return s


def norm(P, ctx, p, i, h, train):
    """Block ``p``'s ``i``-th norm of ``h``: ``<p>.bn<i>`` where ``P`` has
    it, else ``<p>.in<i>``."""
    name = f"{p}.bn{i}"
    if name + ".weight" not in P:
        name = f"{p}.in{i}"
        return instance_norm(ctx, h, P[f"{name}.weight"], P[f"{name}.bias"])
    if train:
        return batch_norm(ctx, h, P[f"{name}.weight"], P[f"{name}.bias"], BN_EPS)
    return rounded(ctx, F.batch_norm(h, P[f"{name}.mean"], P[f"{name}.var"], P[f"{name}.weight"],
                                     P[f"{name}.bias"], False, 0.0, BN_EPS))


def block(P, ctx, seg, p, h, train, dropout):
    """Block ``p``: twice a reflect-padded 3^3 conv, ReLU, the norm; with
    ``dropout`` (in training), spatial dropout after the first norm."""
    for i in range(2):
        h = torch.relu(conv(ctx, h, P[f"{p}.conv{i}.weight"], P.get(f"{p}.conv{i}.bias"), 1,
                            uniform(1), "reflect"))
        h = norm(P, ctx, p, i, h, train)
        if i == 0 and dropout and train:
            h = spatial_dropout(ctx, h, DROPOUT, seg.rand((*h.shape[:2], 1, 1, 1)))
    return h


def up(P, ctx, i, h):
    """Up level ``i``'s upsampling: the transposed conv ``deconv<i>`` (s2i),
    or nearest upsampling and the 'same' conv ``upconv<i>`` (i2s)."""
    if f"deconv{i}.weight" in P:
        return conv_transpose(ctx, h, P[f"deconv{i}.weight"], P[f"deconv{i}.bias"], 2)
    h = upsample(h)
    return conv(ctx, h, P[f"upconv{i}.weight"], P[f"upconv{i}.bias"], 1,
                same_pads(h.shape[2:], 3, 1))


def forward(P, x, ctx, seg, train=False, noise_std=0.0):
    h, skips = rounded(ctx, to_volume(x)), []
    for layer in range(LAYERS):
        h = block(P, ctx, seg, f"down{layer}", h, train, True)
        skips.append(h)
        h = F.max_pool3d(h, 2)
    h = block(P, ctx, seg, "bottleneck", h, train, True)
    for i, skip in enumerate(reversed(skips)):
        h = block(P, ctx, seg, f"up{i}", torch.cat([up(P, ctx, i, h), skip], dim=1), train, False)
    h = conv(ctx, h, P["head.weight"], P["head.bias"], 1, uniform(0))
    return from_volume(h).tanh()
