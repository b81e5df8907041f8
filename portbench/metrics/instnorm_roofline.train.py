"""instnorm_roofline.train: the bytes bound of every norm forward (x read, y
written) and backward (x and dy read, dx written) of the traced steps, an
InstanceNorm's or a BatchNorm's alike, in the compute dtype, / the device
time of the InstanceNorm kernels and any library norm, in %. None where no
norm kernel ran."""

from portbench.trace import NORM_FAMILIES


def read(t):
    if not t or t["kind"] != "train":
        return None
    busy = t["summary"].seconds(NORM_FAMILIES)
    return 100.0 * t["work"].norm_bound_s / busy if busy > 0 else None
