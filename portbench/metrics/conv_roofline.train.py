"""conv_roofline.train: the sum over every conv pass of the traced stretch of
max(FLOPs / peak FLOP/s, bytes / peak bytes/s), counted from the
configuration's shapes, / the device time of all conv kernels (ours, the
library's, and the conv wrapper's pad and weight-layout gathers), in %. None where no conv kernel ran."""

from portbench.trace import CONV_FAMILIES


def read(t):
    if not t or t["kind"] != "train":
        return None
    busy = t["summary"].seconds(CONV_FAMILIES)
    return 100.0 * t["work"].conv_bound_s / busy if busy > 0 else None
