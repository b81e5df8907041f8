"""batchnorm_ms.train: the device ms a traced train step spends in the
library's batch norm kernels (``trace.FAMILIES``' "batch norm (library)",
forward and backward: the statistics, the normalisation and the gradient),
in ms a step. None where no batch norm kernel ran."""

FAMILY = "batch norm (library)"


def read(t):
    if not t or t["kind"] != "train":
        return None
    s = t["summary"].seconds((FAMILY,))
    return s / t["steps"] * 1e3 if s > 0 else None
