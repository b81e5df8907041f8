"""mfu.train: the model FLOPs of the traced train steps (every conv's forward
and the backward passes the step needs, counted from the configuration's
shapes) / the traced window's time / the card's peak bf16 rate, in %."""

from portbench.work import peaks


def read(t):
    if not t or t["kind"] != "train":
        return None
    return 100.0 * t["work"].conv_flops / t["summary"].window_s / peaks()["bf16_flops_per_s"]
