"""mfu.predict: the model FLOPs of gen_IS over every unique patch of the
traced volume / the traced window's time / the card's peak bf16 rate, in %."""

from portbench.work import peaks


def read(t):
    if not t or t["kind"] != "predict":
        return None
    return 100.0 * t["work"].conv_flops / t["summary"].window_s / peaks()["bf16_flops_per_s"]
