"""idle_share.predict: 1 - (the device's busy time / the traced window's time),
from one profiler window over the predict stretch, in %."""


def read(t):
    if not t or t["kind"] != "predict":
        return None
    s = t["summary"]
    return 100.0 * (1.0 - s.busy_s / s.window_s)
