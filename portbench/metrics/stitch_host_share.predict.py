"""stitch_host_share.predict: the card's idle seconds in the stitcher's
host-only phases, ``stitch.pad`` (numpy's symmetric pad before the upload)
and ``stitch.normalize`` (numpy's min-max after the download), / the window's
seconds, in %, over the volume traced with the host's operators: its idle
gaps are named by the innermost host event covering each gap's middle, and
the program's spans are host events there. None where no gap carries either
name (a program without the spans)."""

HOST_PHASES = ("stitch.pad", "stitch.normalize")


def read(t):
    if not t or t["kind"] != "predict" or not t.get("labelled"):
        return None
    s = t["labelled"]
    idle = [sec for name, sec in s.idle_gaps if name in HOST_PHASES]
    return 100.0 * sum(idle) / s.window_s if idle else None
