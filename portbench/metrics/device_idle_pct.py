"""The share of the profiled span (first device operation's start to the
last one's end) in which no operation ran on the device, in %."""

LAYER = "device"
MOVES = "train_samples_per_s"


def read(ctx):
    p = ctx.profile
    if p is None or not p["span_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["span_s"])
