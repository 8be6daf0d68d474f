"""The step's model FLOPs (``portbench.counts.step_flops``: the unfolded
network's convolutions and the backward the step needs) times the steps
of the profiled span, over the span's length in the device trace (its
first operation's start to its last one's end) times 495 TFLOP/s, in
%."""

LAYER = "device"
MOVES = "train_samples_per_s"


def read(ctx):
    p = ctx.profile
    if p is None or not p["steps"] or not p["span_s"]:
        return None
    return 100.0 * ctx.step_flops * p["steps"] / (p["span_s"] * ctx.peak_flops)
