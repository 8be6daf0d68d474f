"""Device ms per step launched inside the model's forward (both passes of
an EM step), from the profiled span of the traced window."""

LAYER = "model"
MOVES = "train_samples_per_s"


def read(ctx):
    p = ctx.profile
    if p is None or not p["under_ms"]["pb.forward"]:
        return None
    return p["under_ms"]["pb.forward"]
