"""Device ms per step launched inside ``trainer.train_step`` outside the
model's forward: the loss, the backward, the gradient merge and the
optimizer, from the profiled span of the traced window."""

LAYER = "train step"
MOVES = "train_samples_per_s"


def read(ctx):
    p = ctx.profile
    if p is None or not p["under_ms"]["pb.step"]:
        return None
    return p["under_ms"]["pb.step"] - p["under_ms"]["pb.forward"]
