"""Device ms per step of the operations made under the program's
``hx.fold`` spans (the 3D space-to-depth folds and the folded layers'
kernel and bias builds), their backward included, from the profiled
span of the traced window (``ctx.program["created_ms"]``)."""

LAYER = "model"
MOVES = "train_samples_per_s"


def read(ctx):
    p = ctx.program
    if p is None:
        return None
    return p["created_ms"].get("hx.fold")
