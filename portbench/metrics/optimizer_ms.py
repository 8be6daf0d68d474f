"""Device ms per step launched inside the program's ``hx.optimizer`` span
(``engine.steps.apply_grads``: the gradients set, the optimizer's step),
from the profiled span of the traced window (``ctx.program["under_ms"]``)."""

LAYER = "train step"
MOVES = "train_samples_per_s"


def read(ctx):
    p = ctx.program
    if p is None:
        return None
    return p["under_ms"].get("hx.optimizer")
