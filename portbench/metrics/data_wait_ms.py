"""Host ms per step that the trainer waited in ``next()`` of the loaders
handed to it (the port's ``Loader`` or ``PatchQueue``), over the whole
traced window."""

LAYER = "data"
MOVES = "train_samples_per_s"


def read(ctx):
    if not ctx.steps:
        return None
    return ctx.data_wait_s / ctx.steps * 1e3
