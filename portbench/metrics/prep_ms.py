"""Host ms per step in ``trainer.prep`` (host batch to device batch), over
the whole traced window."""

LAYER = "trainer"
MOVES = "train_samples_per_s"


def read(ctx):
    if not ctx.steps or ctx.prep_s is None:
        return None
    return ctx.prep_s / ctx.steps * 1e3
