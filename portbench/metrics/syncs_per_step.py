"""Blocking syncs per step inside the program's ``hx.*`` spans (an
``.item()``, a ``float()`` of a device tensor, a copy from pageable
memory), as the program counts them by span, over the whole traced
window (``ctx.program_report["syncs"]``); none off the card, where the
sync-debug mode that raises them is not set."""

LAYER = "trainer"
MOVES = "train_samples_per_s"


def read(ctx):
    r = ctx.program_report
    if not r or not r["cuda"] or not ctx.steps:
        return None
    return sum(r["syncs"].values()) / ctx.steps
