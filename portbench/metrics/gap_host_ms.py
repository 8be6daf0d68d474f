"""The part of ``gap_ms`` in which the host was not inside the program's
``hx.data.next`` span (a ``next()`` of the train loaders): the batch's
preparation, the blocking syncs, the loop and the launches; device ms
per step over the whole traced window
(``ctx.program_report["gaps"]``); none off the card."""

LAYER = "trainer"
MOVES = "train_samples_per_s"


def read(ctx):
    r = ctx.program_report
    if not r or "gaps" not in r or not ctx.steps:
        return None
    g = r["gaps"]
    return (g["device_ms"] - g["by_span"].get("hx.data.next", 0.0)) / ctx.steps
