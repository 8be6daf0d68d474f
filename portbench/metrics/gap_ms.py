"""Device ms per step between the steps: inside the window's epochs and
outside its steps, by the benchmark's timing events around each
``trainer.train_epoch`` and ``trainer.train_step`` call, over the whole
traced window (``ctx.program_report["gaps"]``); none off the card."""

LAYER = "device"
MOVES = "train_samples_per_s"


def read(ctx):
    r = ctx.program_report
    if not r or "gaps" not in r or not ctx.steps:
        return None
    return r["gaps"]["device_ms"] / ctx.steps
