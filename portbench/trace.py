"""The traced run's instruments and the reading of its profile.

Ranges (``torch.profiler.record_function``) are opened by the benchmark
around its calls into the port, only in a traced run: ``pb.step`` around
``trainer.train_step``, ``pb.forward`` around the model's forward (a
forward pre-hook and hook), ``pb.delta`` around each call of
``hebbax_torch.hebb.rules.compute_delta`` (a Hebbian conv's delta, inside
its layer's forward), ``pb.prep`` around ``trainer.prep``, ``pb.data_wait``
around each ``next()`` of a loader handed to the trainer and
``pb.epoch`` around ``trainer.train_epoch``.

A device operation (kernel, copy or fill) belongs to every range whose
host interval holds the runtime call that launched it (CUPTI's
correlation id ties the two).

The same profile also holds the program's own ``hx.*`` ranges, which a
traced run turns on for its window: :func:`read` skips them and reads
the ``pb.*`` ones alone, and :func:`portbench.program_trace.read_program`
reads the ``hx.*`` ones beside it."""

import bisect

import torch

RANGES = ("pb.step", "pb.forward", "pb.delta", "pb.prep", "pb.data_wait",
          "pb.epoch")
# what the host was doing in an idle gap, innermost range first
GAP_LABELS = (("pb.data_wait", "data_wait"), ("pb.prep", "prep"),
              ("pb.delta", "delta_dispatch"),
              ("pb.forward", "step_dispatch"),
              ("pb.step", "step_dispatch"),
              ("pb.epoch", "loop_and_epoch_end_read"))


def span(name):
    return torch.profiler.record_function(name)


class Instruments:
    """Installs the ranges on a trainer and its model; ``remove()`` puts
    back what it replaced."""

    def __init__(self, trainer, model):
        self._undo = []
        stack = []

        def pre(module, args):
            r = span("pb.forward")
            r.__enter__()
            stack.append(r)

        def post(module, args, out):
            stack.pop().__exit__(None, None, None)

        h1 = model.register_forward_pre_hook(pre)
        h2 = model.register_forward_hook(post)
        self._undo += [h1.remove, h2.remove]

        real_epoch = trainer.train_epoch

        def train_epoch(*a, **kw):
            with span("pb.epoch"):
                return real_epoch(*a, **kw)

        trainer.train_epoch = train_epoch
        self._undo.append(lambda: delattr(trainer, "train_epoch"))

        from hebbax_torch.hebb import rules
        real_delta = rules.compute_delta

        def compute_delta(*a, **kw):
            with span("pb.delta"):
                return real_delta(*a, **kw)

        rules.compute_delta = compute_delta
        self._undo.append(lambda: setattr(rules, "compute_delta",
                                          real_delta))

    def remove(self):
        for f in reversed(self._undo):
            f()
        self._undo = []


def warm_profiler(activities):
    """Start and stop the profiler once, so its first start (CUPTI's
    set-up) falls in the set-up and not in the window."""
    with torch.profiler.profile(activities=activities):
        torch.zeros(8, device="cuda" if torch.cuda.is_available() else
                    "cpu").add_(1)
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def _is_device(e):
    return str(e.device_type()).endswith("CUDA")


def read(prof, n_steps):
    """Per-step device ms under each range, the device's busy seconds and
    the span's length, the heaviest operations and the longest idle gaps,
    from a finished ``torch.profiler.profile`` over ``n_steps`` steps."""
    ranges = {r: [] for r in RANGES}
    launches = {}
    ops = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if _is_device(e):
            if e.is_user_annotation() or name.startswith("pb."):
                continue
            ops.append((e.start_ns(), e.start_ns() + e.duration_ns(), name,
                        e.correlation_id()))
        elif name in ranges:
            ranges[name].append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif name.startswith("cu") and e.correlation_id():
            launches[e.correlation_id()] = e.start_ns()
    if not ops:
        return None
    index = {}
    for r, iv in ranges.items():
        iv.sort()
        index[r] = ([s for s, _ in iv], iv)

    def inside(r, t):
        starts, iv = index[r]
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and iv[i][0] <= t <= iv[i][1]

    under = {r: 0 for r in RANGES}
    by_name = {}
    attributed = 0
    for s, e, name, corr in ops:
        dur = e - s
        by_name[name] = by_name.get(name, 0) + dur
        t = launches.get(corr)
        if t is None:
            continue
        attributed += dur
        for r in RANGES:
            if inside(r, t):
                under[r] += dur
    ops.sort()
    busy, gaps = 0, []
    cur_s, cur_e = ops[0][0], ops[0][1]
    for s, e, _, _ in ops[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span_ns = cur_e - ops[0][0]

    def label(t):
        for r, lab in GAP_LABELS:
            if inside(r, t):
                return lab
        return "outside_the_loop"

    gaps.sort(key=lambda g: g[0] - g[1])
    total = sum(e - s for s, e, *_ in ops)
    return {
        "steps": n_steps,
        "under_ms": {r: v / 1e6 / n_steps for r, v in under.items()},
        "busy_s": busy / 1e9,
        "span_s": span_ns / 1e9,
        "attributed": attributed / max(total, 1),
        "device_ops": [[n, v / 1e9] for n, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[label((a + b) / 2), (b - a) / 1e9]
                      for a, b in gaps[:10]],
    }
