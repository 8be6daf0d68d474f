"""The reading of the program's own spans in a finished profile.

The port opens ``torch.profiler.record_function`` ranges named ``hx.*``
when its tracing module (``hebbax_torch.utils.trace``) is on: the epoch,
each loader ``next()``, ``prep``, the step, each model call, the
optimizer, the metrics, the epoch's end reads and the space-to-depth
folds.  :func:`read_program` gives the device ms per step under each of
them, a backward node's work going to the span that made the node.

A traced run of the harness turns the program's tracing on for its
window and hands this reading of its profiled span to the per-layer
readers as ``ctx.program``; a program that opens no ``hx.*`` span gives
None.

Over the whole window, the harness takes from the program only its raw
record: the host intervals of its spans and its per-span count of
blocking syncs.  The between-step gaps come from the benchmark's own
timing events (:class:`Marks`) around each step and epoch the window
calls; :func:`read_record` pairs them (:func:`between_steps`) and splits
them among the program's spans (:func:`attribute_gaps`)."""

import bisect
import time

import numpy as np
import torch

from .trace import _is_device

PROGRAM = "hx."
BACKWARD = "autograd::engine::evaluate_function: "


def _merged(iv):
    """Sorted intervals, overlapping ones merged (a span opened inside one
    of the same name)."""
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return ([s for s, _ in out], out)


class ProgramOwners:
    """Which of the program's spans own each host event of a profile.

    ``direct(e)``: the ``hx.*`` ranges open on ``e``'s own thread when it
    started.  ``created(e)``: those, and for an event inside a backward
    node (``autograd::engine::evaluate_function: <Node>``, on the
    autograd thread) the ranges that held the forward op that made the
    node, found by the node's ``sequence_nr`` and ``fwd_thread_id``: the
    backward work goes to the span that created it."""

    def __init__(self, events):
        ranges, nodes = {}, {}
        host = [e for e in events if not _is_device(e)]
        for e in host:
            name = e.name()
            iv = (e.start_ns(), e.start_ns() + e.duration_ns())
            if name.startswith(PROGRAM):
                ranges.setdefault((e.start_thread_id(), name), []).append(iv)
            elif name.startswith(BACKWARD) and e.sequence_nr() >= 0:
                nodes.setdefault(e.start_thread_id(), []).append(
                    iv + ((e.fwd_thread_id(), e.sequence_nr()),))
        self._ranges = {k: _merged(v) for k, v in ranges.items()}
        self._nodes = {t: ([n[0] for n in v], v) for t, v in (
            (t, sorted(v)) for t, v in nodes.items())}
        self._forward = {}
        for e in host:
            if (e.sequence_nr() >= 0 and not e.fwd_thread_id()
                    and not e.name().startswith(BACKWARD)):
                key = (e.start_thread_id(), e.sequence_nr())
                if key not in self._forward:
                    self._forward[key] = self._open(key[0], e.start_ns())

    def _open(self, thread, t):
        out = set()
        for (th, name), (starts, iv) in self._ranges.items():
            if th != thread or name in out:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and iv[i][0] <= t <= iv[i][1]:
                out.add(name)
        return out

    def direct(self, e):
        return self._open(e.start_thread_id(), e.start_ns())

    def created(self, e):
        out = self.direct(e)
        thread, t = e.start_thread_id(), e.start_ns()
        starts, nodes = self._nodes.get(thread, ((), ()))
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and nodes[i][0] <= t <= nodes[i][1]:
            out |= self._forward.get(nodes[i][2], set())
        return out


def read_program(prof, n_steps):
    """Device ms per step under each of the program's ``hx.*`` spans, from
    a finished ``torch.profiler.profile`` over ``n_steps`` steps: a device
    operation goes to the host op that launched it (its linked
    correlation id), and through it to the spans that own that op
    (:class:`ProgramOwners`).  ``under_ms`` counts launches made inside a
    span on the same thread, ``created_ms`` adds the backward work of the
    ops made inside it; ``created_ops`` the three heaviest operations of
    each span by that count.  None where the profile holds no device
    operation or no program span."""
    events = list(prof.profiler.kineto_results.events())
    owners = ProgramOwners(events)
    ops = {}
    for e in events:
        if (not _is_device(e) and not e.linked_correlation_id()
                and not e.name().startswith("cu")):
            ops.setdefault(e.correlation_id(), e)
    under, created, by_op = {}, {}, {}
    total = attributed = 0
    for e in events:
        if not _is_device(e) or e.is_user_annotation() or e.name().startswith(
                (PROGRAM, "pb.")):
            continue
        dur = e.duration_ns()
        total += dur
        op = ops.get(e.linked_correlation_id())
        if op is None:
            continue
        attributed += dur
        for name in owners.direct(op):
            under[name] = under.get(name, 0) + dur
        for name in owners.created(op):
            created[name] = created.get(name, 0) + dur
            mine = by_op.setdefault(name, {})
            mine[e.name()] = mine.get(e.name(), 0) + dur
    if not total or not created:
        return None
    return {"steps": n_steps,
            "under_ms": {k: v / 1e6 / n_steps for k, v in under.items()},
            "created_ms": {k: v / 1e6 / n_steps for k, v in created.items()},
            "created_ops": {k: [[n, v / 1e6 / n_steps] for n, v in sorted(
                mine.items(), key=lambda kv: -kv[1])[:3]]
                for k, mine in by_op.items()},
            "attributed": attributed / total}


STEP, EPOCH = "step", "epoch"


class Marks:
    """Timing events on the current stream at the entry and exit of each
    call that :meth:`wrap` wraps (the window's steps and epochs), each
    with the host time just before it was recorded."""

    def __init__(self):
        self.marks = []     # [name, entry event, host time,
        #                      exit event, host time]

    def wrap(self, fn, name):
        def marked(*a, **kw):
            entry = _event()
            out = fn(*a, **kw)
            self.marks.append([name, *entry, *_event()])
            return out
        return marked

    def gaps(self):
        """:func:`between_steps` of the marks, once the last has
        completed."""
        if not self.marks:
            return []
        max(self.marks, key=lambda m: m[4])[3].synchronize()
        return between_steps(self.marks)


def _event():
    ev = torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    ev.record()
    return [ev, t]


def between_steps(marks):
    """The between-step gaps of ``marks`` (:class:`Marks`), in order: (host
    time at which the event closing the gap was recorded, device ms).  A
    gap opens at an epoch's entry or a step's exit and closes at the next
    step's entry or epoch's exit."""
    ends = []
    for name, ev_in, t_in, ev_out, t_out in marks:
        ends.append((t_in, ev_in, name == STEP))
        ends.append((t_out, ev_out, name == EPOCH))
    ends.sort(key=lambda m: m[0])
    return [(t, max(0.0, ev.elapsed_time(nxt)))
            for (_, ev, closes), (t, nxt, closes_next) in zip(ends, ends[1:])
            if not closes and closes_next]


def attribute_gaps(gaps, spans):
    """Splits device gaps among the host spans the thread was in.

    ``gaps``: [(entry, ms)], ``entry`` the host time at which the event
    closing the gap was recorded.  A device with nothing queued completes
    that event when the host records it, so the gap lies in host time at
    [entry - ms, entry].  ``spans``: [(name, start, end, depth)] of the
    thread that recorded the events.  Returns {name: ms}: each instant of
    a gap goes to the deepest span holding it, ``""`` where none does."""
    out = {}
    if not gaps:
        return out
    names = [s[0] for s in spans]
    starts = np.array([s[1] for s in spans], dtype=np.float64)
    ends = np.array([s[2] for s in spans], dtype=np.float64)
    depth = np.array([s[3] for s in spans], dtype=np.int64)
    for entry, ms in gaps:
        a, b = entry - ms / 1e3, entry
        if b <= a:
            continue
        near = np.nonzero((starts < b) & (ends > a))[0]
        cuts = sorted({a, b} | {float(t) for i in near
                                for t in (starts[i], ends[i]) if a < t < b})
        for p, q in zip(cuts, cuts[1:]):
            mid = (p + q) / 2
            holding = [i for i in near if starts[i] <= mid < ends[i]]
            name = (names[max(holding, key=lambda i: depth[i])]
                    if holding else "")
            out[name] = out.get(name, 0.0) + (q - p) * 1e3
    return out


def read_record(intervals, syncs, gaps, thread, cuda):
    """The window's reading of the program's raw record.

    ``intervals``: the program's span intervals (``hebbax_torch.utils.
    trace.intervals()``: name, start, end, parent, thread, depth);
    ``syncs``: its blocking syncs by innermost span ({span: n}); ``gaps``:
    :meth:`Marks.gaps`; ``thread``: the thread that ran the window;
    ``cuda``: the run was on a card, where the program raises its syncs.
    Returns ``cuda``, ``spans`` ({name: {"n", "host_ms"}} over closed
    spans), ``syncs`` and, where there are gaps, ``gaps`` ({"n",
    "device_ms", "by_span"}: split by :func:`attribute_gaps` among the
    spans of ``thread``)."""
    spans = {}
    for name, start, end, *_ in intervals:
        if end is not None:
            s = spans.setdefault(name, {"n": 0, "host_ms": 0.0})
            s["n"] += 1
            s["host_ms"] += (end - start) * 1e3
    out = {"cuda": cuda, "spans": spans, "syncs": dict(syncs)}
    if gaps:
        mine = [(n, s, e, d) for n, s, e, _, t, d in intervals
                if t == thread and e is not None]
        out["gaps"] = {"n": len(gaps),
                       "device_ms": sum(ms for _, ms in gaps),
                       "by_span": attribute_gaps(gaps, mine)}
    return out
