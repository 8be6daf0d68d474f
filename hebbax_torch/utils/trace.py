"""Spans and counters inside the program, off unless a caller turns them
on.

    from hebbax_torch.utils import trace

    with trace.span("hx.step"):
        ...

Off (the default), :func:`span` returns one shared no-op context manager
and :func:`iterate` returns its argument: a site pays one check of a
module global, opens no ``record_function``, records no CUDA event and
sets no sync-debug mode.  :func:`enable` turns them on for a stretch of
a run (the epoch ``--profile_dir`` exports, or any caller's window),
:func:`disable` turns them off.  Everything stays in memory;
:func:`intervals`, :func:`counters` and :func:`report` hand it over
afterwards, and :func:`reset` drops it.

On, a span

- opens ``torch.profiler.record_function(name)``, so a running profiler's
  trace holds the span on the clock of the kernels launched inside it;
- keeps its host interval (``time.perf_counter``): name, start, end, the
  index of its parent (the innermost span open on the same thread, or
  -1), the thread and its depth;
- for :data:`STEP` and :data:`EPOCH` on a CUDA run, records a timing
  event on the current stream at entry and at exit.  The device time
  inside the epochs and outside the steps is the between-step gap: from
  an epoch's entry to its first step's entry, from each step's exit to
  the next one's entry, from the last step's exit to the epoch's exit.

On, each "called a synchronizing CUDA operation" warning counts as one
blocking sync (an ``.item()``, a ``float()`` of a device tensor, a copy
from pageable host memory), under the innermost span open on the thread
that raised it and the line that called it; a sync outside every span
is not counted.  On a CUDA run :func:`enable` sets
``torch.cuda.set_sync_debug_mode("warn")``, which raises them.

The spans the trainers open (names start with ``hx.``):

``hx.epoch``       a train epoch (``SupTrainer`` / ``SemiTrainer``)
``hx.data.next``   each ``next()`` of a train loader in those loops
``hx.prep``        ``SupTrainer.prep``, host batch to device batch
``hx.step``        the loop's call of the step (with the two CUDA events)
``hx.forward``     each model call of the step builders
``hx.optimizer``   ``engine.steps.apply_grads``
``hx.metrics``     the train metrics' ``acc.update``
``hx.epoch.read``  the epoch-end reads of the accumulated losses
``hx.fold``        the 3D space-to-depth folds and the folded layers'
                   kernel and bias builds
"""

import os
import threading
import time
import warnings

import numpy as np
import torch

STEP = "hx.step"
EPOCH = "hx.epoch"
SYNC = "sync"
# the warning torch.cuda.set_sync_debug_mode("warn") raises at each
# blocking call
SYNC_MESSAGE = "called a synchronizing CUDA operation"


class _Null:
    """The span every site gets while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()
_ON = False
_REC = None


class _Recorder:
    """What one stretch of tracing recorded."""

    def __init__(self, cuda):
        self.cuda = cuda
        self.intervals = []     # [name, start, end, parent, thread, depth]
        self.syncs = {}         # {span: n}
        self.sync_sites = {}    # {"<span> <file>:<line>": n}
        self.marks = []         # [name, entry event, host time,
        #                            exit event, host time]
        self.lock = threading.Lock()
        self.local = threading.local()
        self.restore = None

    def stack(self):
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def innermost(self):
        s = self.stack()
        return self.intervals[s[-1]][0] if s else None

    def sync(self, site):
        span = self.innermost()
        if span is None:
            return
        key = f"{span} {site}"
        with self.lock:
            self.syncs[span] = self.syncs.get(span, 0) + 1
            self.sync_sites[key] = self.sync_sites.get(key, 0) + 1


class _Span:
    __slots__ = ("rec", "name", "index", "rf", "mark")

    def __init__(self, rec, name):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        stack = rec.stack()
        self.mark = None
        if rec.cuda and self.name in (STEP, EPOCH):
            self.mark = [self.name, *_event(), None, None]
        with rec.lock:
            self.index = len(rec.intervals)
            rec.intervals.append([self.name, time.perf_counter(), None,
                                  stack[-1] if stack else -1,
                                  threading.get_ident(), len(stack)])
        stack.append(self.index)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if self.mark is not None:
            self.mark[3:] = _event()
            with rec.lock:
                rec.marks.append(self.mark)
        rec.intervals[self.index][2] = time.perf_counter()
        rec.stack().pop()
        self.rf.__exit__(None, None, None)
        return False


def _event():
    """A timing event recorded now on the current stream, and the host
    time just before."""
    ev = torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    ev.record()
    return [ev, t]


def span(name):
    """A context manager around one call site's work (module docstring)."""
    if not _ON:
        return _NULL
    return _Span(_REC, name)


def iterate(iterable, name):
    """``iterable`` itself while tracing is off; on, a generator over it
    that takes each ``next()`` inside ``span(name)`` (the last one, which
    ends the iteration, too)."""
    if not _ON:
        return iterable
    return _spanned(iterable, name)


def _spanned(iterable, name):
    it = iter(iterable)
    end = object()
    while True:
        with span(name):
            item = next(it, end)
        if item is end:
            return
        yield item


def _site(filename, lineno):
    parts = filename.replace(os.sep, "/").split("/")
    if "hebbax_torch" in parts:
        parts = parts[len(parts) - parts[::-1].index("hebbax_torch"):]
    else:
        parts = parts[-1:]
    return f"{'/'.join(parts)}:{lineno}"


def enable(cuda=False):
    """Turns tracing on with an empty record; ``cuda``: the run is on a
    card (step and epoch events, the sync-debug mode)."""
    global _ON, _REC
    if _ON:
        disable()
    rec = _Recorder(cuda)
    catcher = warnings.catch_warnings()
    catcher.__enter__()
    warnings.filterwarnings("always", message=SYNC_MESSAGE)
    shown = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        if str(message).startswith(SYNC_MESSAGE):
            rec.sync(_site(filename, lineno))
        else:
            shown(message, category, filename, lineno, file, line)

    warnings.showwarning = show
    mode = None
    if cuda:
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
    rec.restore = (catcher, mode)
    _REC, _ON = rec, True


def disable():
    """Turns tracing off; what it recorded stays until :func:`reset` or
    the next :func:`enable`."""
    global _ON
    if not _ON:
        return
    _ON = False
    catcher, mode = _REC.restore
    if mode is not None:
        torch.cuda.set_sync_debug_mode(mode)
    catcher.__exit__(None, None, None)


def enabled():
    """Whether tracing is on."""
    return _ON


def reset():
    """Turns tracing off and drops what it recorded."""
    global _REC
    disable()
    _REC = None


def intervals():
    """The host intervals, in the order the spans opened: tuples (name,
    start, end, parent index or -1, thread, depth); a span still open
    has end None."""
    return [] if _REC is None else [tuple(iv) for iv in _REC.intervals]


def counters():
    """{counter: {span: n}}; :data:`SYNC` counts the blocking syncs."""
    return {SYNC: dict(_REC.syncs)} if _REC and _REC.syncs else {}


def gaps():
    """[(host time, device ms)] of every between-step gap recorded
    (:func:`between_steps`; a CUDA run, waits for the last event)."""
    if _REC is None or not _REC.marks:
        return []
    last = max(_REC.marks, key=lambda m: m[4])
    last[3].synchronize()
    return between_steps(_REC.marks)


def between_steps(marks):
    """The between-step gaps of ``marks`` ([name, entry event, host time,
    exit event, host time] of :data:`STEP` and :data:`EPOCH` spans), in
    order: (host time at which the event closing the gap was recorded,
    device ms).  A gap opens at an epoch's entry or a step's exit and
    closes at the next step's entry or epoch's exit."""
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
    closing the gap was recorded.  A device with nothing queued
    completes that event when the host records it, so the gap lies in
    host time at [entry - ms, entry].  ``spans``: [(name, start, end,
    depth)] of the thread that recorded the events.  Returns {name: ms}:
    each instant of a gap goes to the deepest span holding it, ``""``
    where none does."""
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


def report():
    """Everything recorded, summed: ``cuda`` (the sync-debug mode was on
    and events were taken), ``steps`` (closed :data:`STEP` spans),
    ``spans`` ({name: {"n", "host_ms"}} over closed spans), ``counters``,
    ``sync_sites`` ({"<span> <file>:<line>": n}) and, on a CUDA run,
    ``event_ms`` ({"steps", "epochs"}: the device time between each
    span's entry and exit events, summed) and ``gaps`` ({"n",
    "device_ms", "by_span"}: the between-step gaps of :func:`gaps`, split
    by :func:`attribute_gaps` among the spans of the thread that ran the
    steps).  Empty when nothing was recorded."""
    if _REC is None:
        return {}
    ivs = intervals()
    spans = {}
    for name, start, end, *_ in ivs:
        if end is not None:
            s = spans.setdefault(name, {"n": 0, "host_ms": 0.0})
            s["n"] += 1
            s["host_ms"] += (end - start) * 1e3
    out = {"cuda": _REC.cuda, "steps": spans.get(STEP, {"n": 0})["n"],
           "spans": spans, "counters": counters(),
           "sync_sites": dict(_REC.sync_sites)}
    found = gaps()
    if found:
        out["event_ms"] = {
            key: sum(m[1].elapsed_time(m[3]) for m in _REC.marks
                     if m[0] == name)
            for key, name in (("steps", STEP), ("epochs", EPOCH))}
        thread = next(iv[4] for iv in ivs if iv[0] in (STEP, EPOCH))
        mine = [(n, s, e, d) for n, s, e, _, t, d in ivs
                if t == thread and e is not None]
        out["gaps"] = {"n": len(found),
                       "device_ms": sum(ms for _, ms in found),
                       "by_span": attribute_gaps(found, mine)}
    return out
