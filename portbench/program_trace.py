"""The reading of the program's own spans in a finished profile.

The port opens ``torch.profiler.record_function`` ranges named ``hx.*``
when its tracing module (``hebbax_torch.utils.trace``) is on: the epoch,
each loader ``next()``, ``prep``, the step, each model call, the
optimizer, the metrics, the epoch's end reads and the space-to-depth
folds.  :func:`read_program` gives the device ms per step under each of
them, a backward node's work going to the span that made the node.

``harness.py`` does not call it yet: a traced run there leaves the
program's tracing off, so its profile holds no ``hx.*`` range and this
reading gives None."""

import bisect

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
