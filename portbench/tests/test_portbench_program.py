"""The reading of the program's own spans
(``program_trace.read_program``, ``program_trace.ProgramOwners``) on the
CPU: on a real profile of a tiny forward
and backward, a ``permute`` inside ``hx.fold`` and the backward node it
made both belong to ``hx.fold``; on a profile made of stand-in events
with device operations, the backward's kernels count under the span that
made their node, and ``trace.read``'s readings are those of the same
profile without the program's spans; the benchmark's pairing of its
step and epoch events into between-step gaps, their split among the
program's spans and the reading of the program's record; the five
readers of the program's spans and sync counts read their numbers from
the readers' context, and None where it has none (the CPU, a program
without spans)."""

import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hebbax_torch.utils import trace as program
from portbench import program_trace, spec, trace

from . import standin


def _cpu_profile():
    x = torch.randn(2, 3, 4, requires_grad=True)
    program.enable(cuda=False)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with program.span("hx.step"):
                with program.span("hx.fold"):
                    y = x.permute(0, 2, 1)
                loss = (y.reshape(2, 12) * 3.0).sum()
                torch.autograd.grad(loss, [x])
    finally:
        program.reset()
    return prof


def test_a_permute_and_its_backward_belong_to_the_fold():
    events = list(_cpu_profile().profiler.kineto_results.events())
    owners = program_trace.ProgramOwners(events)
    fwd = [e for e in events if e.name() == "aten::permute"
           and e.sequence_nr() >= 0]
    bwd = [e for e in events if e.name() == (
        program_trace.BACKWARD + "PermuteBackward0")]
    assert len(fwd) == 1 and len(bwd) == 1
    assert owners.created(fwd[0]) == owners.direct(fwd[0]) == {
        "hx.step", "hx.fold"}
    assert "hx.fold" in owners.created(bwd[0])
    # the ops the node runs (a permute back) belong to the fold too
    inner = [e for e in events if e.name() == "aten::permute"
             and e.sequence_nr() < 0 and e.start_ns() >= bwd[0].start_ns()]
    assert inner and all("hx.fold" in owners.created(e) for e in inner)
    # the loss's multiply was made outside the fold: its backward is not
    mul = [e for e in events
           if e.name() == program_trace.BACKWARD + "MulBackward0"]
    assert mul and all("hx.fold" not in owners.created(e) for e in mul)


class _Event:
    """A stand-in for a profiler event, with the accessors the readers
    use."""

    def __init__(self, name, start, dur, device=False, thread=1, corr=0,
                 linked=0, seq=-1, fwd=0, annotation=False):
        self._v = dict(name=name, start=start, dur=dur, device=device,
                       thread=thread, corr=corr, linked=linked, seq=seq,
                       fwd=fwd, annotation=annotation)

    def name(self):
        return self._v["name"]

    def device_type(self):
        return "DeviceType.CUDA" if self._v["device"] else "DeviceType.CPU"

    def start_ns(self):
        return self._v["start"]

    def duration_ns(self):
        return self._v["dur"]

    def start_thread_id(self):
        return self._v["thread"]

    def correlation_id(self):
        return self._v["corr"]

    def linked_correlation_id(self):
        return self._v["linked"]

    def sequence_nr(self):
        return self._v["seq"]

    def fwd_thread_id(self):
        return self._v["fwd"]

    def is_user_annotation(self):
        return self._v["annotation"]


def _events(with_program):
    """Two steps: a forward op inside ``hx.fold`` (sequence 7), a backward
    node made by it on the autograd thread, an optimizer op inside
    ``hx.optimizer``; each op launches one kernel (runtime call, kernel
    and, on the card, the range's device-side copy)."""
    ev = []
    corr = [100]

    def op(name, start, dur, thread=1, seq=-1, fwd=0, kernel=None):
        corr[0] += 1
        ev.append(_Event(name, start, dur, thread=thread, corr=corr[0],
                         seq=seq, fwd=fwd))
        if kernel is not None:
            k0, kd = kernel
            ev.append(_Event("cudaLaunchKernel", start + 1, 2, thread=thread,
                             corr=corr[0] + 1000, linked=corr[0]))
            ev.append(_Event("kernel_" + name, k0, kd, device=True,
                             corr=corr[0] + 1000, linked=corr[0]))

    def rng(name, start, dur, thread=1):
        if with_program:
            op(name, start, dur, thread=thread)
            ev[-1]._v["annotation"] = True
            ev.append(_Event(name, start + 5, dur, device=True,
                             annotation=True))

    for k in range(2):
        t = 10_000 * k
        ev.append(_Event("pb.step", t, 9_000))
        rng("hx.step", t + 10, 8_900)
        rng("hx.fold", t + 100, 400)
        op("aten::mul", t + 150, 200, seq=7 + 10 * k,
           kernel=(t + 1_000, 500))
        op(program_trace.BACKWARD + "MulBackward0", t + 3_000, 800,
           thread=2, seq=7 + 10 * k, fwd=1)
        op("aten::mul_bwd", t + 3_100, 300, thread=2,
           kernel=(t + 3_500, 1_500))
        rng("hx.optimizer", t + 6_000, 500)
        op("aten::add_", t + 6_100, 200, kernel=(t + 6_300, 250))
    return ev


def _prof(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


def test_read_program_puts_backward_kernels_under_the_span_that_made_them():
    got = program_trace.read_program(_prof(_events(True)), 2)
    assert got["created_ms"]["hx.fold"] == (500 + 1_500) / 1e6
    assert got["under_ms"]["hx.fold"] == 500 / 1e6
    assert got["created_ms"]["hx.optimizer"] == 250 / 1e6
    assert got["under_ms"]["hx.step"] == (500 + 250) / 1e6
    assert got["created_ms"]["hx.step"] == (500 + 1_500 + 250) / 1e6
    assert got["attributed"] == 1.0
    # a program without spans gives nothing to read
    assert program_trace.read_program(_prof(_events(False)), 2) is None


def test_trace_read_is_unchanged_by_the_program_spans():
    with_spans = trace.read(_prof(_events(True)), 2)
    assert with_spans == trace.read(_prof(_events(False)), 2)
    assert with_spans["under_ms"]["pb.step"] == (500 + 1_500 + 250) / 1e6
    assert trace.read(_cpu_profile(), 2) is None


def test_read_program_names_each_spans_heaviest_operations():
    got = program_trace.read_program(_prof(_events(True)), 2)
    assert got["created_ops"]["hx.fold"] == [["kernel_aten::mul_bwd", 1.5e-3],
                                             ["kernel_aten::mul", 5e-4]]
    assert got["created_ops"]["hx.optimizer"] == [
        ["kernel_aten::add_", 2.5e-4]]


class _Ev:
    """A stand-in for a CUDA timing event: its device time in ms."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


def _mark(name, t_in, t_out, dev_in=None, dev_out=None):
    return [name, _Ev(t_in * 1e3 if dev_in is None else dev_in), t_in,
            _Ev(t_out * 1e3 if dev_out is None else dev_out), t_out]


STEP, EPOCH = program_trace.STEP, program_trace.EPOCH


def test_between_step_gaps_run_from_epoch_entry_to_epoch_exit():
    marks = [
        _mark(EPOCH, 0.0, 4.0),
        _mark(STEP, 0.5, 1.0, dev_out=1600.0),     # device ran late
        _mark(STEP, 1.2, 2.0, dev_in=1600.0),      # ... into this one
        _mark(STEP, 2.3, 3.5),
        _mark(EPOCH, 4.1, 6.0),
        _mark(STEP, 5.0, 5.8),
    ]
    got = program_trace.between_steps(marks)
    # epoch 1: its lead-in, the run-ahead step (no gap), the wait before
    # step 3, its tail; between the epochs, none; epoch 2: lead-in, tail
    assert [t for t, _ in got] == [0.5, 1.2, 2.3, 4.0, 5.0, 6.0]
    assert [round(ms, 6) for _, ms in got] == [
        500.0, 0.0, 300.0, 500.0, 900.0, 200.0]


# host spans of one thread: (name, start, end, depth), in seconds
SPANS = [("hx.epoch", 0.0, 9.4, 0),
         ("hx.data.next", 1.0, 2.0, 1), ("hx.prep", 2.0, 2.5, 1),
         ("hx.step", 2.5, 5.0, 1), ("hx.metrics", 5.0, 5.2, 1),
         ("hx.data.next", 5.2, 6.2, 1), ("hx.prep", 6.2, 6.4, 1),
         ("hx.step", 6.4, 9.0, 1), ("hx.epoch.read", 9.0, 9.3, 1),
         ("hx.epoch", 9.5, 20.0, 0),
         ("hx.data.next", 9.6, 10.6, 1), ("hx.step", 10.7, 12.0, 1)]


@pytest.mark.parametrize("gaps,want", [
    # the device idles through the metrics' sync, the loader and prep
    ([(6.4, 1300.0)], {"hx.metrics": 100.0, "hx.data.next": 1000.0,
                       "hx.prep": 200.0}),
    # a gap longer than the loader's interval: the loader keeps its own
    # 1000 ms, the rest goes to the spans around it
    ([(6.4, 2000.0)], {"hx.step": 600.0, "hx.metrics": 200.0,
                       "hx.data.next": 1000.0, "hx.prep": 200.0}),
    # the epoch boundary: the end read, the loop between epochs (outside
    # every span) and the next epoch's first batch
    ([(10.7, 1500.0)], {"hx.epoch.read": 100.0, "hx.epoch": 300.0,
                        "": 100.0, "hx.data.next": 1000.0}),
    # a host that ran ahead leaves no gap to split
    ([(6.4, 0.0), (10.7, 0.0)], {}),
], ids=["metrics_data_prep", "longer_than_data", "epoch_end", "none"])
def test_gaps_split_among_the_innermost_host_spans(gaps, want):
    got = program_trace.attribute_gaps(gaps, SPANS)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-6)
    assert sum(got.values()) == pytest.approx(sum(ms for _, ms in gaps))


def test_read_record_sums_the_spans_and_splits_the_window_thread_gaps():
    ivs = [(n, a, b, -1, 7, d) for n, a, b, d in SPANS]
    # another thread's span and a span still open count in neither split
    ivs += [("hx.data.next", 6.0, 6.4, -1, 8, 1),
            ("hx.step", 12.5, None, -1, 7, 1)]
    got = program_trace.read_record(ivs, {"hx.metrics": 2}, [(6.4, 1300.0)],
                                    7, True)
    assert got["cuda"] is True and got["syncs"] == {"hx.metrics": 2}
    assert got["spans"]["hx.step"]["n"] == 3
    assert got["spans"]["hx.data.next"]["n"] == 4
    assert got["spans"]["hx.epoch"]["host_ms"] == pytest.approx(19_900.0)
    assert got["gaps"]["n"] == 1 and got["gaps"]["device_ms"] == 1300.0
    assert got["gaps"]["by_span"] == pytest.approx(
        {"hx.metrics": 100.0, "hx.data.next": 1000.0, "hx.prep": 200.0})
    assert "gaps" not in program_trace.read_record(ivs, {}, [], 7, False)


PROGRAM_METRICS = ("fold_ms", "optimizer_ms", "gap_ms", "gap_host_ms",
                   "syncs_per_step")


def _reader(name):
    return spec.Cell(standin.REPO, "unet3d_atrial.em_semi").reader(name)


def _report(cuda):
    """:func:`program_trace.read_record` of a window; on a card with the
    between-step gaps."""
    r = {"cuda": cuda,
         "spans": {"hx.step": {"n": 4, "host_ms": 2000.0}},
         "syncs": {"hx.prep": 12, "hx.metrics": 4, "hx.epoch.read": 3}}
    if cuda:
        r["gaps"] = {"n": 5, "device_ms": 150.0,
                     "by_span": {"hx.data.next": 110.0, "hx.prep": 30.0,
                                 "": 10.0}}
    return r


def _ctx(program, report, steps=4):
    return types.SimpleNamespace(program=program, program_report=report,
                                 steps=steps)


def test_the_program_readers_read_the_spans_and_counters():
    spans = program_trace.read_program(_prof(_events(True)), 2)
    got = {m: _reader(m).read(_ctx(spans, _report(True)))
           for m in PROGRAM_METRICS}
    assert got == {"fold_ms": (500 + 1_500) / 1e6,
                   "optimizer_ms": 250 / 1e6,
                   "gap_ms": 150.0 / 4, "gap_host_ms": (150.0 - 110.0) / 4,
                   "syncs_per_step": 19 / 4}


@pytest.mark.parametrize("ctx", [
    _ctx(None, None),
    _ctx(None, {}),
    # a profile with device operations but none of the program's spans
    _ctx(program_trace.read_program(_prof(_events(False)), 2), {}),
    # the CPU: no device operation to read, no gaps, no sync-debug mode
    _ctx(None, _report(False))],
    ids=["none", "empty", "no_spans", "cpu"])
def test_the_program_readers_give_none_without_their_input(ctx):
    assert {m: _reader(m).read(ctx) for m in PROGRAM_METRICS} == dict.fromkeys(
        PROGRAM_METRICS)
