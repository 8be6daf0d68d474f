"""The reading of the program's own spans
(``program_trace.read_program``, ``program_trace.ProgramOwners``) on the
CPU: on a real profile of a tiny forward
and backward, a ``permute`` inside ``hx.fold`` and the backward node it
made both belong to ``hx.fold``; on a profile made of stand-in events
with device operations, the backward's kernels count under the span that
made their node, and ``trace.read``'s readings are those of the same
profile without the program's spans."""

import types

import torch
from torch.profiler import ProfilerActivity, profile

from hebbax_torch.utils import trace as program
from portbench import program_trace, trace


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
