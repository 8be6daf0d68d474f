"""On the card: the program's own trace (``hebbax_torch.utils.trace``) and
its reading off a profile (``program_trace.read_program``), on a loop of
small steps shaped like the trainers' (``hx.step`` with a forward and an
optimizer inside, the metrics and a host wait between steps).  A planted ``.item()`` inside a
program span raises the report's syncs per step by one; over a profiled
stretch each between-step gap of the step events agrees within 1 ms with
the device idle the profile shows before that step; and the backward
kernels of an op made inside ``hx.fold`` count under it.  The same two
through the harness, on the stand-in cell's traced window: the planted
``.item()`` raises the line's ``syncs_per_step`` by one, and each gap
between two steps of one epoch by the harness's own timing events
(:class:`portbench.program_trace.Marks`) lies within 1 ms of the device time
that the harness's profile shows between them (from the later of the
first step's end and the end of the work it queued, to the later of the
next step's start and the end of the work queued before it: where the
host launches a step's first kernel late, that wait is the step's own
and no event gap's).  Run on a machine with a
card:

    python -m pytest portbench/tests -m cuda
"""

import bisect
import itertools
import os
import statistics
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hebbax_torch.utils import trace as program
from portbench import harness, program_trace, spec

from . import standin

STEPS = 6


def _loop(plant, waits_s):
    """``len(waits_s) + 1`` steps; the host waits ``waits_s[k]`` between
    step k and step k + 1, with the device idle."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn(512, 512, device=dev, generator=gen, requires_grad=True)
    x = torch.randn(64, 512, device=dev, generator=gen)
    for k in range(len(waits_s) + 1):
        with program.span("hx.step"):
            with program.span("hx.forward"):
                with program.span("hx.fold"):
                    h = (x @ w) * 2.0
                y = torch.tanh(h @ w).sum()
            (g,) = torch.autograd.grad(y, [w])
            with program.span("hx.optimizer"):
                with torch.no_grad():
                    w.sub_(1e-3 * g)
        with program.span("hx.metrics"):
            s = y.detach() * 1.0
            if plant:
                s.item()
        if k < len(waits_s):
            torch.cuda.synchronize()
            with program.span("hx.data.next"):
                time.sleep(waits_s[k])


def _syncs_per_step(plant):
    program.enable(cuda=True)
    try:
        _loop(plant, [0.002] * (STEPS - 1))
        torch.cuda.synchronize()
    finally:
        program.disable()
    r = program.report()
    program.reset()
    return sum(r["counters"].get(program.SYNC, {}).values()) / r["steps"], r


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    program.reset()
    yield
    program.reset()


@pytest.mark.cuda
def test_a_planted_item_raises_the_syncs_per_step_by_one(card):
    base, _ = _syncs_per_step(False)
    planted, r = _syncs_per_step(True)
    assert r["steps"] == STEPS
    assert planted == pytest.approx(base + 1.0)
    site = [k for k in r["sync_sites"] if k.startswith("hx.metrics ")]
    assert site and os.path.basename(__file__) in site[0]


@pytest.mark.cuda
def test_step_event_gaps_match_the_profiles_idle_and_fold_owns_its_backward(
        card):
    waits = [0.002, 0.010, 0.004, 0.020, 0.003]
    _loop(False, waits)                 # warm-up: kernels and handles
    torch.cuda.synchronize()
    program.enable(cuda=True)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _loop(False, waits)
            torch.cuda.synchronize()
    finally:
        program.disable()
    gaps = [ms for _, ms in program.gaps()]
    events = list(prof.profiler.kineto_results.events())
    host = [e for e in events if not str(e.device_type()).endswith("CUDA")]
    ops = {e.correlation_id(): e for e in host
           if not e.linked_correlation_id() and not e.name().startswith("cu")}
    steps = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in host if e.name() == "hx.step")

    def step_of(t):
        return next((i for i, (a, b) in enumerate(steps) if a <= t <= b),
                    None)

    # each kernel goes to the step whose host interval launched it (the
    # backward's too: the autograd thread runs inside the step's call)
    kernels = []
    for e in events:
        if (str(e.device_type()).endswith("CUDA")
                and not e.is_user_annotation()
                and not e.name().startswith(("hx.", "pb."))):
            op = ops.get(e.linked_correlation_id())
            k = None if op is None else step_of(op.start_ns())
            if k is not None:
                kernels.append((k, e.start_ns(),
                                e.start_ns() + e.duration_ns()))
    idle = []
    for k in range(1, len(steps)):
        last = max(end for i, _, end in kernels if i == k - 1)
        first = min(start for i, start, _ in kernels if i == k)
        idle.append((first - last) / 1e6)
    assert len(gaps) == len(idle) == len(waits)
    for g, i, w in zip(gaps, idle, waits):
        assert abs(g - i) <= 1.0, (gaps, idle)
        assert g >= w * 1e3 - 1.0
    got = program_trace.read_program(prof, len(waits) + 1)
    assert got["created_ms"]["hx.fold"] > got["under_ms"]["hx.fold"] > 0
    assert got["created_ms"]["hx.optimizer"] > 0


# through the harness: the stand-in cell (:mod:`.standin`) on the card,
# its window traced as a run of the benchmark traces it

@pytest.fixture(scope="module")
def standin_root(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return standin.make_root(tmp_path_factory.mktemp("card"))


def _traced_run(root, seed, mutate=None, traffic=None):
    """A traced run of the stand-in cell, and the program's blocking syncs
    by span and site over its window (``"<span> <file>:<line>"``)."""
    c = spec.Cell(root, standin.CELL, here=os.path.join(root, "portbench"))
    if traffic is not None:
        c.traffic = dict(c.traffic, **traffic)
    sites = {}
    real_reset = program.reset

    def reset():
        sites.update(program.report().get("sync_sites", {}))
        real_reset()

    program.reset()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(program, "reset", reset)
            r = harness.run_cell(c, seed, 3, True, torch.device("cuda", 0),
                                 0.0, mutate=mutate)
    finally:
        program.reset()
    return r, sites


def _plant_item(trainer):
    """One blocking sync more in each step: an ``.item()`` inside the
    loop's ``hx.step``."""
    real = trainer.train_step

    def step(state, *batches):
        state, out = real(state, *batches)
        torch.ones((), device="cuda").item()
        return state, out

    trainer.train_step = step


@pytest.mark.cuda
def test_a_planted_item_raises_the_harness_syncs_per_step_by_one(
        standin_root):
    base, base_sites = _traced_run(standin_root, 2147483723)
    planted, sites = _traced_run(standin_root, 2147483723, mutate=_plant_item)
    assert base["correct"] is True and planted["correct"] is True
    assert not program.enabled()
    for r in (base, planted):
        assert {"optimizer_ms", "gap_ms", "gap_host_ms",
                "syncs_per_step"} <= set(r["metrics"])
    steps = planted["attempted"]
    mine = {k: n for k, n in sites.items()
            if os.path.basename(__file__) in k}
    assert list(mine.values()) == [steps], sites
    assert list(mine)[0].startswith("hx.step ")
    assert set(sites) - set(mine) == set(base_sites)
    assert sum(planted["run"]["program"]["report"]["syncs"].values()) == sum(
        sites.values())
    rest = (sum(sites.values()) - steps) / steps
    assert planted["metrics"]["syncs_per_step"]["value"] == pytest.approx(
        rest + 1.0, abs=1e-12)


class _Kept(program_trace.Marks):
    """:class:`program_trace.Marks` that keeps itself and its gaps where
    the test reads them."""

    kept = []

    def __init__(self):
        super().__init__()
        _Kept.kept.append(self)

    def gaps(self):
        self.found = super().gaps()
        return self.found


# runs of both seeds have read the profile's clock mapping off the host's
# by up to 1.4 ms
@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2147483731, 2147483771])
def test_the_harness_event_gaps_match_the_profile(standin_root, monkeypatch,
                                                  seed):
    got = {}
    real_read = program_trace.read_program

    def read_program(prof, n):
        got["prof"] = prof
        return real_read(prof, n)

    monkeypatch.setattr(harness.program_trace, "read_program", read_program)
    monkeypatch.setattr(harness.program_trace, "Marks", _Kept)
    _Kept.kept.clear()
    # the profile from the window's first step to its end
    r, _ = _traced_run(standin_root, seed, traffic=dict(
        profile_at=0.0, profile_seconds=1e9, profile_min_steps=10 ** 9))
    assert r["correct"] is True
    (marks,) = _Kept.kept
    events = list(got["prof"].profiler.kineto_results.events())
    host = [e for e in events if not str(e.device_type()).endswith("CUDA")]
    prof_steps = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                        for e in host if e.name() == "pb.step")
    # the window's steps whose ranges the profile holds: the last ones
    epochs = [m for m in marks.marks if m[0] == program_trace.EPOCH]
    steps = sorted((m for m in marks.marks if m[0] == program_trace.STEP),
                   key=lambda m: m[2])[-len(prof_steps):]
    epoch_of = [next(i for i, e in enumerate(epochs) if e[2] <= m[2] <= e[4])
                for m in steps]
    assert len(prof_steps) >= 8
    # the profile's host clock runs off the host's by up to half a percent
    # on some machines (0.69 ms in a 160 ms step), and a host pause can
    # fall between a step's range and its events: the steps pair up where
    # the median step's length and host time before it agree to 0.5 ms
    # (a step off, they differ by milliseconds)
    lengths = [((b - a) / 1e6, (m[4] - m[2]) * 1e3)
               for (a, b), m in zip(prof_steps, steps)]
    between = [((prof_steps[k][0] - prof_steps[k - 1][1]) / 1e6,
                (steps[k][2] - steps[k - 1][4]) * 1e3)
               for k in range(1, len(steps))]
    print("step length, profile and host (ms):", lengths)
    print("host time between steps, profile and host (ms):", between)
    assert statistics.median(abs(p - h) for p, h in lengths) <= 0.5
    assert statistics.median(abs(p - h) for p, h in between) <= 0.5
    # a step's timing event completes once the work queued before it is
    # done, or when the host records it if the device is idle by then: the
    # later of the step's host boundary and the end of the device
    # operations launched before it.  The profile maps the device's clock
    # onto its host clock with an error that moves by up to a millisecond
    # in a step on such a machine, so each step boundary moves onto the
    # device's clock by the least delay from a launch to its operation's
    # start within 5 ms of it (a launch onto an idle device starts within
    # microseconds).
    launched = {e.correlation_id(): e.start_ns() for e in host
                if e.name().startswith("cu") and e.correlation_id()}
    dev = sorted((launched[e.correlation_id()], e.start_ns(),
                  e.start_ns() + e.duration_ns())
                 for e in events
                 if str(e.device_type()).endswith("CUDA")
                 and not e.is_user_annotation()
                 and not e.name().startswith(("hx.", "pb."))
                 and e.correlation_id() in launched)
    launches = [t for t, _, _ in dev]
    done = list(itertools.accumulate((end for _, _, end in dev), max))

    def completes(t):
        near = dev[bisect.bisect_left(launches, t - 5_000_000):
                   bisect.bisect_right(launches, t + 5_000_000)]
        at = t + min(s - lt for lt, s, _ in near)
        i = bisect.bisect_left(launches, t)
        return max(at, done[i - 1]) if i else at

    rows, paused = [], []
    for k in range(1, len(steps)):
        if epoch_of[k] != epoch_of[k - 1]:
            continue        # another epoch: its end reads lie between
        if abs(between[k - 1][0] - between[k - 1][1]) > 0.3:
            # the host paused between a step's events and its range (0.73
            # ms seen): the profile's boundary is not the event's
            paused.append(k)
            continue
        closing = [ms for t, ms in marks.found if t == steps[k][2]]
        assert len(closing) == 1, k
        shown = (completes(prof_steps[k][0])
                 - completes(prof_steps[k - 1][1])) / 1e6
        rows.append((k, closing[0], shown))
    print("event gap, profile (ms):", rows, "paused:", paused)
    assert len(rows) >= 5 and len(paused) <= len(rows) // 4
    assert all(abs(g - s) <= 1.0 for _, g, s in rows), rows
