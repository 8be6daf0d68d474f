"""On the card: the program's own trace (``hebbax_torch.utils.trace``) and
its reading off a profile (``program_trace.read_program``), on a loop of
small steps shaped like the trainers' (``hx.step`` with a forward and an
optimizer inside, the metrics and a host wait between steps).  A planted ``.item()`` inside a
program span raises the report's syncs per step by one; over a profiled
stretch each between-step gap of the step events agrees within 1 ms with
the device idle the profile shows before that step; and the backward
kernels of an op made inside ``hx.fold`` count under it.  Run on a
machine with a card:

    python -m pytest portbench/tests -m cuda
"""

import os
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hebbax_torch.utils import trace as program
from portbench import program_trace

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
