"""The port's own spans and counters (``hebbax_torch.utils.trace``) on the
CPU: off, every site gets one shared no-op span and nothing is recorded;
on, host intervals keep their parents and threads, counters add up,
device gaps split among the host spans, and a ``SemiTrainer`` epoch and
a folded network's forward and backward open the spans their sites name
without changing a number."""

import os
import threading
import warnings

import numpy as np
import pytest
import torch

from hebbax_torch.cli import common3d, train_semi_3d
from hebbax_torch.data.nrrd_io import write_nrrd
from hebbax_torch.models.urpc3d_s2d import UNet3DURPCS2D
from hebbax_torch.utils import trace


@pytest.fixture(autouse=True)
def _off():
    trace.reset()
    yield
    trace.reset()


def _names(ivs):
    return [iv[0] for iv in ivs]


def _sync():
    """What a blocking call raises under ``set_sync_debug_mode("warn")``."""
    warnings.warn(trace.SYNC_MESSAGE)


def test_off_every_site_shares_one_no_op():
    a, b = trace.span("hx.step"), trace.span("hx.fold")
    assert a is b and not trace.enabled()
    loader = [1, 2, 3]
    assert trace.iterate(loader, "hx.data.next") is loader
    with warnings.catch_warnings(record=True):
        for _ in trace.iterate(loader, "hx.data.next"):
            with trace.span("hx.step"):
                _sync()
    assert trace.intervals() == [] and trace.counters() == {}
    assert trace.report() == {}


def test_on_nested_intervals_keep_parents_and_counters_add_up():
    trace.enable(cuda=False)
    assert trace.span("hx.step") is not trace.span("hx.step")
    _sync()                                   # outside every span
    with trace.span("hx.epoch"):
        for _ in trace.iterate([0, 1], "hx.data.next"):
            with trace.span("hx.step"):
                _sync()
                _sync()
                with trace.span("hx.fold"):
                    _sync()

    def other():
        with trace.span("hx.fold"):
            _sync()

    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    trace.disable()
    ivs = trace.intervals()
    assert _names(ivs) == ["hx.epoch", "hx.data.next", "hx.step", "hx.fold",
                           "hx.data.next", "hx.step", "hx.fold",
                           "hx.data.next", "hx.fold"]
    parents = [iv[3] for iv in ivs]
    assert parents == [-1, 0, 0, 2, 0, 0, 5, 0, -1]
    assert [iv[5] for iv in ivs] == [0, 1, 1, 2, 1, 1, 2, 1, 0]
    assert ivs[-1][4] != ivs[0][4]            # the other thread's own root
    for name, start, end, parent, *_ in ivs:
        assert start <= end
        if parent >= 0:
            assert ivs[parent][1] <= start and end <= ivs[parent][2]
    assert trace.counters() == {"sync": {"hx.step": 4, "hx.fold": 3}}
    rep = trace.report()
    here = os.path.basename(__file__)
    sites = {k.split()[0]: v for k, v in rep["sync_sites"].items()}
    assert sites == {"hx.step": 4, "hx.fold": 3}
    assert all(here in k for k in rep["sync_sites"])
    assert rep["steps"] == 2 and rep["cuda"] is False and "gaps" not in rep
    assert rep["spans"]["hx.data.next"]["n"] == 3
    assert rep["spans"]["hx.fold"]["n"] == 3
    # off again: nothing more is recorded, and a reset empties the record
    with pytest.warns(UserWarning):
        with trace.span("hx.step"):
            _sync()
    assert trace.report()["steps"] == 2
    assert trace.counters()["sync"]["hx.step"] == 4
    trace.reset()
    assert trace.report() == {} and trace.intervals() == []
    assert trace.counters() == {}


def test_on_syncs_are_counted_and_other_warnings_pass_through():
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        trace.enable(cuda=False)
        try:
            with trace.span("hx.metrics"):
                _sync()
                warnings.warn("unrelated")
        finally:
            trace.disable()
    assert [str(w.message) for w in seen] == ["unrelated"]
    assert trace.counters() == {"sync": {"hx.metrics": 1}}


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
])
def test_gaps_split_among_the_innermost_host_spans(gaps, want):
    got = trace.attribute_gaps(gaps, SPANS)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-6)
    assert sum(got.values()) == pytest.approx(sum(ms for _, ms in gaps))


@pytest.fixture(scope="module")
def volumes(tmp_path_factory):
    root = tmp_path_factory.mktemp("traced") / "Atrial"
    rng = np.random.default_rng(3)
    zz, yy, xx = np.mgrid[:20, :18, :16]
    ball = ((zz - 10) ** 2 + (yy - 9) ** 2 + (xx - 8) ** 2) < 20
    for split, n in (("train", 4), ("val", 1)):
        for sub in ("image", "mask"):
            os.makedirs(root / split / sub)
        for i in range(n):
            vol = rng.normal(100, 20, ball.shape).astype(np.float32)
            vol[ball] += 60
            write_nrrd(str(root / split / "image" / f"v{i}.nrrd"), vol)
            write_nrrd(str(root / split / "mask" / f"v{i}.nrrd"),
                       ball.astype(np.uint8) * 255)
    return str(root)


def test_a_semi_epoch_opens_each_span_its_sites_name(volumes, tmp_path):
    args = train_semi_3d.add_args(common3d.base_parser_3d(), "em").parse_args(
        ["--device", "cpu", "--path_dataset", volumes, "--path_root_exp",
         str(tmp_path), "-n", "unet3d_min", "-b", "1", "-e", "2",
         "--patch_size", "16,16,16", "--samples_per_volume_train", "2",
         "--regime", "50", "-u", "5", "-l", "0.01"])
    trainer = train_semi_3d.build(args, "em")
    trace.enable(cuda=False)
    try:
        trainer.train_epoch(0, True)
    finally:
        trace.disable()
    rep = trace.report()
    n = rep["steps"]
    assert n == len(trainer.loaders["train_sup"]) > 0
    spans = {k: v["n"] for k, v in rep["spans"].items()}
    # one next() of each loader a step, and the labelled loader's last,
    # which ends the epoch
    assert spans["hx.data.next"] == 2 * n + 1
    assert spans["hx.prep"] == 2 * n and spans["hx.forward"] == 2 * n
    assert spans["hx.optimizer"] == n and spans["hx.metrics"] == n
    assert spans["hx.epoch"] == spans["hx.epoch.read"] == 1
    ivs = trace.intervals()
    for name, _, _, parent, *_ in ivs:
        want = {"hx.epoch": None, "hx.forward": "hx.step",
                "hx.optimizer": "hx.step"}.get(name, "hx.epoch")
        assert (ivs[parent][0] if parent >= 0 else None) == want, name


def test_a_folded_forward_and_backward_open_fold_spans_and_change_nothing():
    def run():
        torch.manual_seed(0)
        net = UNet3DURPCS2D(in_channels=1, n_cls=2)
        x = torch.randn(1, 1, 16, 16, 16)
        y = torch.stack(net(x))
        grads = torch.autograd.grad(y.square().sum(), list(net.parameters()))
        return y.detach(), grads

    y0, g0 = run()
    trace.enable(cuda=False)
    try:
        y1, g1 = run()
    finally:
        trace.disable()
    assert torch.equal(y0, y1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    folds = [iv for iv in trace.intervals() if iv[0] == "hx.fold"]
    # the forward's folds and builds, and the pool's backward unfolding
    # its windows
    assert len(folds) >= 8
    assert all(iv[2] is not None for iv in folds)


class _Ev:
    """A stand-in for a CUDA timing event: its device time in ms."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


def _mark(name, t_in, t_out, dev_in=None, dev_out=None):
    return [name, _Ev(t_in * 1e3 if dev_in is None else dev_in), t_in,
            _Ev(t_out * 1e3 if dev_out is None else dev_out), t_out]


def test_between_step_gaps_run_from_epoch_entry_to_epoch_exit():
    marks = [
        _mark("hx.epoch", 0.0, 4.0),
        _mark("hx.step", 0.5, 1.0, dev_out=1600.0),     # device ran late
        _mark("hx.step", 1.2, 2.0, dev_in=1600.0),     # ... into this one
        _mark("hx.step", 2.3, 3.5),
        _mark("hx.epoch", 4.1, 6.0),
        _mark("hx.step", 5.0, 5.8),
    ]
    got = trace.between_steps(marks)
    # epoch 1: its lead-in, the run-ahead step (no gap), the wait before
    # step 3, its tail; between the epochs, none; epoch 2: lead-in, tail
    assert [t for t, _ in got] == [0.5, 1.2, 2.3, 4.0, 5.0, 6.0]
    assert [round(ms, 6) for _, ms in got] == [
        500.0, 0.0, 300.0, 500.0, 900.0, 200.0]
    steps_only = [m for m in marks if m[0] == "hx.step"]
    assert [round(ms, 6) for _, ms in trace.between_steps(steps_only)] == [
        0.0, 300.0, 1500.0]
