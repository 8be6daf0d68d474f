"""One run of a cell: set-up, the measured window, the check against the
plain reference.

Set-up builds the trainer the port's own CLI builds for the cell's flags
over the port's loaders on the seed's items (:mod:`portbench.feeds`).
The CLI is ``hebbax_torch.cli.<cli>``, ``cli`` named by the traffic mix
(``train_semi_3d`` where it names none), found by name and built by its
own ``build``; a mix's ``algo`` is passed to the CLI's parser and
``build`` first, as ``train_semi_3d`` takes it.  The CLI's ``--seed``,
the items and the weights all come from the run's seed.  Where the mix
names a ``snapshot``, the trainer loads that Hebbian snapshot as a sweep
line loads the one an earlier pretraining line wrote.  Set-up then loads the
benchmark's weights (:mod:`portbench.weights`) and sets the step count
to the mix's ``start_epoch`` (a run resumed there: the schedule's epoch
0 trains at a learning rate of 0).  Its first partial epoch runs through
``trainer.train_epoch``, the window's own call and feed: the first
``check_steps`` steps are the ones the reference follows, the rest warm
up.

The snapshot is written once per checkout, at a fixed path under
``build/portbench/``, by the port's 3D pretraining trainer with no step
taken: the run that writes it pays for it in its set-up, as for a build,
and later runs only load it.  Its values do not matter: the benchmark's
weights replace every parameter after the load.

The window then calls ``trainer.train_epoch`` epoch after epoch, as the
CLI's ``run()`` does without its validation, snapshots and logging; the
loader an epoch runs over stops once the window's seconds have passed,
and the window closes after that epoch's own end read and a
``synchronize``.  A traced run profiles a stretch of the window
(:mod:`portbench.trace`), times each step and epoch of the whole window
by timing events (:class:`portbench.program_trace.Marks`; a step's
events hold the harness's own work after it, the profiler's start and
stop among it, so that no gap between steps holds it) and turns the
port's own tracing (``hebbax_torch.utils.trace``) on for the window, so
the readers see its ``hx.*`` spans and sync counts beside the
benchmark's ``pb.*`` ranges; an untraced run does none of this.

Once the window has closed and the peak memory is read, the program's
state is freed and the reference follows the first steps from the same
weights on batches it works out again; :mod:`portbench.reference.compare`
gives the numbers held to the cell's limits.
"""

import gc
import importlib
import os
import shutil
import tempfile
import threading
import time
import types

import hebbax_torch.cli
import hebbax_torch.utils.trace as hx_trace
import torch

from . import counts, feeds, program_trace, trace, weights
from .reference import batches as ref_batches
from .reference import compare
from .reference.follow import follow
from .reference.nets import Net


def _sync(cuda):
    if cuda:
        torch.cuda.synchronize()


def flag_argv(flags):
    argv = []
    for k, v in flags.items():
        argv.append("--" + k)
        argv += [str(x) for x in v] if isinstance(v, list) else [str(v)]
    return argv


def _common_argv(cfg, seed, dev_flag, work):
    return ["--device", dev_flag, "--seed", str(seed),
            "--dataset_name", cfg["dataset_name"],
            "--network", cfg["network"],
            "--path_root_exp", os.path.join(work, "runs"),
            "--path_dataset", os.path.join(work, "data"),
            "--patch_size", ",".join(str(s) for s in cfg["patch_size"])]


def snapshot(cell):
    """The path of the Hebbian snapshot the cell's mix loads, written by
    the port's pretraining trainer (on the CPU, seed 0, no step taken)
    where the checkout does not hold it yet."""
    cfg, snap = cell.config, cell.traffic["snapshot"]
    cache = os.path.join(cell.root, "build", "portbench")
    path = os.path.join(cache, f"snapshot.{cell.name}.ckpt")
    if os.path.exists(path):
        return path
    os.makedirs(cache, exist_ok=True)
    work = tempfile.mkdtemp(prefix="snapshot-", dir=cache)
    try:
        # imported here: a run that only loads the snapshot, as an EM
        # line does, does not import the pretraining CLI
        from hebbax_torch.cli import pretrain_hebbian_unsup_3d as mod
        argv = _common_argv(cfg, 0, "cpu", work) + [
            "--hebb_mode", snap["hebb_mode"],
            "--hebb_inv_temp", str(snap["hebb_inv_temp"]),
            "--exclude", *snap["exclude"]]
        trainer = mod.build(mod.build_parser().parse_args(argv),
                            loaders={"train": [], "val": []})
        trainer._save_last(None)
        os.replace(os.path.join(trainer.paths.checkpoints, "last.ckpt"),
                   path)
        del trainer
        gc.collect()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return path


DEFAULT_CLI = "train_semi_3d"


def cli_module(traffic):
    """The port's CLI module the mix names, ``hebbax_torch.cli.<cli>``."""
    name = traffic.get("cli", DEFAULT_CLI)
    path = os.path.join(os.path.dirname(hebbax_torch.cli.__file__),
                        name + ".py")
    if not os.path.exists(path):
        raise ValueError(f"unknown cli {name!r}: no file {path}")
    return importlib.import_module("hebbax_torch.cli." + name)


def build_trainer(cell, seed, dev_flag, work, snap, extra_argv=()):
    cfg, traffic = cell.config, cell.traffic
    mod = cli_module(traffic)
    algo = (traffic["algo"],) if "algo" in traffic else ()
    argv = (_common_argv(cfg, seed, dev_flag, work)
            + flag_argv(traffic["flags"]) + list(extra_argv))
    if snap is not None:
        argv += ["--load_hebbian_weights", snap]
    args = mod.build_parser(*algo).parse_args(argv)
    loaders = feeds.make_loaders(cfg, traffic, args, work)
    return mod.build(args, *algo, loaders=loaders)


class Steps:
    """Wraps ``trainer.train_step``: the rows each step consumed (those of
    every batch it took: the labelled and the unlabelled one of a semi
    step), and hooks called with (step number, the step's output)."""

    def __init__(self, trainer):
        self.real = trainer.train_step
        self.rows, self.count = 0, 0
        self.hooks = []
        self.span = None
        trainer.train_step = self

    def __call__(self, state, *batches):
        if self.span is None:
            state, out = self.real(state, *batches)
        else:
            with self.span("pb.step"):
                state, out = self.real(state, *batches)
        self.rows += sum(b["image"].shape[0] for b in batches
                         if isinstance(b, dict) and "image" in b)
        self.count += 1
        for hook in self.hooks:
            hook(self.count, out)
        return state, out


# the optimizer's state the check reads after the first step: SGD's
# momentum buffer, Adam's first moment (a tenth of the first gradient)
STATE_KEY = {"SGD": "momentum_buffer", "Adam": "exp_avg"}


class Check:
    """The program's readings of the first ``n`` steps: each step's losses,
    the first step's logits, the optimizer's state after it
    (:data:`STATE_KEY`), each parameter's change after the n-th (read
    before the next step)."""

    def __init__(self, trainer, model, p0, n):
        self.trainer = trainer
        self.params = dict(model.named_parameters())
        self.p0 = p0
        self.n = n
        self.readings = {"losses": {}, "state": {}, "change": {}}

    def __call__(self, k, out):
        if k > self.n:
            return
        r = self.readings
        for key in ("loss", "loss_sup", "loss_unsup"):
            if key in out:
                r["losses"].setdefault(key, []).append(float(out[key]))
        if k == 1:
            r["logits"] = out["logits"].detach().float().cpu()
            opt = self.trainer.state.optimizer
            key = STATE_KEY[type(opt).__name__]
            for name, p in self.params.items():
                t = opt.state.get(p, {}).get(key)
                if t is not None:
                    r["state"][name] = float(t.norm())
        if k == self.n:
            with torch.no_grad():
                r["change"] = {n: float((p - self.p0[n]).norm())
                               for n, p in self.params.items()}
            self.p0 = None


class Timed:
    """Wraps a trainer method: the host seconds in it, inside ``span``."""

    def __init__(self, fn, name, span):
        self.fn, self.name, self.span = fn, name, span
        self.seconds = 0.0

    def __call__(self, *a, **kw):
        t0 = time.perf_counter()
        with self.span(self.name):
            out = self.fn(*a, **kw)
        self.seconds += time.perf_counter() - t0
        return out


def _feeds(trainer):
    return [f for f in trainer.loaders.values()
            if isinstance(f, feeds.Feed)]


def _stop_feed(trainer):
    return trainer.loaders[trainer.train_key]


def run_cell(cell, seed, seconds, traced, device, process_start,
             mutate=None, extra_argv=(), window=True):
    """One run; returns the result dict (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``breakdown``, ``checks``).
    ``mutate(trainer)`` changes the built program (a control or a planted
    fault); ``window=False`` reads the check alone.  A traced run turns
    the port's own tracing on after the checked steps and off after the
    window, so its ``hx.*`` spans and counters reach the readers
    (:func:`_context`); an untraced run leaves it as it is."""
    cfg, traffic = cell.config, cell.traffic
    cuda = device.type == "cuda"
    work = tempfile.mkdtemp(prefix="portbench-")
    phases = {"entered": time.time() - process_start}
    try:
        snap = snapshot(cell) if "snapshot" in traffic else None
        phases["snapshot"] = time.time() - process_start
        trainer = build_trainer(cell, seed, "0" if cuda else "cpu", work,
                                snap, extra_argv)
        phases["built"] = time.time() - process_start
        model = trainer.state.model
        named = Net(cfg).params()
        w0 = weights.make_weights(named, seed, device)
        own = dict(model.named_parameters())
        if set(own) != set(w0):
            raise RuntimeError(
                f"the program's parameters differ from the configuration's: "
                f"{sorted(set(own) ^ set(w0))[:6]}")
        with torch.no_grad():
            for n, p in own.items():
                p.copy_(w0[n])
        spe = len(trainer.loaders[trainer.train_key])
        trainer.state.step = traffic["start_epoch"] * spe
        if mutate is not None:
            mutate(trainer)
        steps = Steps(trainer)
        check = Check(trainer, model, w0, traffic["check_steps"])
        del w0
        steps.hooks.append(check)
        collect = (traffic["start_epoch"] + 1) % traffic["flags"].get(
            "display_iter", 1) == 0
        stop = _stop_feed(trainer)
        stop.cap = traffic["check_steps"] + traffic["warmup_steps"]
        phases["weights"] = time.time() - process_start
        trainer.train_epoch(traffic["start_epoch"], collect)
        stop.cap = None
        phases["checked"] = time.time() - process_start
        readings = check.readings
        instruments = prep = marks = None
        if traced:
            trace.warm_profiler(_activities(cuda))
            instruments = trace.Instruments(trainer, model)
            prep = trainer.prep = Timed(trainer.prep, "pb.prep", trace.span)
            steps.span = trace.span
            for f in _feeds(trainer):
                f.span = trace.span
            if cuda:
                marks = program_trace.Marks()
                trainer.train_step = marks.wrap(steps, program_trace.STEP)
                trainer.train_epoch = marks.wrap(trainer.train_epoch,
                                                 program_trace.EPOCH)
            hx_trace.enable(cuda)
        _sync(cuda)
        setup_s = time.time() - process_start
        prof_box = {}
        try:
            if window:
                w = _window(trainer, steps, seconds, traffic, traced, cuda,
                            prof_box)
        finally:
            if traced:
                hx_trace.disable()
        report = None
        if traced:
            report = program_trace.read_record(
                hx_trace.intervals(), hx_trace.counters().get("sync", {}),
                marks.gaps() if marks else [], threading.get_ident(), cuda)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        if instruments is not None:
            instruments.remove()
        prep_s = None if prep is None else prep.seconds
        stop.deadline = None
        trainer = model = steps = check = instruments = own = prep = None
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        summary = spans = None
        if window and traced and prof_box.get("prof") is not None:
            summary = trace.read(prof_box["prof"], prof_box["n"])
            spans = program_trace.read_program(prof_box["prof"],
                                               prof_box["n"])
        if traced:
            hx_trace.reset()
        checks, correct = reference_check(cell, seed, device, work,
                                          readings)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": 0, "failed": 0, "metrics": {},
           "device": dev}
    if window:
        out["attempted"] = w["steps"]
        if traced:
            ctx = _context(cell, w, summary, prep_s, spans, report)
            for m in cell.metrics("per_layer"):
                v = cell.reader(m["name"]).read(ctx)
                if v is not None:
                    out["metrics"][m["name"]] = {"value": v,
                                                 "unit": m["unit"]}
            if summary is not None:
                dev["busy_s"] = summary["busy_s"]
                dev["window_s"] = summary["span_s"]
                out["breakdown"] = {"device_ops": summary["device_ops"],
                                    "idle_gaps": summary["idle_gaps"]}
        else:
            e2e = {"train_samples_per_s": w["rows"] / w["seconds"],
                   "setup_s": setup_s}
            for m in cell.metrics("end_to_end"):
                out["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                             "unit": m["unit"]}
    out["run"] = {"setup_s": setup_s, "setup_phases": phases,
                  "attributed_share": summary and summary["attributed"],
                  **(w if window else {})}
    if traced:
        out["run"]["program"] = {"report": report, "spans": spans}
    out["checks"] = checks
    return out


def _activities(cuda):
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    return acts


def _window(trainer, steps, seconds, traffic, traced, cuda, box):
    stop = _stop_feed(trainer)
    for f in _feeds(trainer):
        f.wait_s = 0.0
    i0, rows0 = steps.count, steps.rows
    prof = None
    state = {"start_k": None, "stop_k": None}
    if traced:
        prof = torch.profiler.profile(activities=_activities(cuda))

        def profile_hook(k, out):
            now = time.perf_counter()
            if state["start_k"] is None:
                if now - t0 >= traffic["profile_at"] * seconds:
                    _sync(cuda)
                    state.update(start_k=k, started=time.perf_counter())
                    prof.start()
            elif state["stop_k"] is None and (
                    k - state["start_k"] >= traffic["profile_min_steps"]
                    and now - state["started"] >= traffic["profile_seconds"]):
                _sync(cuda)
                prof.stop()
                state["stop_k"] = k

        steps.hooks.append(profile_hook)
    _sync(cuda)
    t0 = time.perf_counter()
    stop.deadline = t0 + seconds
    epoch = traffic["start_epoch"] + 1
    every = traffic["flags"].get("display_iter", 1)
    while time.perf_counter() < stop.deadline:
        trainer.train_epoch(epoch, (epoch + 1) % every == 0)
        epoch += 1
    _sync(cuda)
    t1 = time.perf_counter()
    if traced:
        if state["start_k"] is not None and state["stop_k"] is None:
            prof.stop()
            state["stop_k"] = steps.count
        steps.hooks.pop()
    out = {"steps": steps.count - i0, "rows": steps.rows - rows0,
           "seconds": t1 - t0,
           "data_wait_s": sum(f.wait_s for f in _feeds(trainer)),
           "epochs": epoch - traffic["start_epoch"] - 1}
    if traced and state["start_k"] is not None:
        box["prof"], box["n"] = prof, state["stop_k"] - state["start_k"]
    return out


def _context(cell, w, summary, prep_s, spans, report):
    """What the per-layer readers read (each is None where a run has
    nothing to give):

    * ``steps``, ``seconds``: the window's steps and wall seconds;
    * ``data_wait_s``: host seconds in ``next()`` of the loaders handed to
      the trainer, over the window;
    * ``prep_s``: host seconds in ``trainer.prep`` over the window;
    * ``profile``: :func:`portbench.trace.read` of the profiled span (the
      ``pb.*`` ranges, busy and span seconds, heaviest ops, idle gaps);
    * ``program``: :func:`portbench.program_trace.read_program` of the
      same span: device ms per step under (``under_ms``) and made under
      (``created_ms``) each of the program's ``hx.*`` spans, by name;
    * ``program_report``: :func:`portbench.program_trace.read_record`
      over the whole window: each ``hx.*`` span's calls and host ms, the
      blocking syncs by span and, on a card, the between-step gaps by the
      benchmark's timing events, split among the spans the host was in;
    * ``config``, ``traffic``: the cell's configuration and mix, as
      loaded, so a reader counts a kernel's FLOPs and bytes from the
      shapes (through ``portbench.reference.nets.arch(config["arch"])``)
      against ``portbench.counts.PEAK_FLOPS`` and ``PEAK_BYTES``;
    * ``step_flops``, ``peak_flops``, ``delta_roofline_s``: the cell's
      counts of :mod:`portbench.counts`.
    """
    return types.SimpleNamespace(
        steps=w["steps"], seconds=w["seconds"],
        data_wait_s=w["data_wait_s"],
        prep_s=prep_s,
        profile=summary,
        program=spans,
        program_report=report,
        config=cell.config,
        traffic=cell.traffic,
        step_flops=counts.step_flops(cell.config, cell.traffic),
        peak_flops=counts.PEAK_FLOPS,
        delta_roofline_s=counts.delta_roofline_s(cell.config, cell.traffic))


def reference_check(cell, seed, device, work, readings):
    """The gaps between the program's readings of the first steps and
    the reference's, and ``correct`` (every gap at most its limit)."""
    cfg, traffic = cell.config, cell.traffic
    names = [f for f in os.listdir(os.path.join(work, "volumes", "image"))
             if f.endswith(".nrrd")]
    batches = ref_batches.step_batches(cfg, traffic, seed, names,
                                       traffic["check_steps"])
    w0 = weights.make_weights(Net(cfg).params(), seed, device)
    ref = follow(cfg, traffic, w0, batches, device)
    del w0
    limits = cell.limits["limits"]
    checks = {k: {"value": v, "limit": limits[k], "at": at}
              for k, (v, at) in compare.gaps(readings, ref).items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return checks, correct
