"""The harness on the CPU, on stand-in cells that live only in these
tests (:mod:`.standin`): the shape of a run's last line, a traced run, a
cell, mix and metric added as files alone, a network added as files
alone, a network's readers of its own span and of its configuration
added as files alone, an unknown network or CLI named by its file, the
whole-name check of ``sys.modules``, the port's tracing on in a traced
window alone and the check's numbers the same with it, the checks that a
broken EM or Hebbian step fails, and no result without the port or
without a card."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from hebbax_torch.utils import trace as program
from portbench import counts, faults, harness, run, spec
from portbench.reference.nets import Net

from . import standin

KEYS = ["correct", "attempted", "failed", "metrics", "device"]
PROGRAM_METRICS = {"fold_ms", "optimizer_ms", "gap_ms", "gap_host_ms",
                   "syncs_per_step"}
CPU = torch.device("cpu")


def _run(root, workload, trace=0, seconds=2, env=None, device="cpu"):
    argv = [sys.executable, "portbench/run.py", "--workload", workload,
            "--seed", "2147483913", "--seconds", str(seconds),
            "--trace", str(trace)]
    if device:
        argv += ["--device", device]
    return subprocess.run(argv, cwd=root, capture_output=True, text=True,
                          timeout=600, env=standin.env() if env is None
                          else env)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return standin.make_root(tmp_path_factory.mktemp("bench"))


def test_result_line(root):
    r = _run(root, standin.CELL)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["metrics"]) == {"train_samples_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert line["device"]["platform"] == "cpu"
    # written once per checkout, then only loaded
    assert os.path.exists(os.path.join(
        root, "build", "portbench", f"snapshot.{standin.CELL}.ckpt"))
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name
    tail = r.stderr.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") for t in tail)


def _digest(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "portbench")):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[p] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_added_cell_mix_and_metric_need_no_edit(tmp_path):
    root = standin.make_root(tmp_path)
    before = _digest(root)
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "configs", "tiny3d.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny3e", data=dict(cfg["data"], train_volumes=12))
    with open(os.path.join(pb, "configs", "tiny3e.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(pb, "traffic", "tiny_em.json")) as f:
        mix = json.load(f)
    mix["flags"]["samples_per_volume_train"] = 3
    with open(os.path.join(pb, "traffic", "tiny_spv3.json"), "w") as f:
        json.dump(mix, f)
    shutil.copy(os.path.join(pb, "limits", standin.CELL + ".json"),
                os.path.join(pb, "limits", "tiny3e.tiny_spv3.json"))
    with open(os.path.join(pb, "metrics", "steps_seen.py"), "w") as f:
        f.write('LAYER = "trainer"\nMOVES = "train_samples_per_s"\n\n\n'
                "def read(ctx):\n    return float(ctx.steps)\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append(dict(bench["configs"][0], name="tiny3e",
                                 file="portbench/configs/tiny3e.json"))
    bench["workloads"].append(dict(name="tiny3e.tiny_spv3", config="tiny3e",
                                   traffic="tiny_spv3", chips=1, why="test"))
    bench["per_layer"].append(dict(name="steps_seen", unit="steps",
                                   better="higher", source="host_clock",
                                   layer="trainer",
                                   moves="train_samples_per_s",
                                   workloads=["tiny3e.tiny_spv3"]))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    r = _run(root, "tiny3e.tiny_spv3", trace=1)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["steps_seen"]["value"] == line["attempted"]
    assert {"data_wait_ms", "prep_ms"} <= set(line["metrics"])
    after = _digest(root)
    assert all(after[p] == h for p, h in before.items())


def test_added_arch_needs_no_edit(tmp_path):
    root = standin.make_root(tmp_path)
    before = _digest(root)
    pb = os.path.join(root, "portbench")
    shutil.copy(os.path.join(pb, "reference", "arch_unet3d.py"),
                os.path.join(pb, "reference", "arch_tinynet.py"))
    with open(os.path.join(pb, "configs", "tiny3d.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tinynet", arch="tinynet")
    with open(os.path.join(pb, "configs", "tinynet.json"), "w") as f:
        json.dump(cfg, f)
    shutil.copy(os.path.join(pb, "limits", standin.HEBB_CELL + ".json"),
                os.path.join(pb, "limits", "tinynet.tiny_hebb.json"))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append(dict(bench["configs"][0], name="tinynet",
                                 file="portbench/configs/tinynet.json"))
    bench["workloads"].append(dict(name="tinynet.tiny_hebb",
                                   config="tinynet", traffic="tiny_hebb",
                                   chips=1, why="test"))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    r = _run(root, "tinynet.tiny_hebb", trace=1)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["attempted"] > 0
    # the device metrics have no device to read on the CPU
    assert set(line["metrics"]) == {"data_wait_ms", "prep_ms"}
    # a mix with no snapshot writes none
    assert not os.path.exists(os.path.join(root, "build", "portbench"))
    after = _digest(root)
    assert all(after[p] == h for p, h in before.items())


# a span that a new network opens in the port and that no file of
# portbench/ names: the stand-in plants it around its model's forward
MECHANISM = "hx.standin_mechanism"
MECHANISM_READER = f'''"""Calls of the network's {MECHANISM} span a step."""

LAYER = "model"
MOVES = "train_samples_per_s"


def read(ctx):
    r = ctx.program_report
    if not r or "{MECHANISM}" not in r["spans"] or not ctx.steps:
        return None
    return r["spans"]["{MECHANISM}"]["n"] / ctx.steps
'''
# a count from the cell's configuration through its arch module, as a
# roofline reader counts its kernel's work
BOUND_READER = '''"""The forward's least time at the card's peak, in ms."""

from portbench import counts
from portbench.reference import nets

LAYER = "model"
MOVES = "train_samples_per_s"


def read(ctx):
    cfg = ctx.config
    fwd = nets.arch(cfg["arch"]).forward_flops(
        cfg, ctx.traffic["flags"]["batch_size"], tuple(cfg["patch_size"]))
    return fwd / counts.PEAK_FLOPS * 1e3
'''


def _plant_mechanism(trainer):
    model = trainer.state.model
    real = model.forward

    def forward(*a, **kw):
        with program.span(MECHANISM):
            return real(*a, **kw)

    model.forward = forward


def test_a_networks_own_readers_need_no_edit(tmp_path):
    root = standin.make_root(tmp_path)
    before = _digest(root)
    pb = os.path.join(root, "portbench")
    for name in before:
        with open(name) as f:
            assert MECHANISM not in f.read(), name
    for name, text in (("mechanism_calls", MECHANISM_READER),
                       ("forward_bound_ms", BOUND_READER)):
        with open(os.path.join(pb, "metrics", name + ".py"), "w") as f:
            f.write(text)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name, unit in (("mechanism_calls", "calls/step"),
                       ("forward_bound_ms", "ms")):
        bench["per_layer"].append(dict(
            name=name, unit=unit, better="lower", source="program_span",
            layer="model", moves="train_samples_per_s",
            workloads=[standin.CELL]))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    c = spec.Cell(root, standin.CELL, here=pb)
    r = harness.run_cell(c, 2147483647 + 18, 2, True, CPU, 0.0,
                         mutate=_plant_mechanism)
    assert r["correct"] is True and r["attempted"] > 0
    # an EM step calls the network twice: the unlabelled and the
    # labelled batch
    assert r["metrics"]["mechanism_calls"]["value"] == 2.0
    cfg = c.config
    assert r["metrics"]["forward_bound_ms"]["value"] == counts.forward_flops(
        cfg, 1, tuple(cfg["patch_size"])) / counts.PEAK_FLOPS * 1e3
    assert not program.enabled()
    after = _digest(root)
    assert all(after[p] == h for p, h in before.items())


@pytest.fixture(scope="module")
def runs(root):
    """The stand-in cell in this process on one seed: a traced run (with
    the readers' context it built), an untraced one (with each call of
    the program's ``enable`` recorded) and the checked steps alone."""
    c = spec.Cell(root, standin.CELL, here=os.path.join(root, "portbench"))
    seed = 2147483647 + 16
    got = {"cell": c, "enabled": []}
    with pytest.MonkeyPatch.context() as mp:
        real = harness._context

        def context(*a):
            got["ctx"] = real(*a)
            return got["ctx"]

        mp.setattr(harness, "_context", context)
        got["traced"] = harness.run_cell(c, seed, 2, True, CPU, 0.0)
        got["on_after_traced"] = program.enabled()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(program, "enable",
                   lambda *a, **kw: got["enabled"].append(a))
        got["untraced"] = harness.run_cell(c, seed, 2, False, CPU, 0.0)
        got["checked"] = harness.run_cell(c, seed, 0, False, CPU, 0.0,
                                          window=False)
    return got


def test_a_traced_run_hands_the_readers_the_programs_trace(runs):
    r, ctx = runs["traced"], runs["ctx"]
    assert r["correct"] is True and not runs["on_after_traced"]
    assert ctx.config is runs["cell"].config
    assert ctx.traffic is runs["cell"].traffic
    report = ctx.program_report
    assert report["cuda"] is False and "gaps" not in report
    assert ctx.steps == r["attempted"]
    assert report["spans"]["hx.step"]["n"] == r["attempted"]
    assert report["spans"]["hx.forward"]["n"] == 2 * r["attempted"]
    assert r["run"]["program"]["report"] == report
    # the CPU has no device operation, no timing event and no sync-debug
    # mode: the five readers of the program's trace find nothing, and the
    # line leaves them out
    assert ctx.program is None
    for m in PROGRAM_METRICS:
        assert runs["cell"].reader(m).read(ctx) is None, m
    assert set(r["metrics"]) == {"data_wait_ms", "prep_ms"}


def test_an_untraced_run_leaves_the_programs_tracing_off(runs):
    r = runs["untraced"]
    assert runs["enabled"] == [] and not program.enabled()
    assert set(r["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert "program" not in r["run"]


def test_the_programs_tracing_leaves_the_check_as_it_was(runs):
    checks = [{k: c["value"] for k, c in runs[run]["checks"].items()}
              for run in ("traced", "untraced", "checked")]
    assert checks[0] == checks[1] == checks[2]


@pytest.mark.parametrize("lookup,file", [
    (lambda: Net({"arch": "nosuch"}), "arch_nosuch.py"),
    (lambda: counts.forward_flops({"arch": "nosuch"}, 1, (8, 8, 8)),
     "arch_nosuch.py"),
    (lambda: harness.cli_module({"cli": "nosuch_cli"}), "nosuch_cli.py")])
def test_unknown_arch_or_cli_names_its_file(lookup, file):
    with pytest.raises(ValueError, match=re.escape(file)):
        lookup()


def test_benchmark_names_every_file_it_needs():
    root = standin.REPO
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        c = spec.Cell(root, w["name"])
        assert set(c.limits["limits"]) == {"loss", "logits", "state",
                                           "change"}
        assert c.config["reduced"] == []
    for m in bench["per_layer"]:
        reader = spec.Cell(root, bench["workloads"][0]["name"]).reader(
            m["name"])
        assert (reader.LAYER, reader.MOVES) == (m["layer"], m["moves"])


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "hebbax_torch_probe", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_probe.sub", object())
    assert "hebbax" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "hebbax.probe", object())
    monkeypatch.setitem(sys.modules, "flax", object())
    assert {"hebbax", "flax"} <= set(run.forbidden_modules())


def test_no_result_without_the_port(tmp_path):
    root = standin.make_root(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = _run(root, standin.CELL, env=env)
    assert r.returncode != 0
    assert not r.stdout.strip().startswith("{")


def test_no_result_without_a_card(root):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _run(root, standin.CELL, device=None)
    assert r.returncode == 1
    assert "{" not in r.stdout


@pytest.mark.parametrize("variant", ["program", "bf16", "unchanged",
                                     "half_batch", "altered"])
def test_the_check_catches_a_broken_step(root, variant):
    c = spec.Cell(root, standin.CELL, here=os.path.join(root, "portbench"))
    mutate, extra = faults.variant(variant)
    r = harness.run_cell(c, 2147483647 + 12, 0, False, torch.device("cpu"),
                         0.0, mutate=mutate, extra_argv=extra, window=False)
    assert r["correct"] is (variant == "program"), r["checks"]


@pytest.mark.parametrize("variant", ["program", "bf16", "unchanged",
                                     "altered", "drop_site", "half_k"])
def test_the_check_catches_a_broken_hebbian_step(root, variant):
    c = spec.Cell(root, standin.HEBB_CELL,
                  here=os.path.join(root, "portbench"))
    mutate, extra = faults.variant(variant)
    r = harness.run_cell(c, 2147483647 + 14, 0, False, torch.device("cpu"),
                         0.0, mutate=mutate, extra_argv=extra, window=False)
    assert r["correct"] is (variant == "program"), r["checks"]
