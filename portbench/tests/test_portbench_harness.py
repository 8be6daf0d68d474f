"""The harness on the CPU, on stand-in cells that live only in these
tests (:mod:`.standin`): the shape of a run's last line, a traced run, a
cell, mix and metric added as files alone, a network added as files
alone, an unknown network or CLI named by its file, the whole-name check
of ``sys.modules``, the checks that a broken EM or Hebbian step fails,
and no result without the port or without a card."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import counts, faults, harness, run, spec
from portbench.reference.nets import Net

from . import standin

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


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
