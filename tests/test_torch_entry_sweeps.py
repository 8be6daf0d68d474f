"""The repo's root entry points and ``reproduce_*.sh`` sweeps on the port
(``hebbax_torch.entry``, ``hebbax_torch.sweep``), held against the root
shims and hebbax's parsers.

* The table: each of the 29 root shims, read as an AST, gives the
  ``hebbax.cli`` module it calls (or, where it defines ``main`` itself,
  its own name), the positional algo or kind it passes and the flags it
  appends; ``entry.ENTRIES`` must say the same.
* Record mode: every one of the 19 sweeps, expanded by bash with the
  recording ``python``, yields lines; each resolves to an entry point,
  and the port's ``Namespace`` equals hebbax's for it.  hebbax's side
  runs the shim itself (``runpy``, ``__main__``) up to its
  ``parse_args``, so its parser and its appended flags are the shim's
  own.  Values are compared as ``str()``: the port's ``--device`` is a
  ``str`` (it takes ``cpu``) where hebbax's is an ``int``.
* Run mode: a script runs ``python train_sup_2d.py ...`` end to end on
  the CPU through the generated ``python``; a line naming another file
  stops the sweep non-zero, naming it.
"""

import argparse
import ast
import glob
import importlib
import importlib.util
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

from hebbax_torch import entry, sweep

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIMS = sorted(os.path.basename(p)[:-3] for p in glob.glob(
    os.path.join(REPO, "*.py")) if os.path.basename(p).startswith(
    ("train_", "pretrain_", "test_")))
SWEEPS = sorted(os.path.basename(p) for p in glob.glob(
    os.path.join(REPO, "reproduce_*.sh")))


def shim_spec(name):
    """(cli module, positional arg, appended flags) of a root shim, from
    its AST."""
    tree = ast.parse(open(os.path.join(REPO, name + ".py")).read())
    module, arg, defaults = None, None, []
    defines_main = any(isinstance(n, ast.FunctionDef) and n.name == "main"
                       for n in tree.body)
    for node in ast.walk(tree):
        if (isinstance(node, ast.ImportFrom) and node.module
                and node.module.startswith("hebbax.cli.")
                and any(a.name == "main" for a in node.names)):
            module = node.module.split(".")[-1]
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "main" and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            arg = node.args[0].value
        if isinstance(node, ast.If) and isinstance(node.body[0],
                                                   ast.AugAssign):
            tests = (node.test.values if isinstance(node.test, ast.BoolOp)
                     else [node.test])
            flags = tuple(t.left.value for t in tests)
            assert all(isinstance(t.ops[0], ast.NotIn) for t in tests)
            appended = [e.value for e in node.body[0].value.elts]
            defaults.append((appended[0], frozenset(flags), appended[1]))
    if defines_main:
        assert module is None and arg is None, name
        module = name
    return module, arg, defaults


def test_every_shim_and_only_they_are_in_the_table():
    assert len(SHIMS) == 29 and set(SHIMS) == set(entry.ENTRIES)


@pytest.mark.parametrize("name", SHIMS)
def test_table_agrees_with_the_shim(name):
    module, arg, defaults = shim_spec(name)
    want = entry.ENTRIES[name]
    assert (want.module, want.arg) == (module, arg)
    assert [(flags[0], frozenset(flags), value) for flags, value in
            want.defaults] == defaults
    mod = importlib.import_module(f"hebbax_torch.cli.{module}")
    assert callable(mod.main) and callable(mod.build_parser)
    assert entry.resolve(name + ".py") == entry.resolve(name)


def test_unknown_entry_point_raises_naming_it(capsys):
    with pytest.raises(entry.UnknownEntry, match="'foo.py'"):
        entry.resolve("foo.py")
    with pytest.raises(SystemExit) as e:
        entry.main(["foo.py", "--x"])
    assert "foo.py" in str(e.value.code)
    with pytest.raises(SystemExit):
        entry.main([])


def test_injected_flags_unless_given():
    e = entry.ENTRIES["test_DTC"]
    assert entry.with_defaults(e, ["--path_exp", "r"]) == [
        "--path_exp", "r", "--network", "vnet_dtc", "--dp_devices", "0"]
    assert entry.with_defaults(e, ["-n", "vnet", "--dp_devices", "2"]) == [
        "-n", "vnet", "--dp_devices", "2"]
    ns = entry.parse("test_snn_2d.py", ["--device", "cpu", "--path_exp",
                                        "r"])
    assert ns.network == "snn_vgg" and ns.device == "cpu"
    assert entry.parse("train_snn_sup_2d", []).network == "snn_vgg"
    assert entry.parse("test_DTC", ["--path_exp", "r"]).dp_devices == 0


# -- record mode --------------------------------------------------------------

@pytest.fixture(scope="module")
def recorded():
    return {s: sweep.record(os.path.join(REPO, s)) for s in SWEEPS}


class _Parsed(Exception):
    pass


@pytest.fixture(scope="module")
def hebbax_side():
    """(shim, the flags its line gives) -> (the shim's own parser, the
    words it appends), by running the shim up to its ``parse_args``."""
    cache = {}

    def get(name, argv):
        key = (name, tuple(w for w in argv if w.startswith("-")))
        if key not in cache:
            seen = {}

            def capture(self, args=None, namespace=None):
                seen["parser"] = self
                seen["argv"] = list(sys.argv[1:] if args is None else args)
                raise _Parsed

            mp = pytest.MonkeyPatch()
            mp.setattr(argparse.ArgumentParser, "parse_args", capture)
            mp.setattr(sys, "argv", [name + ".py"] + list(argv))
            try:
                with pytest.raises(_Parsed):
                    runpy.run_path(os.path.join(REPO, name + ".py"),
                                   run_name="__main__")
            finally:
                mp.undo()
            assert seen["argv"][:len(argv)] == list(argv)
            cache[key] = seen["parser"], seen["argv"][len(argv):]
        return cache[key]
    return get


def as_strings(ns):
    return {k: str(v) for k, v in vars(ns).items()}


def test_every_sweep_is_recorded(recorded):
    assert sorted(recorded) == SWEEPS and len(SWEEPS) == 19


@pytest.mark.parametrize("script", SWEEPS)
def test_sweep_lines_parse_as_in_hebbax(script, recorded, hebbax_side):
    lines = recorded[script]
    assert len(lines) > 0
    parsed = sweep.parse_lines(lines)
    assert len(parsed) == len(lines)
    for words, (name, ns) in zip(lines, parsed):
        assert name == entry.resolve(words[0])[0]
        parser, appended = hebbax_side(name, words[1:])
        want = parser.parse_args(words[1:] + appended)
        assert as_strings(ns) == as_strings(want), words


def test_recorded_words_keep_bash_splitting(recorded):
    """The unquoted ``$EXCLUDE_LAYER`` splits into four flags' values."""
    first = recorded["reproduce_hebbian_unsupervised_pretraining_2d.sh"][0]
    i = first.index("--exclude")
    assert first[0] == "pretrain_hebbian_unsup_2d.py"
    assert first[i + 1:i + 5] == ["out_conv_dp1", "out_conv_dp2",
                                  "out_conv_dp3", "out_conv"]
    ns = sweep.parse_lines([first])[0][1]
    assert ns.exclude == first[i + 1:i + 5]


# -- run mode -----------------------------------------------------------------

def _script(path, body):
    path.write_text("#!/bin/bash\n\nset -e\n\n" + body)
    return str(path)


def _make_2d(root):
    spec = importlib.util.spec_from_file_location(
        "make_synth_data", os.path.join(REPO, "scripts",
                                        "make_synth_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.make_2d(str(root), 4, 2, 32, seed=0)


def test_run_mode_trains_end_to_end(tmp_path):
    _make_2d(tmp_path / "data" / "GlaS")
    script = _script(tmp_path / "reproduce_tiny.sh", (
        "DATA_ROOT=./data\nEXP_ROOT=./runs\n"
        "python train_sup_2d.py --device cpu -e 1 -b 2 -n unet "
        "--dataset_name GlaS --path_dataset $DATA_ROOT/GlaS "
        "--path_root_exp $EXP_ROOT --regime 100 -w 1 --validate_iter 1 "
        "--num_workers 1\n"))
    r = subprocess.run([sys.executable, "-m", "hebbax_torch.sweep", script],
                       cwd=REPO, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    runs = [d for d, _, files in os.walk(tmp_path / "runs")
            if "train_log.csv" in files]
    assert len(runs) == 1, runs
    assert os.path.exists(os.path.join(runs[0], "checkpoints", "last.ckpt"))
    assert os.path.relpath(runs[0], tmp_path / "runs").startswith(
        os.path.join("GlaS", "fully_sup", "unet"))


def test_foreign_line_stops_the_sweep_naming_it(tmp_path, capsys):
    script = _script(tmp_path / "reproduce_bad.sh",
                     "python foo.py --x 1\npython test_2d.py\n")
    r = subprocess.run([sys.executable, "-m", "hebbax_torch.sweep", script],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "foo.py" in r.stderr, r.stderr
    assert sweep.main([script, "--record", str(tmp_path / "lines")]) != 0
    assert "foo.py" in capsys.readouterr().err
    with pytest.raises(sweep.LineError, match="foo.py"):
        sweep.parse_lines(sweep.record(script))


def test_record_lists_the_lines(tmp_path, capsys):
    script = _script(tmp_path / "reproduce_two.sh", (
        "for S in 0 1; do\n"
        "    python test_snn_2d.py --seed $S --path_exp './runs/a b'\n"
        "done\n"))
    out = tmp_path / "lines.txt"
    assert sweep.main([script, "--record", str(out)]) == 0
    assert out.read_text().splitlines() == [
        f"python test_snn_2d.py --seed {s} --path_exp './runs/a b'"
        for s in (0, 1)]
    assert "2  test_snn_2d" in capsys.readouterr().out


def test_entry_run_passes_loaders(tmp_path):
    """``entry.run`` hands ``loaders=`` to the CLI's ``main``: one epoch
    of ``train_sup_2d`` on the folder loaders at 32x32."""
    from hebbax_torch.cli import common
    from hebbax_torch.config.datasets import dataset_cfg

    _make_2d(tmp_path / "GlaS")
    argv = ["--device", "cpu", "-e", "1", "-b", "2", "-n", "unet",
            "--path_dataset", str(tmp_path / "GlaS"), "--path_root_exp",
            str(tmp_path / "runs"), "--regime", "100", "-w", "1",
            "--validate_iter", "1", "--num_workers", "1"]
    args = entry.parse("train_sup_2d.py", argv)
    loaders = common.make_loaders_2d(args, dataset_cfg("GlaS"))
    for ld in loaders.values():
        ld.dataset.size = (32, 32)
    best = entry.run("train_sup_2d.py", argv, loaders=loaders)
    assert len(best) == 3 and all(np.isfinite(best))
