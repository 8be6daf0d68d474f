"""The port's VNet CLI chain on the CPU, held against hebbax's evaluation:
(a) ``pretrain_hebbian_unsup_3d -n vnet --exclude out_tr.conv2`` (swta_t,
K=50, Adam, warmup 1 so epoch 1 trains) -> (b) ``train_sup_3d -n vnet
--load_hebbian_weights`` at regime 50 -> (c) ``test_3d --hebbian_pretrain
1 --postprocessing True``, all with ``--device cpu`` on tiny NRRD volumes
from ``scripts/make_synth_data.py::make_3d`` and 32^3 patches (VNet halves
its input four times).  hebbax's ``offline_eval`` scores the port's
predictions: the numbers must be equal (the same scipy and numpy
arithmetic on the same files).
"""

import csv
import importlib.util
import os

import numpy as np
import pytest
import torch

from hebbax.cli.test_3d import offline_eval as j_offline_eval
from hebbax_torch.cli import common3d
from hebbax_torch.cli import pretrain_hebbian_unsup_3d as pretrain_3d
from hebbax_torch.cli import test_3d as ttest
from hebbax_torch.cli import train_sup_3d as finetune
from hebbax_torch.hebb import kernels
from hebbax_torch.hebb.layers import transposed_paths
from hebbax_torch.utils.checkpoint import load_state_dict

from test_torch_vnet import run_dir  # noqa: F401

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _make_synth(tmp_path_factory, name, kind, *args):
    spec = importlib.util.spec_from_file_location(
        "make_synth_data", os.path.join(REPO, "scripts",
                                        "make_synth_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    root = tmp_path_factory.mktemp("synth") / name
    getattr(mod, kind)(str(root), *args, seed=0)
    return str(root)


@pytest.fixture(scope="module")
def atrial(tmp_path_factory):
    return _make_synth(tmp_path_factory, "Atrial", "make_3d", 2, 1,
                       (34, 33, 32))


def _argv_3d(root, out, net, patch):
    return ["--device", "cpu", "--path_dataset", root, "--path_root_exp",
            str(out / "runs"), "-n", net, "-b", "1", "-e", "2", "-w",
            "1", "--validate_iter", "1", "--patch_size", patch,
            "--samples_per_volume_train", "1", "--samples_per_volume_val",
            "1", "--num_workers", "1"]


def _recorder(trainer, names):
    seen = []
    step = trainer.train_step

    def recording_step(state, batch):
        state, out = step(state, batch)
        sd = state.model.state_dict()
        seen.append({n: sd[n].clone() for n in names})
        return state, out

    trainer.train_step = recording_step
    return seen


def _run_and_check(trainer, watch, mode):
    """Run a pretraining trainer: the watched kernels unchanged in epoch
    0 (lr 0) and changed in epoch 1 — under contrastive, unless every
    permutation the site drew was the identity, where the rule's two terms
    cancel exactly (Adam's moments carry an epoch-0 delta into epoch 1);
    finite losses; the snapshot's mode."""
    model = trainer.state.model
    sd = model.state_dict()
    w0 = {n: sd[n].clone() for n in watch}
    perms = {n: [] for n in watch}
    for n in watch:
        conv = model.get_submodule(n.rsplit(".", 1)[0])
        draw = conv.draw_permutation

        def recording(size, draw=draw, seen=perms[n]):
            perm = draw(size)
            seen.append(perm)
            return perm
        conv.draw_permutation = recording
    seen = _recorder(trainer, watch)
    before = kernels.SWTA_DELTA.launches
    trainer.run()
    assert kernels.SWTA_DELTA.launches == before
    per_epoch = len(trainer.loaders["train"])
    assert len(seen) == 2 * per_epoch
    for n in watch:
        assert all(torch.equal(s[n], w0[n]) for s in seen[:per_epoch]), n
        if mode != "contrastive":
            assert not torch.equal(seen[-1][n], w0[n]), n
            continue
        # one draw per training forward (validation draws none)
        assert len(perms[n]) == 2 * per_epoch, n
        identity = all(torch.equal(p, torch.arange(len(p)))
                       for p in perms[n])
        assert torch.equal(seen[-1][n], w0[n]) == identity, n
    with open(os.path.join(trainer.paths.run, "train_log.csv")) as f:
        log = list(csv.DictReader(f))
    assert len(log) == 2 and all(np.isfinite(float(r["loss"])) for r in log)
    snap = os.path.join(trainer.paths.checkpoints, "last.ckpt")
    _, meta = load_state_dict(snap, transposed_paths(model))
    assert meta["hebb_params"]["mode"] == mode
    return snap


def test_vnet_cli_chain_matches_hebbax_offline_eval(atrial, run_dir):
    argv = _argv_3d(atrial, run_dir, "vnet", "(32,32,32)")
    # (a) Hebbian pretraining: strided swta on the down convs, swta_t on
    # the up convs; one labelled volume, so one step per epoch
    args_a = pretrain_3d.add_args(common3d.base_parser_3d()).parse_args(
        argv + ["--exclude", "out_tr.conv2", "--hebb_mode", "swta_t",
                "--hebb_inv_temp", "50", "--regime", "50", "-l", "1e-3"])
    trainer = pretrain_3d.build(args_a)
    watch = ("in_tr.conv1.weight", "down_tr32.down_conv.weight",
             "up_tr32.up_conv.weight", "out_tr.conv2.weight")
    snap = _run_and_check(trainer, watch, "swta_t")
    assert trainer.paths.run.endswith(os.path.join(
        "Atrial", "hebbian_unsup", "vnet_swta_t", "inv_temp-50",
        "regime-100", "run-0"))

    # (b) fine-tuning from the Hebbian snapshot: out_tr.conv2 re-initialised
    args_b = finetune.add_args(common3d.base_parser_3d()).parse_args(
        argv + ["--load_hebbian_weights", snap, "--regime", "50", "-l",
                "0.01"])
    trainer_b = finetune.build(args_b)
    model = trainer_b.state.model
    assert model.down_tr32.down_conv.spec.alpha == 0.0
    assert model.out_tr.conv2.spec is None
    loaded, meta = load_state_dict(snap, transposed_paths(model))
    assert meta["excluded_layers"] == ["out_tr.conv2"]
    for n, t in model.state_dict().items():
        if n.startswith("out_tr.conv2."):
            assert not torch.equal(t, loaded[n]), n          # re-initialised
        else:
            assert torch.equal(t, loaded[n]), n
    trainer_b.run()
    run_b = trainer_b.paths.run
    assert os.sep.join(["semi_sup", "h_vnet_swta_t", "inv_temp-1",
                        "regime-50"]) in run_b
    assert os.path.exists(os.path.join(run_b, "checkpoints", "best_JI.ckpt"))

    # (c) test, post-processed, scored by both packages
    got = ttest.main(["--device", "cpu", "--hebbian_pretrain", "1",
                      "--postprocessing", "True", "--path_dataset", atrial,
                      "--path_exp", run_b, "-n", "vnet", "--patch_size",
                      "(32,32,32)", "--patch_overlap", "(16,16,16)", "-b",
                      "1"])
    names = sorted(os.listdir(os.path.join(atrial, "val", "image")))
    for sub in ("test_seg_preds", "test_seg_preds_postprocessed"):
        assert sorted(os.listdir(os.path.join(run_b, sub))) == names
    ref = j_offline_eval(os.path.join(run_b, "test_seg_preds_postprocessed"),
                         os.path.join(atrial, "val", "mask"))
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert 0.0 <= got["dice"] <= 1.0 and 0.0 <= got["jaccard"] <= 1.0
