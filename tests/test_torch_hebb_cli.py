"""Every new ``--hebb_mode`` through its pretraining CLI on the CPU, 2
epochs: hpca, hpca_t and contrastive on ``unet``, ``unet_urpc`` and
``unet_cct`` (32x32); swta, hpca, hpca_t and contrastive on ``unet3d_min``
(16^3) and ``unet3d_urpc`` (32^3): finite losses, a Hebbian kernel
unchanged in epoch 0 (lr 0) and changed in epoch 1, the snapshot's
``hebb_params`` naming the mode, and the contrastive permutations drawn
from the CLI's ``hebb`` stream (seed + 6).
"""

import csv
import os

import numpy as np
import pytest
import torch

from hebbax_torch.cli import common, common3d
from hebbax_torch.cli import pretrain_hebbian_unsup_2d as pretrain_2d
from hebbax_torch.cli import pretrain_hebbian_unsup_3d as pretrain_3d
from hebbax_torch.hebb.layers import HConv

from test_torch_cli import _small_loaders
from test_torch_vnet_cli import _argv_3d, _make_synth, _run_and_check
from test_torch_vnet_cli import atrial, run_dir  # noqa: F401

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def glas(tmp_path_factory):
    return _make_synth(tmp_path_factory, "GlaS", "make_2d", 4, 2, 32)


# watched Hebbian kernels: a forward conv and, where the network has one,
# a transpose conv (unet_cct: an encoder conv — its decoder's contrastive
# deltas are NaN where a perturbation zeroes a neighbourhood, as hebbax's
# are: test_torch_hebb_rules.py::test_contrastive_is_nan_on_a_zeroed_region)
WATCH = {"unet": ("encoder.in_conv.conv1.weight",),
         "unet_urpc": ("encoder.down4.conv2.weight",),
         "unet_cct": ("encoder.in_conv.conv1.weight",),
         "unet3d_min": ("encoder.encoder1.conv1.weight",
                        "decoder.upconv1.weight"),
         "unet3d_urpc": ("conv1.conv1.weight",
                         "up_concat1.conv.conv1.weight")}
HEADS = {"unet": ("out_conv",), "unet_cct": ("out_conv",),
         "unet_urpc": ("out_conv_dp1", "out_conv_dp2", "out_conv_dp3",
                       "out_conv"),
         "unet3d_min": ("conv",),
         "unet3d_urpc": ("dsv1", "dsv2", "dsv3", "dsv4")}


@pytest.mark.parametrize("mode", ["hpca", "hpca_t", "contrastive"])
@pytest.mark.parametrize("net", ["unet", "unet_urpc", "unet_cct"])
def test_pretrain_2d_runs_every_mode(glas, run_dir, net, mode):
    """unet_cct under contrastive goes NaN, as hebbax does (its decoder's
    delta at a zeroed neighbourhood: test_torch_hebb_steps.py::
    test_unet_cct_contrastive_deltas_match_nan_sites_included): the run
    completes and writes its snapshot, its losses are NaN."""
    args = pretrain_2d.add_args(common.base_parser_2d()).parse_args(
        ["--device", "cpu", "--path_dataset", glas, "--dataset_name", "GlaS",
         "--path_root_exp", str(run_dir / "runs"), "-b", "2", "-e", "2",
         "-w", "1", "--validate_iter", "1", "--num_workers", "1",
         "--debug", "", "-n", net, "--exclude", *HEADS[net], "--hebb_mode",
         mode, "--optimizer", "adam", "-l", "1e-3"])
    trainer = pretrain_2d.build(args, _small_loaders(args, 100))
    convs = [m for m in trainer.state.model.modules()
             if isinstance(m, HConv) and m.spec is not None]
    assert convs and all(m.hebb_generator is convs[0].hebb_generator
                         for m in convs)
    if mode == "contrastive":
        ref = common.stream_generators(0, "cpu")["hebb_generator"]
        state = convs[0].hebb_generator.get_state()
        assert torch.equal(state, ref.get_state())
    if net == "unet_cct" and mode == "contrastive":
        trainer.run()
        with open(os.path.join(trainer.paths.run, "train_log.csv")) as f:
            log = list(csv.DictReader(f))
        assert len(log) == 2 and all(np.isnan(float(r["loss"]))
                                     for r in log)
        assert os.path.exists(os.path.join(trainer.paths.checkpoints,
                                           "last.ckpt"))
        return
    _run_and_check(trainer, WATCH[net], mode)


@pytest.mark.parametrize("mode", ["swta", "hpca", "hpca_t", "contrastive"])
@pytest.mark.parametrize("net", ["unet3d_min", "unet3d_urpc"])
def test_pretrain_3d_runs_every_mode(atrial, run_dir, net, mode):
    """unet3d_urpc at 32^3: at 16^3 its bottleneck is one voxel, which
    instance norm and the ReLU zero, and contrastive's delta there is NaN
    in both packages."""
    patch = "(32,32,32)" if net == "unet3d_urpc" else "(16,16,16)"
    args = pretrain_3d.add_args(common3d.base_parser_3d()).parse_args(
        _argv_3d(atrial, run_dir, net, patch)
        + ["--exclude", *HEADS[net], "--hebb_mode", mode, "-b", "3",
           "--samples_per_volume_train", "3", "--regime", "50", "-l",
           "1e-3"])
    trainer = pretrain_3d.build(args)
    _run_and_check(trainer, WATCH[net], mode)
