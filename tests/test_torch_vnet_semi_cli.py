"""The port's 3D semi-supervised CLI on the VNet family, on the CPU:
``train_semi_3d em | uamt | cps -n vnet``, ``cct -n vnet_cct`` and ``dtc
-n vnet_dtc`` from kaiming (regime 50, 2 epochs of one step, warmup 1,
32^3 patches: VNet halves its input four times), then ``test_3d`` on each
run's ``best_JI.ckpt``, with ``--device cpu`` on tiny NRRD volumes from
``scripts/make_synth_data.py::make_3d`` (image, mask and ``mask_sdf1``).
The run dirs are the sweep's (``semi_sup/kaiming_<algo>_<net>/...``), no
K1 launch, finite losses, the networks' parameters moved in epoch 1, UAMT
and CPS also write ``checkpoints2/last.ckpt``, and hebbax's
``offline_eval`` scores the port's predictions to the same numbers (the
same scipy and numpy arithmetic on the same files).
"""

import os

import numpy as np
import pytest
import torch

from hebbax.cli.test_3d import offline_eval as j_offline_eval
from hebbax_torch.cli import common3d
from hebbax_torch.cli import test_3d as ttest
from hebbax_torch.cli import train_semi_3d
from hebbax_torch.hebb import kernels

from test_torch_vnet import run_dir  # noqa: F401
from test_torch_vnet_cli import _make_synth

torch.set_num_threads(2)

NETS = {"em": "vnet", "uamt": "vnet", "cps": "vnet", "cct": "vnet_cct",
        "dtc": "vnet_dtc"}


@pytest.fixture(scope="module")
def atrial(tmp_path_factory):
    return _make_synth(tmp_path_factory, "Atrial", "make_3d", 2, 1,
                       (33, 32, 34))


@pytest.mark.parametrize("algo", list(NETS))
def test_semi_3d_on_vnet_then_test_3d(atrial, run_dir, algo):
    net = NETS[algo]
    args = train_semi_3d.add_args(common3d.base_parser_3d(), algo)\
        .parse_args(["--device", "cpu", "--path_dataset", atrial,
                     "--path_root_exp", str(run_dir), "-n", net, "-b", "1",
                     "-e", "2", "-w", "1", "--validate_iter", "1",
                     "--patch_size", "32,32,32",
                     "--samples_per_volume_train", "1",
                     "--samples_per_volume_val", "1", "--regime", "50",
                     "-u", "5", "-l", "0.01", "--num_workers", "1"])
    trainer = train_semi_3d.build(args, algo)
    dual = algo in ("uamt", "cps")
    models = ([trainer.state.model1, trainer.state.model2] if dual
              else [trainer.state.model])
    name = "down_tr32.down_conv.weight"
    w0 = [m.state_dict()[name].clone() for m in models]
    kernels.SWTA_DELTA.launches = 0
    best = trainer.run()
    assert kernels.SWTA_DELTA.launches == 0
    assert 0.0 <= best[1] <= 1.0
    losses = [r["loss"] for r in trainer.train_log.rows]
    assert len(losses) == 2 and all(np.isfinite(v) for v in losses)
    for m, w in zip(models, w0):
        assert not torch.equal(m.state_dict()[name], w)
    run = trainer.paths.run
    assert run.endswith(os.path.join(
        "Atrial", "semi_sup", f"kaiming_{algo}_{net}", "inv_temp-1",
        "regime-50", "run-0"))
    ckpts = trainer.paths.checkpoints
    assert os.path.exists(os.path.join(ckpts, "best_JI.ckpt"))
    assert os.path.exists(os.path.join(ckpts + "2", "last.ckpt")) == dual

    got = ttest.main(["--device", "cpu", "--path_dataset", atrial,
                      "--path_exp", run, "-n", net, "--patch_size",
                      "32,32,32", "--patch_overlap", "16,16,16", "-b", "1",
                      "--postprocessing", "True"])
    ref = j_offline_eval(os.path.join(run, "test_seg_preds_postprocessed"),
                         os.path.join(atrial, "val", "mask"))
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert 0.0 <= got["dice"] <= 1.0 and 0.0 <= got["jaccard"] <= 1.0
