"""The port's CLI chain on the CPU, held against hebbax's ``test_2d``.

(a) ``pretrain_hebbian_unsup_2d`` (swta_t, K=50, ``out_conv`` excluded,
Adam, warmup 1 so epoch 1 trains) -> (b) ``train_sup_2d
--load_hebbian_weights`` at regime 50 -> (c) ``test_2d
--hebbian_pretrain 1`` on (b)'s best_JI snapshot, all with ``--device
cpu`` on a tiny ``scripts/make_synth_data.py::make_2d`` PNG set.  hebbax's
own ``test_2d`` then evaluates the port's snapshot: the metrics must
agree.  Tolerance rtol 1e-6: both threshold the same probabilities up to
float32 rounding (~1e-7) and a pixel would flip only within that of the
threshold; Dice/Jaccard are counts, HD95/ASSD distances between the same
masks.

Also checked: the port's packages import no JAX, flax, optax or hebbax.
"""

import csv
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hebbax_torch.cli import common
from hebbax_torch.cli import pretrain_hebbian_unsup_2d as pretrain
from hebbax_torch.cli import test_2d as ttest
from hebbax_torch.cli import train_sup_2d as finetune
from hebbax_torch.hebb import kernels

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "make_synth_data", os.path.join(REPO, "scripts",
                                        "make_synth_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    root = tmp_path_factory.mktemp("synth") / "GlaS"
    mod.make_2d(str(root), 6, 2, 32, seed=0)
    return str(root)


def _small_loaders(args, regime):
    """The CLI's own folder loaders at 32x32 (the UNet's minimum is 16)."""
    from hebbax_torch.config.datasets import dataset_cfg
    loaders = common.make_loaders_2d(args, dataset_cfg(args.dataset_name),
                                     regime=regime)
    for ld in loaders.values():
        ld.dataset.size = (32, 32)
    return loaders


def _read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_cli_chain_matches_hebbax_test(synth, tmp_path):
    common_argv = ["--device", "cpu", "--path_dataset", synth,
                   "--dataset_name", "GlaS", "--path_root_exp",
                   str(tmp_path / "runs"), "-b", "2", "-e", "2", "-w", "1",
                   "--validate_iter", "1", "--num_workers", "1",
                   "--debug", ""]
    # (a) Hebbian pretraining
    args_a = pretrain.add_args(common.base_parser_2d()).parse_args(
        common_argv + ["-n", "unet", "--exclude", "out_conv",
                       "--hebb_mode", "swta_t", "--hebb_inv_temp", "50",
                       "--optimizer", "adam", "-l", "1e-3"])
    trainer = pretrain.build(args_a, _small_loaders(args_a, 100))
    model = trainer.state.model
    name = "encoder.in_conv.conv1.weight"
    w0 = model.state_dict()[name].clone()
    seen = []
    step = trainer.train_step

    def recording_step(state, batch):
        state, out = step(state, batch)
        seen.append(state.model.state_dict()[name].clone())
        return state, out

    trainer.train_step = recording_step
    trainer.run()
    per_epoch = len(trainer.loaders["train"])
    assert len(seen) == 2 * per_epoch
    assert all(torch.equal(w, w0) for w in seen[:per_epoch])   # lr 0
    assert not torch.equal(seen[-1], w0)                      # epoch 1
    assert kernels.SWTA_DELTA.launches == 0                   # CPU: plain
    run_a = trainer.paths.run
    log = _read_csv(os.path.join(run_a, "train_log.csv"))
    assert len(log) == 2 and all(np.isfinite(float(r["loss"])) for r in log)

    # (b) fine-tuning from the Hebbian snapshot
    args_b = finetune.add_args(common.base_parser_2d()).parse_args(
        common_argv + ["-n", "unet", "--load_hebbian_weights",
                       os.path.join(run_a, "checkpoints", "last.ckpt"),
                       "--regime", "50", "-l", "0.01"])
    trainer_b = finetune.build(args_b, _small_loaders(args_b, 50))
    assert trainer_b.state.model.encoder.in_conv.conv1.spec.alpha == 0.0
    assert trainer_b.state.model.out_conv.conv1.spec is None
    trainer_b.run()
    run_b = trainer_b.paths.run
    assert os.path.exists(os.path.join(run_b, "checkpoints", "best_JI.ckpt"))

    # (c) test: the port and hebbax on the port's snapshot
    argv_c = ["--path_dataset", synth, "--dataset_name", "GlaS",
              "--path_exp", run_b, "--hebbian_pretrain", "1", "-n", "unet",
              "-b", "2", "--num_workers", "1"]
    got = ttest.main(["--device", "cpu"] + argv_c)
    from hebbax.cli.test_2d import main as hebbax_test
    ref = hebbax_test(argv_c)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)
    row = _read_csv(os.path.join(run_b, "test.csv"))[0]
    assert set(row) == set(ref)


def test_device_flag_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        common.resolve_device("0")
    assert common.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("flag", [["--dtype", "bfloat16"],
                                  ["--dp_devices", "2"],
                                  ["--resume", "1"]])
def test_unported_flags_raise(flag):
    args = common.base_parser_2d().parse_args(flag)
    with pytest.raises(NotImplementedError):
        common.check_ported(args)


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import hebbax_torch, hebbax_torch.bridge, hebbax_torch.build\n"
        "import hebbax_torch.hebb, hebbax_torch.hebb.kernels\n"
        "import hebbax_torch.cli.pretrain_hebbian_unsup_2d\n"
        "import hebbax_torch.cli.train_sup_2d, hebbax_torch.cli.test_2d\n"
        "import hebbax_torch.cli.train_semi_2d, hebbax_torch.engine.semi\n"
        "import hebbax_torch.ops.ema, hebbax_torch.config.ramps\n"
        "import hebbax_torch.cli.pretrain_unsup_2d, hebbax_torch.models.ddpm\n"
        "import hebbax_torch.ops.diffusion, hebbax_torch.ops.superpix\n"
        "import hebbax_torch.cli.pretrain_hebbian_unsup_3d\n"
        "import hebbax_torch.cli.train_sup_3d, hebbax_torch.cli.test_3d\n"
        "import hebbax_torch.cli.common3d, hebbax_torch.engine.sliding\n"
        "import hebbax_torch.data.volumes3d, hebbax_torch.data.augment3d\n"
        "import hebbax_torch.data.nrrd_io, hebbax_torch.models.unet3d\n"
        "import hebbax_torch.ops.morphology, hebbax_torch.ops.distance\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'hebbax'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
