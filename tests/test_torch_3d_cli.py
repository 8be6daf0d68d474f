"""The port's 3D CLI chain on the CPU, held against hebbax's evaluation.

(a) ``pretrain_hebbian_unsup_3d`` (swta_t, K=50, ``conv`` excluded, Adam,
warmup 1 so epoch 1 trains) -> (b) ``train_sup_3d --load_hebbian_weights``
at regime 50 -> (c) ``test_3d --hebbian_pretrain 1 --postprocessing
True``, all with ``--device cpu`` and ``-n unet3d_min`` on tiny NRRD
volumes from ``scripts/make_synth_data.py::make_3d`` (written by hebbax's
writer) and 16^3 patches.  hebbax's ``offline_eval`` then scores the
port's predictions: the numbers must be equal (the same scipy and numpy
arithmetic on the same files).

Also: the port's ``test_3d`` on a hebbax-written ``unet3d_min`` snapshot
predicts what hebbax's slider predicts on it (the class-1 probabilities
agree within 1e-4, and no voxel's decision flips unless its probability
lies that close to the threshold); ``--load_weights`` loads every
parameter, the head included; the CLIs raise without CUDA unless
``--device cpu`` is given; ``train_sup_3d --dp_devices 2`` on 2 gloo CPU
ranks logs hebbax's ``--dp_devices 2`` losses.
"""

import csv
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hebbax.cli.test_3d import offline_eval as j_offline_eval
from hebbax.data.augment3d import znormalize as j_znorm
from hebbax.data.nrrd_io import read_nrrd as j_read
from hebbax.engine.sliding import slide_window_inference as j_slide
from hebbax.models import get_network as j_get_network
from hebbax.utils import checkpoint as jckpt
from hebbax_torch.cli import common, common3d
from hebbax_torch.cli import pretrain_hebbian_unsup_3d as pretrain
from hebbax_torch.cli import test_3d as ttest
from hebbax_torch.cli import train_sup_3d as finetune
from hebbax_torch.hebb import kernels
from hebbax_torch.hebb.layers import transposed_paths
from hebbax_torch.utils.checkpoint import load_state_dict

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATCH = "(16,16,16)"
SHAPE = (20, 18, 16)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "make_synth_data", os.path.join(REPO, "scripts",
                                        "make_synth_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    root = tmp_path_factory.mktemp("synth") / "Atrial"
    mod.make_3d(str(root), 4, 2, SHAPE, seed=0)
    return str(root)


def _argv(synth, tmp_path):
    return ["--device", "cpu", "--path_dataset", synth,
            "--path_root_exp", str(tmp_path / "runs"), "-n", "unet3d_min",
            "-b", "2", "-e", "2", "-w", "1", "--validate_iter", "1",
            "--patch_size", PATCH, "--samples_per_volume_train", "2",
            "--samples_per_volume_val", "2", "--num_workers", "1"]


def _read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _test_argv(synth, run):
    return ["--path_dataset", synth, "--path_exp", run, "-n", "unet3d_min",
            "--patch_size", PATCH, "--patch_overlap", "(8,8,8)", "-b", "2"]


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


def test_cli_chain_matches_hebbax_offline_eval(synth, tmp_path):
    argv = _argv(synth, tmp_path)
    # (a) Hebbian pretraining
    args_a = pretrain.add_args(common3d.base_parser_3d()).parse_args(
        argv + ["--hebb_mode", "swta_t", "--hebb_inv_temp", "50", "-l",
                "1e-3"])
    trainer = pretrain.build(args_a)
    watch = ("encoder.encoder1.conv1.weight", "decoder.upconv1.weight",
             "conv.weight")
    w0 = {n: trainer.state.model.state_dict()[n].clone() for n in watch}
    seen = _recorder(trainer, watch)
    before = kernels.SWTA_DELTA.launches
    trainer.run()
    assert kernels.SWTA_DELTA.launches == before == 0
    per_epoch = len(trainer.loaders["train"])
    assert len(seen) == 2 * per_epoch
    assert all(torch.equal(s[n], w0[n]) for s in seen[:per_epoch]
               for n in watch)                               # lr 0
    assert all(not torch.equal(seen[-1][n], w0[n]) for n in watch)
    run_a = trainer.paths.run
    assert run_a.endswith(os.path.join(
        "Atrial", "hebbian_unsup", "unet3d_min_swta_t", "inv_temp-50",
        "regime-100", "run-0"))
    snap = os.path.join(run_a, "checkpoints", "last.ckpt")

    # (b) fine-tuning from the Hebbian snapshot
    args_b = finetune.add_args(common3d.base_parser_3d()).parse_args(
        argv + ["--load_hebbian_weights", snap, "--regime", "50", "-l",
                "0.01"])
    trainer_b = finetune.build(args_b)
    model = trainer_b.state.model
    assert model.encoder.encoder1.conv1.spec.alpha == 0.0
    assert model.conv.spec is None
    loaded, meta = load_state_dict(snap, transposed_paths(model))
    assert meta["excluded_layers"] == ["conv"]
    for n, t in model.state_dict().items():
        if n.startswith("conv."):
            assert not torch.equal(t, loaded[n]), n         # re-initialised
        else:
            assert torch.equal(t, loaded[n]), n
    trainer_b.run()
    run_b = trainer_b.paths.run
    assert os.sep.join(["semi_sup", "h_unet3d_min_swta_t", "inv_temp-1",
                        "regime-50"]) in run_b
    assert os.path.exists(os.path.join(run_b, "checkpoints", "best_JI.ckpt"))

    # (c) test, post-processed, scored by both packages
    got = ttest.main(["--device", "cpu", "--hebbian_pretrain", "1",
                      "--postprocessing", "True"] + _test_argv(synth, run_b))
    names = sorted(os.listdir(os.path.join(synth, "val", "image")))
    for sub in ("test_seg_preds", "test_seg_preds_postprocessed"):
        assert sorted(os.listdir(os.path.join(run_b, sub))) == names
    ref = j_offline_eval(os.path.join(run_b, "test_seg_preds_postprocessed"),
                         os.path.join(synth, "val", "mask"))
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert 0.0 <= got["dice"] <= 1.0 and 0.0 <= got["jaccard"] <= 1.0
    assert set(got["seconds"]) == {"slider", "postprocess_eval"}
    with open(os.path.join(run_b, "test.csv")) as f:
        row = list(csv.DictReader(f))[0]
    assert list(row) == ["segm/dice", "segm/jaccard", "segm/asd",
                         "segm/95hd"]


def test_port_test_3d_on_a_hebbax_snapshot(synth, tmp_path):
    jm = j_get_network("unet3d_min", 1, 2)
    variables = jm.init(jax.random.PRNGKey(3),
                        jnp.zeros((1, 16, 16, 16, 1)), train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    apply = jax.jit(lambda p: jm.apply(variables, p, train=False))

    def probs(name):
        vol, _ = j_read(os.path.join(synth, "val", "image", name))
        logits = j_slide(lambda p: apply(jnp.asarray(p)),
                         j_znorm(vol.astype(np.float32)), (16, 16, 16),
                         (8, 8, 8), 2, batch_size=2).astype(np.float64)
        return 1.0 / (1.0 + np.exp(logits[..., 0] - logits[..., 1]))

    names = sorted(os.listdir(os.path.join(synth, "val", "image")))
    ref_probs = {n: probs(n) for n in names}
    thr = float(np.median(ref_probs[names[0]]))
    run = tmp_path / "run"
    jckpt.save_snapshot(variables, str(run / "checkpoints"), threshold=thr,
                        save_best=True)
    got = ttest.main(["--device", "cpu"] + _test_argv(synth, str(run)))
    for n in names:
        pred, hdr = j_read(os.path.join(run, "test_seg_preds", n))
        ref = (ref_probs[n] > thr).astype(np.uint8)
        near = np.abs(ref_probs[n] - thr) < 1e-4
        assert pred.dtype == np.uint8
        np.testing.assert_array_equal(pred[~near], ref[~near])
        _, img_hdr = j_read(os.path.join(synth, "val", "image", n))
        np.testing.assert_array_equal(hdr["affine"], img_hdr["affine"])
    ref = j_offline_eval(os.path.join(run, "test_seg_preds"),
                         os.path.join(synth, "val", "mask"))
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_load_weights_loads_every_parameter(synth, tmp_path):
    jm = j_get_network("unet3d_min", 1, 2)
    variables = jm.init(jax.random.PRNGKey(4),
                        jnp.zeros((1, 16, 16, 16, 1)), train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    path = jckpt.save_snapshot(variables, str(tmp_path / "snap"))
    args = finetune.add_args(common3d.base_parser_3d()).parse_args(
        _argv(synth, tmp_path) + ["--load_weights", path, "--regime", "50"])
    model, hebb = common3d.build_model_3d(args, {"IN_CHANNELS": 1,
                                                 "NUM_CLASSES": 2}, "cpu",
                                          load_weights=path)
    assert hebb is None
    np.testing.assert_array_equal(
        model.conv.weight.detach().numpy(),
        np.transpose(variables["params"]["conv"]["kernel"], (4, 3, 0, 1, 2)))
    np.testing.assert_array_equal(
        model.decoder.upconv3.weight.detach().numpy(),
        np.transpose(variables["params"]["decoder"]["upconv3"]["kernel"],
                     (3, 4, 0, 1, 2)))


def test_device_flag_raises_without_cuda(synth, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = [a for a in _argv(synth, tmp_path) if a not in ("--device",
                                                           "cpu")]
    for mod in (pretrain, finetune):
        args = mod.add_args(common3d.base_parser_3d()).parse_args(argv)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.build(args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttest.main(_test_argv(synth, str(tmp_path)))


@pytest.mark.parametrize("flag", [["--dtype", "bfloat16"],
                                  ["--dp_devices", "2"],
                                  ["--resume", "1"],
                                  ["--profile_dir", "prof"]])
def test_unported_flags_raise(flag, synth, tmp_path, capfd):
    """Every flag is ported: ``check_ported`` passes ``--dtype bfloat16``,
    ``--resume`` and ``--profile_dir``.  ``--dp_devices 2`` runs
    ``train_sup_3d --load_weights`` of a hebbax ``unet3d_min`` init on 2
    gloo CPU ranks end to end (16^3 patches, 6 per epoch in batches of 3
    padded to 4, SGD lr 1e-3, 2 epochs so that epoch 2 trains) and hebbax's
    ``train_sup_3d --dp_devices 2`` on the same flags over ``make_mesh(2)``:
    rank 0 alone prints and writes the logs and ``last.ckpt``, and the two
    ``train_log.csv`` / ``val_log.csv`` losses agree within rtol 1e-4 (the
    parity tests' loss tolerance); on the card, ``--dp_devices`` above the
    visible cards raises naming both numbers."""
    args = common3d.base_parser_3d().parse_args(flag)
    if flag[0] != "--dp_devices":
        common.check_ported(args)
        return
    over = max(2, torch.cuda.device_count() + 1)
    args = common3d.base_parser_3d().parse_args(["--dp_devices", str(over)])
    visible = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"--dp_devices {over}: only "
                                         f"{visible} CUDA cards"):
        common.check_ported(args)
    from hebbax.cli import train_sup_3d as j_finetune
    jm = j_get_network("unet3d_min", 1, 2)
    variables = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(6), jnp.zeros((1, 16, 16, 16, 1)), train=False))
    snap = jckpt.save_snapshot(variables, str(tmp_path / "snap"))
    flags = ["--path_dataset", synth, "-n", "unet3d_min", "-b", "3", "-e",
             "2", "-w", "1", "-l", "1e-3", "--validate_iter", "1",
             "--patch_size", PATCH, "--samples_per_volume_train", "3",
             "--samples_per_volume_val", "2", "--num_workers", "1",
             "--regime", "50", "--load_weights", snap, "--dp_devices", "2"]
    args = finetune.add_args(common3d.base_parser_3d()).parse_args(
        flags + ["--device", "cpu", "--path_root_exp",
                 str(tmp_path / "port")])
    capfd.readouterr()
    common.train(finetune.build, args, timeout=60, deadline=300)
    out = capfd.readouterr().out
    assert out.count("Epoch 2/2") == 1 and out.count("Training done") == 1
    j_finetune.main(flags + ["--path_root_exp", str(tmp_path / "hebbax")])
    tail = os.path.join("Atrial", "semi_sup", "unet3d_min", "inv_temp-1",
                        "regime-50", "run-0")
    port = os.path.join(str(tmp_path / "port"), tail)
    ref = os.path.join(str(tmp_path / "hebbax"), tail)
    assert os.path.exists(os.path.join(port, "checkpoints", "last.ckpt"))
    for log in ("train_log.csv", "val_log.csv"):
        got = [float(r["loss"]) for r in _read_csv(os.path.join(port, log))]
        want = [float(r["loss"]) for r in _read_csv(os.path.join(ref, log))]
        assert len(got) == len(want) == 2
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=log)
