"""The port's 3D semi-supervised CLI on the CPU: ``train_semi_3d <algo>``
for all six algorithms, then ``test_3d`` on each run's ``best_JI.ckpt``,
with ``--device cpu`` on tiny NRRD volumes from
``scripts/make_synth_data.py::make_3d`` (image, mask and ``mask_sdf1``)
and 16^3 patches; ``unet3d_min`` for EM / UAMT / CPS, ``unet3d_urpc`` for
URPC, ``unet3d_cct_min`` for CCT, ``unet3d_dtc`` for DTC.

* The run dirs are the sweep's (``semi_sup/{kaiming,h}_<algo>_<net>
  [_swta_t]/inv_temp-K/regime-R/run-S``), UAMT and CPS also write
  ``checkpoints2/last.ckpt``, and hebbax's ``offline_eval`` scores the
  port's predictions to the same numbers (the same scipy and numpy
  arithmetic on the same files).
* The Hebbian hand-offs: ``pretrain_hebbian_unsup_3d -n unet3d_urpc_s2d``
  with the sweep's exclude list (run dir ``unet3d_urpc_swta_t``: the
  folded name maps to its base) hands its snapshot to URPC, whose trunk
  loads equal to it and whose heads are re-initialised; a ``unet3d_min``
  snapshot hands off to UAMT / CPS, model 2 being its fresh init from
  seed + 7919 plus model 1's loaded parameters.
* The sweep's cross-loads (``reproduce_hebbian_semi_supervised_3d.sh``
  hands the ``unet3d`` snapshot to URPC and CCT) fail in both packages:
  hebbax raises at load for URPC (``reinit_excluded`` looks up the
  excluded ``conv`` in the URPC tree) and at the first apply for CCT (no
  ``main_decoder``); the port raises at load for both, naming the first
  entry the network needs that the snapshot lacks.
"""

import argparse
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.errors import FlaxError

from hebbax.cli import common3d as j_common3d
from hebbax.cli.test_3d import offline_eval as j_offline_eval
from hebbax.models import get_network as j_get_network
from hebbax.utils import checkpoint as jckpt
from hebbax_torch.cli import common3d
from hebbax_torch.cli import pretrain_hebbian_unsup_3d as pretrain
from hebbax_torch.cli import test_3d as ttest
from hebbax_torch.cli import train_semi_3d
from hebbax_torch.hebb import kernels
from hebbax_torch.hebb.layers import transposed_paths
from hebbax_torch.hebb.spec import HebbSpec
from hebbax_torch.models import get_network
from hebbax_torch.utils.checkpoint import load_state_dict
from hebbax_torch.utils.seeding import make_generator

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATCH = "16,16,16"
SHAPE = (20, 18, 16)
EXCLUDE = ["conv", "dsv1", "dsv2", "dsv3", "dsv4", "out_conv", "out_sdf",
           "out_seg"]
NETS = {"em": "unet3d_min", "uamt": "unet3d_min", "cps": "unet3d_min",
        "urpc": "unet3d_urpc", "cct": "unet3d_cct_min", "dtc": "unet3d_dtc"}


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "make_synth_data", os.path.join(REPO, "scripts",
                                        "make_synth_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    root = tmp_path_factory.mktemp("synth") / "Atrial"
    mod.make_3d(str(root), 4, 2, SHAPE, seed=1)
    return str(root)


def _argv(synth, root, net):
    return ["--device", "cpu", "--path_dataset", synth,
            "--path_root_exp", str(root), "-n", net, "-b", "1", "-e", "2",
            "-w", "1", "--validate_iter", "1", "--patch_size", PATCH,
            "--samples_per_volume_train", "1", "--samples_per_volume_val",
            "1"]


def _semi(algo, argv):
    """The trainer at regime 50, unsup weight 5, SGD lr 0.01."""
    return train_semi_3d.build(train_semi_3d.add_args(
        common3d.base_parser_3d(), algo).parse_args(
            argv + ["--regime", "50", "-u", "5", "-l", "0.01"]), algo)


def _test(synth, run, net, hebbian=False):
    argv = ["--device", "cpu", "--path_dataset", synth, "--path_exp", run,
            "-n", net, "--patch_size", PATCH, "--patch_overlap", "8,8,8",
            "-b", "2", "--postprocessing", "True"]
    got = ttest.main(argv + (["--hebbian_pretrain", "1"] if hebbian
                             else []))
    ref = j_offline_eval(os.path.join(run, "test_seg_preds_postprocessed"),
                         os.path.join(synth, "val", "mask"))
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert 0.0 <= got["dice"] <= 1.0 and 0.0 <= got["jaccard"] <= 1.0
    return got


@pytest.mark.parametrize("algo", list(NETS))
def test_semi_3d_then_test_3d(synth, tmp_path, algo):
    net = NETS[algo]
    trainer = _semi(algo, _argv(synth, tmp_path, net))
    if algo == "dtc":
        b = trainer.prep(next(iter(trainer.loaders["train_sup"])))
        assert b["mask_sdf"].shape == b["mask"].shape
        assert b["mask_sdf"].dtype == torch.float32
        assert "mask_sdf" not in next(iter(trainer.loaders["val"]))
    kernels.SWTA_DELTA.launches = 0
    best = trainer.run()
    assert kernels.SWTA_DELTA.launches == 0
    assert 0.0 <= best[1] <= 1.0
    run = trainer.paths.run
    assert run.endswith(os.path.join(
        "Atrial", "semi_sup", f"kaiming_{algo}_{net}", "inv_temp-1",
        "regime-50", "run-0"))
    ckpts = os.path.join(run, "checkpoints")
    assert {"best_JI.ckpt", "last.ckpt"} <= set(os.listdir(ckpts))
    dual = algo in ("uamt", "cps")
    assert os.path.exists(os.path.join(ckpts + "2", "last.ckpt")) == dual
    losses = [r["loss"] for r in trainer.train_log.rows]
    assert len(losses) == 2 and np.isfinite(losses).all()
    _test(synth, run, net)


def test_hebbian_urpc_chain(synth, tmp_path):
    args = pretrain.add_args(common3d.base_parser_3d()).parse_args(
        _argv(synth, tmp_path, "unet3d_urpc_s2d")
        + ["--hebb_inv_temp", "50", "--exclude", *EXCLUDE, "-l", "1e-3"])
    trainer = pretrain.build(args)
    model = trainer.state.model
    w0 = {n: t.clone() for n, t in model.state_dict().items()}
    trainer.run()
    run_a = trainer.paths.run
    assert run_a.endswith(os.path.join(
        "hebbian_unsup", "unet3d_urpc_swta_t", "inv_temp-50", "regime-100",
        "run-0"))
    sd = model.state_dict()
    for n in ("conv1.conv1.weight", "up_concat1.conv.conv1.weight",
              *(f"dsv{i}.weight" for i in range(1, 5))):
        assert not torch.equal(sd[n], w0[n]), n
    snap = os.path.join(run_a, "checkpoints", "last.ckpt")

    trainer = _semi("urpc", _argv(synth, tmp_path, "unet3d_urpc_s2d")
                    + ["--load_hebbian_weights", snap, "--hebb_inv_temp",
                       "50"])
    model = trainer.state.model
    assert model.conv1.conv1.spec.alpha == 0.0 and model.dsv1.spec is None
    loaded, meta = load_state_dict(snap, transposed_paths(model))
    assert meta["excluded_layers"] == EXCLUDE
    for n, t in model.state_dict().items():
        if n.startswith("dsv"):
            assert not torch.equal(t, loaded[n]), n        # re-initialised
        else:
            assert torch.equal(t, loaded[n]), n
    trainer.run()
    run = trainer.paths.run
    assert os.sep.join(["semi_sup", "h_urpc_unet3d_urpc_s2d_swta_t",
                        "inv_temp-50", "regime-50"]) in run
    _test(synth, run, "unet3d_urpc_s2d", hebbian=True)


@pytest.fixture(scope="module")
def unet3d_snapshot(synth, tmp_path_factory):
    """A ``unet3d_min`` Hebbian pretraining snapshot (one epoch)."""
    root = tmp_path_factory.mktemp("pre")
    args = pretrain.add_args(common3d.base_parser_3d()).parse_args(
        _argv(synth, root, "unet3d_min") + ["--exclude", *EXCLUDE, "-e",
                                             "1"])
    trainer = pretrain.build(args)
    trainer.run()
    return os.path.join(trainer.paths.checkpoints, "last.ckpt")


@pytest.mark.parametrize("algo", ["uamt", "cps"])
def test_dual_hebbian_hand_off(synth, tmp_path, unet3d_snapshot, algo):
    trainer = _semi(algo, _argv(synth, tmp_path, "unet3d_min")
                    + ["--load_hebbian_weights", unet3d_snapshot])
    m1, m2 = trainer.state.model1, trainer.state.model2
    fresh = get_network("unet3d_min", 1, 2, generator=make_generator(7919))
    for (n, p2), p1, p0 in zip(m2.named_parameters(), m1.parameters(),
                               fresh.parameters()):
        torch.testing.assert_close(p2, p0 + p1, rtol=0, atol=0, msg=n)
    spec = m2.encoder.encoder1.conv1.spec
    assert (spec is not None) == (algo == "uamt")  # the teacher is weight-
    assert isinstance(trainer.eval_model2.hebb, HebbSpec)  # normalized
    trainer.run()
    run = trainer.paths.run
    assert os.sep.join(["semi_sup", f"h_{algo}_unet3d_min_swta_t",
                        "inv_temp-1", "regime-50"]) in run
    # both snapshots carry the Hebbian spec; model 2's loads into test_3d
    assert os.path.exists(os.path.join(run, "checkpoints2", "last.ckpt"))
    _test(synth, run, "unet3d_min", hebbian=True)


# -- the sweep's cross-loads --------------------------------------------------

def _hebbax_unet3d_snapshot(path):
    jm = j_get_network("unet3d_min", 1, 2)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 16, 1)),
                        train=False)
    spec = HebbSpec(exclude=tuple(EXCLUDE))
    return jckpt.save_snapshot(jax.tree_util.tree_map(np.asarray, variables),
                               str(path), hebb_params=spec.to_dict(),
                               layers_excluded=EXCLUDE)


@pytest.mark.parametrize("net,missing", [
    ("unet3d_urpc_s2d", "conv1.conv1.weight"),
    ("unet3d_cct_min", "main_decoder.upconv4.weight")])
def test_unet3d_snapshot_into_urpc_or_cct_raises(tmp_path, net, missing):
    path = _hebbax_unet3d_snapshot(tmp_path)
    args = argparse.Namespace(seed=0, network=net, init_weights="kaiming",
                              patch_size=(16, 16, 16), dtype="float32")
    cfg = {"IN_CHANNELS": 1, "NUM_CLASSES": 2}
    if net.startswith("unet3d_urpc"):
        with pytest.raises(KeyError):                  # hebbax, at load
            j_common3d.build_model_3d(args, cfg, load_hebbian=path)
    else:
        model, variables, _ = j_common3d.build_model_3d(args, cfg,
                                                        load_hebbian=path)
        with pytest.raises(FlaxError, match="main_decoder"):  # first apply
            model.apply(variables, jnp.zeros((1, 16, 16, 16, 1)),
                        train=False)
    with pytest.raises(RuntimeError, match=missing):   # the port, at load
        common3d.build_model_3d(args, cfg, "cpu", load_hebbian=path)


def test_device_flag_raises_without_cuda(synth, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = _argv(synth, tmp_path, "unet3d_min")[2:]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _semi("em", argv)
    with pytest.raises(ValueError, match="unknown algorithm"):
        train_semi_3d.build(argparse.Namespace(), "vnet")


def test_defaults_are_hebbax_s():
    from hebbax.cli.train_semi_3d import ALGO_NETWORK_DEFAULT as J_DEFAULT
    from hebbax.cli.train_semi_3d import add_args as j_add_args

    assert train_semi_3d.ALGO_NETWORK_DEFAULT == J_DEFAULT
    for algo in train_semi_3d.ALGOS:
        got = vars(train_semi_3d.add_args(common3d.base_parser_3d(),
                                          algo).parse_args([]))
        ref = vars(j_add_args(j_common3d.base_parser_3d(), algo)
                   .parse_args([]))
        # --device takes 'cpu' too, and the port's flags of unported
        # paths keep hebbax's names and defaults
        assert set(got) == set(ref)
        assert {k: v for k, v in got.items() if k != "device"} == \
            {k: v for k, v in ref.items() if k != "device"}
    assert transposed_paths(get_network("unet3d_cct", 1, 2,
                                        device="meta")) == {
        f"main_decoder.upconv{i}" for i in range(1, 5)}
