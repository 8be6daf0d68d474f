"""The port's unsupervised-pretraining CLI and the hand-off of its
snapshots, on the CPU.

``python -m hebbax_torch.cli.pretrain_unsup_2d <vae|superpix|superdiff>``
runs end to end with ``--device cpu`` on a tiny
``scripts/make_synth_data.py::make_2d`` PNG set read at 32x32 (superdiff
at 8 timesteps), writing ``loss`` and ``loss_unsup`` (and
``loss_superdiff``) to ``train_log.csv`` and ``last.ckpt`` into the
reference's run dir.  Then:

* snapshots cross both ways: a port snapshot loads in hebbax and gives
  the port's eval outputs; a hebbax snapshot loads strictly into the port
  and writes back the same bytes;
* ``--load_weights`` (:func:`hebbax_torch.cli.common.load_snapshot_into`):
  a ``unet_vae`` / ``unet_superpix`` snapshot of either package starts
  ``train_semi_2d em -n unet_s2d`` with the trunk equal to the snapshot
  and a fresh ``out_conv``; hebbax's ``build_model_2d`` takes a port
  snapshot the same way;
* the baseline's extra modules (``mu``, ``var``, ``reconstr``,
  ``out_superpix``): hebbax keeps them in the tree it hands to its EM
  step, so its EM snapshots carry them; the port drops them at the load,
  so its EM snapshots do not.  The port's ``test_2d`` takes hebbax's
  snapshot with them and gives hebbax's eval logits;
* a network's missing entry still raises (``unet`` into ``unet_urpc``).

Tolerances: eval outputs of trained weights rtol 1e-4 and atol 1e-5 of
the largest |output| (test_torch_semi_cli.py's); loads and snapshot bytes
are exact.
"""

import argparse
import csv
import importlib.util
import os
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

import hebbax.models.ddpm as jddpm
import hebbax.models.unet2d as junet
from hebbax.ops import superpix as jsp
from hebbax.utils import checkpoint as jckpt
from hebbax_torch.cli import common
from hebbax_torch.cli import pretrain_unsup_2d as unsup_cli
from hebbax_torch.cli import test_2d as ttest
from hebbax_torch.cli import train_semi_2d as semi_cli
from hebbax_torch.config.datasets import dataset_cfg
from hebbax_torch.models import get_network
from hebbax_torch.utils import checkpoint as tckpt

from test_torch_unsup2d import ddpm_variables

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET = {"vae": "unet_vae", "superpix": "unet_superpix",
       "superdiff": "unet_ddpm"}
TRUNK = ("encoder.", "main_decoder.")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "make_synth_data", os.path.join(REPO, "scripts",
                                        "make_synth_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    root = tmp_path_factory.mktemp("unsup_synth") / "GlaS"
    mod.make_2d(str(root), 6, 2, 32, seed=2)
    return str(root)


def _argv(synth, root):
    return ["--device", "cpu", "--path_dataset", synth, "--dataset_name",
            "GlaS", "--path_root_exp", str(root), "-b", "2", "-e", "2",
            "-w", "1", "--validate_iter", "1", "--num_workers", "1",
            "--debug", ""]


def _at_32(loaders):
    for ld in loaders.values():
        ld.dataset.size = (32, 32)
    return loaders


def _read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _build_unsup(synth, root, kind):
    extra = ["--timestamp_diffusion", "8"] if kind == "superdiff" else []
    args = unsup_cli.add_args(common.base_parser_2d(), kind).parse_args(
        _argv(synth, root) + ["-l", "1e-3", *extra])
    loaders = _at_32(common.make_loaders_2d(args, dataset_cfg("GlaS"),
                                            regime=100))
    return unsup_cli.build(args, kind, loaders)


@pytest.fixture(scope="module")
def runs(synth, tmp_path_factory):
    """{kind: the port's pretraining run dir}, each run once."""
    root = tmp_path_factory.mktemp("unsup_runs")
    out = {}
    for kind in unsup_cli.KINDS:
        trainer = _build_unsup(synth, root, kind)
        trainer.run()
        rel = os.path.relpath(trainer.paths.run, root)
        assert rel == os.path.join("GlaS", f"{kind}_unsup", NET[kind],
                                   "inv_temp-1", "regime-100", "run-0")
        out[kind] = trainer.paths.run
    return out


def _hebbax_init(kind):
    if kind == "superdiff":
        jm = jddpm.DDPMUNet(in_channels=3, n_cls=2)
        v = ddpm_variables(jm, jax.random.PRNGKey(1), shape=(1, 32, 32))
    else:
        jm = {"vae": junet.UNetVAE2D, "superpix": junet.UNetSuperpix2D}[
            kind](in_channels=3, n_cls=2)
        v = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)),
                    train=False)
    return jm, jax.tree_util.tree_map(np.asarray, v)


@pytest.fixture(scope="module")
def hebbax_snaps(tmp_path_factory):
    """{kind: a hebbax snapshot of hebbax's init} for vae and superpix."""
    root = tmp_path_factory.mktemp("hebbax_snaps")
    return {kind: jckpt.save_snapshot(_hebbax_init(kind)[1],
                                      str(root / kind))
            for kind in ("vae", "superpix")}


# -- the pretraining CLI ----------------------------------------------------------

@pytest.mark.parametrize("kind", unsup_cli.KINDS)
def test_pretrain_cli_writes_losses_and_snapshot(runs, kind):
    log = _read_csv(os.path.join(runs[kind], "train_log.csv"))
    cols = {"loss", "loss_unsup"} | ({"loss_superdiff"}
                                     if kind == "superdiff" else set())
    assert len(log) == 2 and cols <= set(log[0])
    assert (kind == "superdiff") == ("loss_superdiff" in log[0])
    assert all(np.isfinite(float(r[c])) for r in log for c in cols)
    val = _read_csv(os.path.join(runs[kind], "val_log.csv"))
    assert len(val) == 2 and all(np.isfinite(float(r["loss"])) for r in val)
    ckpts = os.path.join(runs[kind], "checkpoints")
    assert os.path.exists(os.path.join(ckpts, "last.ckpt"))
    sd, meta = tckpt.load_state_dict(os.path.join(ckpts, "last.ckpt"))
    get_network(NET[kind], 3, 2).load_state_dict(sd)        # strict
    assert meta["hebb_params"] is None


def test_superpix_prep_gives_hebbax_masks(synth, tmp_path):
    """The trainer's prep seeds the pseudo-masks from the host NHWC batch,
    as hebbax's does, and feeds them to the step as int64."""
    trainer = _build_unsup(synth, tmp_path, "superpix")
    batch = next(iter(trainer.loaders["train"]))
    images = np.asarray(batch["image"], np.float32)
    digest = zlib.crc32(images[0, :4, :4].tobytes())
    ref = jsp.superpix_batch(np.random.default_rng(
        np.random.SeedSequence([0, digest])), images)
    got = trainer.prep(batch)
    assert got["image"].shape == (2, 3, 32, 32) and "id" not in got
    assert got["mask_superpix"].dtype == torch.int64
    np.testing.assert_array_equal(got["mask_superpix"].numpy(), ref)


@pytest.mark.parametrize("kind", unsup_cli.KINDS)
def test_pretrain_parser_matches_hebbax(kind):
    from hebbax.cli import common as j_common
    from hebbax.cli import pretrain_unsup_2d as j_unsup
    ours = unsup_cli.add_args(common.base_parser_2d(), kind)
    ref = j_unsup.add_args(j_common.base_parser_2d(), kind)
    assert ({a.dest for a in ours._actions}
            == {a.dest for a in ref._actions})
    a, b = ours.parse_args([]), ref.parse_args([])
    for k in ("optimizer", "regime", "network", "loss", "lr",
              "thr_interval", "threshold") + (
                  ("timestamp_diffusion",) if kind == "superdiff" else ()):
        assert getattr(a, k) == getattr(b, k), k
    assert unsup_cli.PHASES == j_unsup.PHASES
    assert unsup_cli.NETWORK_DEFAULT == j_unsup.NETWORK_DEFAULT
    assert unsup_cli.HEADS == j_unsup.HEADS


def test_pretrain_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    args = unsup_cli.add_args(common.base_parser_2d(), "vae").parse_args(
        ["--path_root_exp", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        unsup_cli.build(args, "vae")
    with pytest.raises(ValueError, match="unknown pretrainer"):
        unsup_cli.build(args, "simclr")


# -- snapshots across the packages ------------------------------------------------

def _eval_outputs_close(got, ref):
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(np.transpose(g.numpy(), (0, 2, 3, 1)), r,
                                   rtol=1e-4, atol=1e-5 * np.abs(r).max())


@pytest.mark.parametrize("kind", unsup_cli.KINDS)
def test_port_snapshot_runs_in_hebbax(runs, kind):
    path = os.path.join(runs[kind], "checkpoints", "last.ckpt")
    variables, _ = jckpt.load_snapshot(path)
    jm, init = _hebbax_init(kind)
    shapes = jax.tree_util.tree_map(np.shape, init)
    assert jax.tree_util.tree_map(np.shape, variables) == shapes
    sd, _ = tckpt.load_state_dict(path)
    tm = get_network(NET[kind], 3, 2)
    tm.load_state_dict(sd)
    tm.eval()
    x = np.random.default_rng(3).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    tx = torch.from_numpy(np.transpose(x, (0, 3, 1, 2)).copy())
    with torch.no_grad():
        if kind == "vae":                   # eps 0 on both sides
            out = tm(tx)
            got = [out[k] for k in ("output", "mu", "log_var", "reconstr")]
            r = jm.apply(variables, jnp.asarray(x), train=False)
            ref = [r[k] for k in ("output", "mu", "log_var", "reconstr")]
        elif kind == "superpix":
            got, ref = tm(tx), jm.apply(variables, jnp.asarray(x),
                                        train=False)
        else:
            xin = np.concatenate([x, x[..., :2]], -1)
            t = np.array([1, 6], np.int32)
            tin = torch.from_numpy(np.transpose(xin, (0, 3, 1, 2)).copy())
            got = [tm(tin, torch.from_numpy(t).long(), mode=m)
                   for m in ("net", "net_seg")] + [tm(tx[:, :2])]
            ref = [jm.apply(variables, jnp.asarray(xin), jnp.asarray(t),
                            mode=m, train=False) for m in ("net", "net_seg")]
            ref.append(jm.apply(variables, jnp.asarray(x[..., :2]),
                                mode="probe", train=False))
    _eval_outputs_close(got, ref)


@pytest.mark.parametrize("kind", unsup_cli.KINDS)
def test_hebbax_snapshot_loads_into_port_and_back(kind, tmp_path):
    _, variables = _hebbax_init(kind)
    p1 = jckpt.save_snapshot(variables, str(tmp_path / "a"), threshold=0.5)
    sd, meta = tckpt.load_state_dict(p1)
    get_network(NET[kind], 3, 2).load_state_dict(sd)         # strict
    p2 = tckpt.save_snapshot(sd, str(tmp_path / "b"), threshold=0.5)
    with open(p1, "rb") as f1, open(p2, "rb") as f2:
        assert f1.read() == f2.read()


# -- the --load_weights hand-off ------------------------------------------------------

def _em(synth, root, snapshot):
    args = semi_cli.add_args(common.base_parser_2d(), "em").parse_args(
        _argv(synth, root) + ["-n", "unet_s2d", "--regime", "50",
                              "--load_weights", snapshot, "--optimizer",
                              "sgd", "-l", "0.01", "--loss", "dice",
                              "--unsup_weight", "5"])
    cfg = dataset_cfg("GlaS")
    sup = common.make_loaders_2d(args, cfg, sup=True)
    unsup = common.make_loaders_2d(args, cfg, sup=False, splits=("train",))
    return args, semi_cli.build(args, "em", _at_32({
        "train_sup": sup["train"], "val": sup["val"],
        "train_unsup": unsup["train"]}))


@pytest.mark.parametrize("kind,source", [("vae", "hebbax"), ("vae", "port"),
                                         ("superpix", "hebbax"),
                                         ("superpix", "port")])
def test_em_from_baseline_snapshot(synth, runs, hebbax_snaps, tmp_path,
                                   kind, source):
    snap = (hebbax_snaps[kind] if source == "hebbax" else
            os.path.join(runs[kind], "checkpoints", "last.ckpt"))
    loaded, _ = tckpt.load_state_dict(snap)
    args, trainer = _em(synth, tmp_path / "runs", snap)
    rel = os.path.relpath(trainer.paths.run, tmp_path / "runs")
    assert rel == os.path.join("GlaS", "semi_sup", "em_unet_s2d",
                               "inv_temp-1", "regime-50", "run-0")
    model = trainer.state.model
    fresh = common.new_model(args, dataset_cfg("GlaS"), "cpu")
    for n, t in model.state_dict().items():
        if n.startswith("out_conv."):        # re-initialised head
            assert torch.equal(t, fresh.state_dict()[n]), n
        else:                                # the loaded trunk, BN included
            assert n.startswith(TRUNK) and torch.equal(t, loaded[n]), n
    extra = {n.split(".")[0] for n in loaded} - {"encoder", "main_decoder",
                                                 "out_conv"}
    assert extra == ({"mu", "var", "reconstr"} if kind == "vae"
                     else {"out_superpix"})
    trainer.run()
    log = _read_csv(os.path.join(trainer.paths.run, "train_log.csv"))
    assert all(np.isfinite(float(r["loss"])) for r in log)
    best = os.path.join(trainer.paths.checkpoints, "best_JI.ckpt")
    saved, _ = tckpt.load_state_dict(best)
    assert set(saved) == set(model.state_dict())   # the port drops extras
    got = ttest.main(["--device", "cpu", "--path_dataset", synth,
                      "--dataset_name", "GlaS", "--path_exp",
                      trainer.paths.run, "--best", "JI", "-n", "unet_s2d",
                      "-b", "2", "--num_workers", "1"])
    assert all(np.isfinite(v) for v in got.values())
    assert 0.0 <= got["segm/dice"] <= 1.0 and 0.0 <= got["segm/jaccard"] <= 1.0


def _hebbax_build(snapshot, network="unet"):
    from hebbax.cli import common as j_common
    args = argparse.Namespace(seed=0, network=network,
                              init_weights="kaiming", dtype="float32")
    return j_common.build_model_2d(args, dataset_cfg("GlaS"),
                                   load_weights=snapshot,
                                   sample_shape=(1, 32, 32))


@pytest.mark.parametrize("kind", ["vae", "superpix"])
def test_port_snapshot_into_hebbax_build_model(runs, kind):
    snap = os.path.join(runs[kind], "checkpoints", "last.ckpt")
    _, variables, _ = _hebbax_build(snap)
    loaded, _ = jckpt.load_snapshot(snap)
    flat = traverse_util.flatten_dict(variables["params"])
    ref = traverse_util.flatten_dict(loaded["params"])
    for p, v in flat.items():
        if p[0] != "out_conv":
            np.testing.assert_array_equal(v, ref[p])
    # hebbax keeps the baseline's extra modules in the tree
    assert {p[0] for p in flat} - {"encoder", "main_decoder", "out_conv"} \
        == ({"mu", "var", "reconstr"} if kind == "vae" else {"out_superpix"})


def test_hebbax_em_snapshot_with_extras_into_port_test_2d(synth, hebbax_snaps,
                                                          tmp_path):
    """hebbax's EM snapshot from a VAE start: the tree its build_model_2d
    hands to the EM step (which trains mu / var / reconstr by weight decay
    only and saves them), written as best_JI.ckpt."""
    model, variables, _ = _hebbax_build(hebbax_snaps["vae"])
    assert {"mu", "var", "reconstr"} <= set(variables["params"])
    run = tmp_path / "em_run"
    jckpt.save_snapshot(jax.tree_util.tree_map(np.asarray, variables),
                        str(run / "checkpoints"), threshold=0.5,
                        save_best=True)
    got = ttest.main(["--device", "cpu", "--path_dataset", synth,
                      "--dataset_name", "GlaS", "--path_exp", str(run),
                      "--best", "JI", "-n", "unet", "-b", "2",
                      "--num_workers", "1"])
    assert all(np.isfinite(v) for v in got.values()) and got["thresh"] == 0.5
    # the port's network on that snapshot gives hebbax's eval logits
    sd, _ = tckpt.load_state_dict(str(run / "checkpoints" / "best_JI.ckpt"))
    tm = common.load_snapshot_into(get_network("unet", 3, 2), sd)
    assert not any(n.startswith(("mu.", "var.", "reconstr."))
                   for n in tm.state_dict())
    x = np.random.default_rng(4).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    ref = model.apply(variables, jnp.asarray(x), train=False)
    tm.eval()
    with torch.no_grad():
        out = tm(torch.from_numpy(np.transpose(x, (0, 3, 1, 2)).copy()))
    _eval_outputs_close([out], [ref])


# -- load_snapshot_into's rules -----------------------------------------------------

def _unet_state(seed=0, name="unet"):
    return get_network(name, 3, 2, generator=torch.Generator().manual_seed(
        seed)).state_dict()


def test_load_snapshot_into_ignores_extras_and_keeps_reinit():
    state = dict(_unet_state(1))
    state["mu.weight"] = torch.zeros(256, 256, 1, 1)
    model = get_network("unet", 3, 2,
                        generator=torch.Generator().manual_seed(2))
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    common.load_snapshot_into(model, state, reinit=("out_conv",))
    for n, t in model.state_dict().items():
        assert torch.equal(t, fresh[n] if n.startswith("out_conv.")
                           else state[n]), n


def test_load_snapshot_into_raises_naming_the_entry():
    state = dict(_unet_state(1))
    del state["encoder.down2.bn1.running_var"]
    with pytest.raises(RuntimeError, match="encoder.down2.bn1.running_var"):
        common.load_snapshot_into(get_network("unet", 3, 2), state)
    state = dict(_unet_state(1))
    state["encoder.in_conv.conv1.weight"] = torch.zeros(16, 4, 3, 3)
    with pytest.raises(RuntimeError, match="encoder.in_conv.conv1.weight"):
        common.load_snapshot_into(get_network("unet", 3, 2), state)
    # a re-initialised module may differ in shape (a superpix 1x1 head)
    state["encoder.in_conv.conv1.weight"] = _unet_state(1)[
        "encoder.in_conv.conv1.weight"]
    state["out_conv.conv_out.weight"] = torch.zeros(2, 16, 1, 1)
    common.load_snapshot_into(get_network("unet", 3, 2), state,
                              reinit=("out_conv",))


def test_unet_snapshot_into_unet_urpc_still_raises():
    with pytest.raises(RuntimeError, match="state_dict: .*'up1\\."):
        common.load_snapshot_into(get_network("unet_urpc", 3, 2),
                                  _unet_state(), reinit=("out_conv",))
