"""The port's semi-supervised CLI chain on the CPU, five algorithms.

``pretrain_hebbian_unsup_2d`` (swta_t, K=50, Adam, warmup 1) of ``unet``,
``unet_urpc`` (its four heads excluded) and ``unet_cct`` (``out_conv``
excluded) -> ``train_semi_2d <algo> --load_hebbian_weights`` at regime 50
(EM, UAMT and CPS from the ``unet`` snapshot, URPC and CCT from their own
network's) -> ``test_2d --hebbian_pretrain 1`` on the best_JI snapshot,
all with ``--device cpu`` on a tiny ``scripts/make_synth_data.py::make_2d``
PNG set read at 32x32.

Checked: the run-dir tags, the snapshots (``checkpoints2/last.ckpt`` for
UAMT and CPS), no Hebbian delta in a semi run (alpha is 0), the dual
hand-offs (CPS's model 2 plain, UAMT's teacher with model 1's spec, model
2 = fresh init + model 1's loaded parameters with fresh BN statistics),
finite losses and in-range test metrics, a ``unet`` snapshot refused by
``unet_urpc``, and that each semi run's best snapshot loads in hebbax and
gives the port's eval logits: rtol 1e-4 and atol 1e-5 of the largest
|logit| (the forward tests' tolerance, scaled: trained weights give logits
of a few units, where the forward tests' initial weights give ~1; seen:
1.3e-5 on one of 4096 logits, the largest 2.7).
"""

import argparse
import csv
import importlib.util
import os

import numpy as np
import pytest
import torch

from hebbax_torch.cli import common
from hebbax_torch.cli import pretrain_hebbian_unsup_2d as pretrain
from hebbax_torch.cli import test_2d as ttest
from hebbax_torch.cli import train_semi_2d as semi_cli
from hebbax_torch.config.datasets import dataset_cfg
from hebbax_torch.hebb import kernels
from hebbax_torch.utils.checkpoint import load_state_dict

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRETRAIN_EXCLUDE = {"unet": ["out_conv"],
                    "unet_urpc": ["out_conv_dp1", "out_conv_dp2",
                                  "out_conv_dp3", "out_conv"],
                    "unet_cct": ["out_conv"]}
ALGO_NET = {"em": "unet", "uamt": "unet", "cps": "unet",
            "urpc": "unet_urpc", "cct": "unet_cct"}


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "make_synth_data", os.path.join(REPO, "scripts",
                                        "make_synth_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    root = tmp_path_factory.mktemp("semi_synth") / "GlaS"
    mod.make_2d(str(root), 6, 2, 32, seed=1)
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


def _semi_loaders(args):
    cfg = dataset_cfg(args.dataset_name)
    sup = common.make_loaders_2d(args, cfg, sup=True)
    unsup = common.make_loaders_2d(args, cfg, sup=False, splits=("train",))
    return _at_32({"train_sup": sup["train"], "val": sup["val"],
                   "train_unsup": unsup["train"]})


def _read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def snapshots(synth, tmp_path_factory):
    """{network: pretraining last.ckpt} for unet, unet_urpc, unet_cct."""
    root = tmp_path_factory.mktemp("pretrain_runs")
    out = {}
    for net, exclude in PRETRAIN_EXCLUDE.items():
        args = pretrain.add_args(common.base_parser_2d()).parse_args(
            _argv(synth, root) + ["-n", net + "_s2d", "--exclude", *exclude,
                                  "--hebb_inv_temp", "50", "-l", "1e-3"])
        cfg = dataset_cfg(args.dataset_name)
        trainer = pretrain.build(args, _at_32(
            common.make_loaders_2d(args, cfg, regime=100)))
        assert args.network == net            # the s2d name maps to base
        trainer.run()
        rel = os.path.relpath(trainer.paths.run, root)
        assert rel == os.path.join("GlaS", "hebbian_unsup",
                                   f"{net}_swta_t", "inv_temp-50",
                                   "regime-100", "run-0")
        log = _read_csv(os.path.join(trainer.paths.run, "train_log.csv"))
        assert all(np.isfinite(float(r["loss"])) for r in log)
        out[net] = os.path.join(trainer.paths.checkpoints, "last.ckpt")
    return out


def _build(synth, root, algo, snapshot, extra=()):
    args = semi_cli.add_args(common.base_parser_2d(), algo).parse_args(
        _argv(synth, root) + ["-n", ALGO_NET[algo], "--regime", "50",
                              "--load_hebbian_weights", snapshot,
                              "--hebb_inv_temp", "50", "-l", "0.01",
                              "-u", "5", *extra])
    return args, semi_cli.build(args, algo, _semi_loaders(args))


def _hebbax_eval_logits(ckpt, network, x):
    import jax
    import jax.numpy as jnp

    from hebbax.cli.common import hebbian_finetune_spec
    from hebbax.models import get_network as j_get_network
    from hebbax.utils.checkpoint import load_snapshot as j_load
    variables, meta = j_load(ckpt)
    jm = j_get_network(network, 3, 2, hebb=hebbian_finetune_spec(meta))
    out = jax.jit(lambda v, a: jm.apply(v, a, train=False))(
        variables, jnp.asarray(x))
    return np.asarray(out[0] if isinstance(out, tuple) else out)


def _port_eval_logits(ckpt, network, x):
    state, meta = load_state_dict(ckpt)
    model = common.get_network(
        network, 3, 2, hebb=common.hebbian_finetune_spec(meta),
        generator=torch.Generator().manual_seed(0))
    model.load_state_dict(state)
    model.eval()
    with torch.no_grad():
        out = model(torch.from_numpy(np.transpose(x, (0, 3, 1, 2))))
    out = out[0] if isinstance(out, tuple) else out
    return np.transpose(out.numpy(), (0, 2, 3, 1))


@pytest.mark.parametrize("algo", semi_cli.ALGOS)
def test_semi_cli_chain(synth, snapshots, tmp_path, monkeypatch, algo):
    net = ALGO_NET[algo]
    calls = []
    orig = kernels.swta_delta
    monkeypatch.setattr(kernels, "swta_delta",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    args, trainer = _build(synth, tmp_path / "runs", algo, snapshots[net])
    rel = os.path.relpath(trainer.paths.run, tmp_path / "runs")
    assert rel == os.path.join("GlaS", "semi_sup",
                               f"h_{algo}_{net}_swta_t", "inv_temp-50",
                               "regime-50", "run-0")
    state = trainer.state
    if algo in ("uamt", "cps"):
        # model 2 = its fresh init (seed + 7919) + model 1's loaded params
        fresh = common.new_model(argparse.Namespace(
            **dict(vars(args), seed=args.seed + 7919)),
            dataset_cfg("GlaS"), "cpu")
        m1 = dict(state.model1.named_parameters())
        for n, p in state.model2.named_parameters():
            torch.testing.assert_close(
                p, dict(fresh.named_parameters())[n] + m1[n])
        for n, b in state.model2.named_buffers():
            assert torch.equal(b, dict(fresh.named_buffers())[n]), n
        spec2 = state.model2.encoder.in_conv.conv1.spec
        if algo == "cps":
            assert spec2 is None                      # plain model 2
        else:
            assert spec2 is not None and spec2.w_nrm and spec2.alpha == 0
        assert state.model1.encoder.in_conv.conv1.spec.w_nrm
        before2 = state.model2.encoder.in_conv.conv1.weight.detach().clone()
    trainer.run()
    assert calls == []                              # alpha 0: no deltas
    log = _read_csv(os.path.join(trainer.paths.run, "train_log.csv"))
    assert len(log) == 2 and all(np.isfinite(float(r["loss"])) for r in log)
    ckpts = trainer.paths.checkpoints
    assert os.path.exists(os.path.join(ckpts, "best_JI.ckpt"))
    assert os.path.exists(os.path.join(ckpts, "last.ckpt"))
    assert os.path.exists(os.path.join(ckpts + "2", "last.ckpt")) == (
        algo in ("uamt", "cps"))
    if algo in ("uamt", "cps"):
        after2 = state.model2.encoder.in_conv.conv1.weight
        assert not torch.equal(after2, before2)       # EMA / 2nd SGD moved
        assert not torch.equal(after2, state.model1.encoder.in_conv.conv1
                               .weight)
        # model 2 is validated through model 1's network (its w_nrm
        # forward), as hebbax validates both members with model 1's module
        twin = trainer.eval_model2
        assert (twin is state.model2) == (algo == "uamt")
        assert twin.encoder.in_conv.conv1.spec.w_nrm
        for (n, a), b in zip(twin.state_dict().items(),
                             state.model2.state_dict().values()):
            assert torch.equal(a, b), n

    got = ttest.main(["--device", "cpu", "--path_dataset", synth,
                      "--dataset_name", "GlaS", "--path_exp",
                      trainer.paths.run, "--hebbian_pretrain", "1", "-n",
                      net, "-b", "2", "--num_workers", "1"])
    assert all(np.isfinite(v) for v in got.values())
    assert 0.0 <= got["segm/dice"] <= 1.0 and 0.0 <= got["segm/jaccard"] <= 1.0

    # the port's snapshot in hebbax: the same eval logits
    x = np.random.default_rng(0).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    best = os.path.join(ckpts, "best_JI.ckpt")
    ref = _hebbax_eval_logits(best, net, x)
    np.testing.assert_allclose(_port_eval_logits(best, net, x), ref,
                               rtol=1e-4, atol=1e-5 * np.abs(ref).max())


def test_unet_snapshot_into_urpc_raises(synth, snapshots, tmp_path):
    with pytest.raises(RuntimeError, match="state_dict"):
        _build(synth, tmp_path, "urpc", snapshots["unet"])


@pytest.mark.parametrize("algo", semi_cli.ALGOS)
def test_semi_parser_matches_hebbax(algo):
    from hebbax.cli import common as j_common
    from hebbax.cli import train_semi_2d as j_semi
    ours = semi_cli.add_args(common.base_parser_2d(), algo)
    ref = j_semi.add_args(j_common.base_parser_2d(), algo)
    assert ({a.dest for a in ours._actions}
            == {a.dest for a in ref._actions})
    assert ours.get_default("network") == ref.get_default("network")
    assert semi_cli.ALGO_NETWORK_DEFAULT == j_semi.ALGO_NETWORK_DEFAULT
    sweep = ["--optimizer", "sgd", "-l", "0.5", "--loss", "dice",
             "--unsup_weight", "5", "--validate_iter", "1"]
    a, b = ours.parse_args(sweep), ref.parse_args(sweep)
    for k in ("optimizer", "lr", "loss", "unsup_weight", "validate_iter",
              "network", "regime", "num_epochs"):
        assert getattr(a, k) == getattr(b, k), k


@pytest.mark.parametrize("regime,hebb,weights,tag,inv", [
    (10, "x.ckpt", None, "h_cps_unet_s2d_swta_t", 7),
    (10, None, "y.ckpt", "cps_unet_s2d", 1),
    (10, None, None, "kaiming_cps_unet_s2d", 1),
    (100, "x.ckpt", None, "cps_unet_s2d", 1)])
def test_semi_run_tag_matches_hebbax(tmp_path, regime, hebb, weights, tag,
                                     inv):
    from hebbax.cli import common as j_common
    from hebbax.cli import train_semi_2d as j_semi
    argv = ["--regime", str(regime), "--hebb_inv_temp", "7",
            "--path_root_exp", str(tmp_path), "--path_dataset", "d/GlaS"]
    argv += ["--load_hebbian_weights", hebb] if hebb else []
    argv += ["--load_weights", weights] if weights else []
    args = semi_cli.add_args(common.base_parser_2d(), "cps").parse_args(
        argv)
    phase, got_tag, got_inv = semi_cli.semi_run_tag(args, "cps")
    assert (got_tag, got_inv) == (tag, inv)
    ref = j_semi.semi_run_dir(j_semi.add_args(
        j_common.base_parser_2d(), "cps").parse_args(argv), "cps")
    assert ref.run == os.path.join(str(tmp_path), "GlaS", phase, tag,
                                   f"inv_temp-{inv}", f"regime-{regime}",
                                   "run-0")


def test_semi_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    args = semi_cli.add_args(common.base_parser_2d(), "em").parse_args(
        ["--path_root_exp", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        semi_cli.build(args, "em")
    with pytest.raises(ValueError, match="unknown algorithm"):
        semi_cli.build(args, "dtc")


def test_train_sup_deep_supervision_averages_heads(synth, tmp_path):
    """``train_sup_2d -ds`` on a deep4 network: the step's loss is the
    dice averaged over the four heads; without it, the primary head's."""
    from hebbax_torch.cli import train_sup_2d
    from hebbax_torch.engine.loop import to_device_batch
    from hebbax_torch.ops.losses import dice_loss

    def build(ds):
        argv = _argv(synth, tmp_path / f"ds{ds}") + ["-n", "unet_urpc",
                                                    "--regime", "50"]
        args = train_sup_2d.add_args(common.base_parser_2d()).parse_args(
            argv + (["-ds", "1"] if ds else []))
        return train_sup_2d.build(args, _at_32(common.make_loaders_2d(
            args, dataset_cfg("GlaS"))))

    batch = to_device_batch(next(iter(build(False).loaders["train"])), "cpu")
    losses = {}
    for ds in (False, True):
        trainer = build(ds)
        _, out = trainer.train_step(trainer.state, dict(batch))
        losses[ds] = float(out["loss"])
    model = build(False).state.model
    model.train()
    with torch.no_grad():
        heads = [float(dice_loss(o, batch["mask"]))
                 for o in model(batch["image"])]
    np.testing.assert_allclose(losses[False], heads[0], rtol=1e-6)
    np.testing.assert_allclose(losses[True], np.mean(heads), rtol=1e-6)
    assert losses[True] != losses[False]
