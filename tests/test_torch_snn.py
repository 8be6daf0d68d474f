"""The port's spiking VGG9 (``snn_vgg``) and its non-spiking twin
(``ann_vgg``) held against hebbax: the surrogate-gradient ``spike`` for
the four surrogates, the Poisson input, the 3x3/s2/p1 average pool, the
xavier init, both networks' forwards and one train step at their full
layer widths on 16x16 inputs, the bridge's root-level entries, and the
supervised CLI -> ``test_snn_2d`` with snapshots crossing both ways.

The SNN runs at T = 2-3 in float64 (hebbax under ``jax.enable_x64`` with
its float32 init cast up): in float32 a rounding difference at the
threshold flips a spike and the flip carries through the timesteps.
hebbax's Poisson uniforms are recorded where it draws them (its
``poisson_spikes`` wrapped with an ordered ``jax.debug.callback``, which
also works inside its ``lax.scan`` and jitted step) and passed to the
port as one ``(T, B, C, H, W)`` tensor.

Tolerances: ``spike`` forward exact, its backward rtol 1e-12 (float64);
the Poisson spikes and the pool exact / rtol 1e-12; SNN outputs atol
1e-6 (hebbax's align-corners resize weights are float32 even under x64,
so agreement stops near 1e-7 of the output scale; seen 8.7e-8 at scale
2.5); BNTT running statistics of a forward rtol 1e-9 / atol 1e-12
(float64, the same spikes, before the resize); the ANN in float32: eval
outputs rtol 1e-4 / atol 1e-5, training forwards atol 1e-4 (train-mode BN
over the 4x4 classifier map); one SGD step of either network in float64:
loss rtol 1e-6 (seen 6.4e-9), parameters and statistics rtol 1e-6 / atol
1e-7 (the grads pass back through the float32 resize weights).  Snapshot
loads and bytes are exact.
"""

import importlib.util
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

import hebbax.models.snn as jsnn
from hebbax.config.schedules import make_optimizer as j_make_optimizer
from hebbax.engine.state import TrainState as JState
from hebbax.engine.steps import make_sup_train_step as j_sup_step
from hebbax.models.registry import network_meta as j_meta
from hebbax.ops.losses import dice_loss as j_dice
from hebbax.utils import checkpoint as jckpt
from hebbax_torch import bridge
from hebbax_torch.cli import common
from hebbax_torch.cli import test_snn_2d
from hebbax_torch.cli import train_snn_sup_2d
from hebbax_torch.config.datasets import dataset_cfg
from hebbax_torch.config.schedules import make_optimizer
from hebbax_torch.engine.state import TrainState
from hebbax_torch.engine.steps import make_sup_train_step
from hebbax_torch.models import get_network, network_meta
from hebbax_torch.models import snn as tsnn
from hebbax_torch.ops.losses import dice_loss
from hebbax_torch.utils import checkpoint as tckpt

from test_torch_unet2d import to_nchw, to_nhwc

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SURROGATES = ("Linear", "FastSigm", "Exp", "PassThru")
LR = 0.1


class PoissonRecorder:
    """Records hebbax's Poisson uniforms, in draw order, while installed."""

    def __init__(self, monkeypatch):
        self.records = []

        def poisson(key, x):
            r = jax.random.uniform(key, x.shape, x.dtype)
            jax.debug.callback(lambda v: self.records.append(np.asarray(v)),
                               r, ordered=True)
            return (r <= jnp.abs(x)).astype(x.dtype) * jnp.sign(x)

        monkeypatch.setattr(jsnn, "poisson_spikes", poisson)

    def take(self, t):
        """The next forward's (T, B, C, H, W) uniforms, float64."""
        jax.effects_barrier()
        got, self.records = self.records[:t], self.records[t:]
        assert len(got) == t
        return torch.from_numpy(np.stack([np.transpose(r, (0, 3, 1, 2))
                                          for r in got]).astype(np.float64))


def snn_pair(timesteps=3, seed=0, ann=False):
    """(hebbax model, float64 numpy variables, float64 port model carrying
    them, float64 NHWC input in [-1, 1]) at 16x16, batch 2."""
    x = np.random.default_rng(seed).uniform(-1, 1, (2, 16, 16, 3))
    if ann:
        jm = jsnn.ANNVGG(in_channels=3, n_cls=2)
    else:
        jm = jsnn.SNNVGG(in_channels=3, n_cls=2, timesteps=timesteps)
    v = jm.init({"params": jax.random.PRNGKey(seed)},
                jnp.asarray(x, jnp.float32), train=False)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
    tm = (tsnn.ANNVGG(3, 2) if ann
          else tsnn.SNNVGG(3, 2, timesteps=timesteps)).double()
    tm.load_state_dict(bridge.from_flax(v["params"], v["batch_stats"]))
    return jm, v, tm, x


def _x64(fn):
    with jax.enable_x64(True):
        out = fn()
        return jax.tree_util.tree_map(np.asarray, out)


# -- pieces ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["snn_vgg", "ann_vgg"])
def test_registry_entries(name):
    assert network_meta(name) == j_meta(name)
    tm = get_network(name, 3, 2, generator=torch.Generator().manual_seed(0))
    assert isinstance(tm, {"snn_vgg": tsnn.SNNVGG,
                           "ann_vgg": tsnn.ANNVGG}[name])
    with pytest.raises(ValueError):
        get_network(name, 3, 2, hebb=object())


@pytest.mark.parametrize("grad_type", SURROGATES)
def test_spike_forward_and_surrogate_grad_match(grad_type):
    x = np.random.default_rng(1).uniform(-1.5, 1.5, (4, 37))
    x[0, :3] = (0.0, 1.0, -1.0)             # the kinks of the surrogates
    g = np.random.default_rng(2).standard_normal(x.shape)

    def j_fn():
        f = lambda a: jnp.sum(jsnn.spike(a, grad_type) * g)  # noqa: E731
        return jsnn.spike(jnp.asarray(x), grad_type), jax.grad(f)(
            jnp.asarray(x))
    ref_y, ref_g = _x64(j_fn)
    tx = torch.from_numpy(x).requires_grad_(True)
    y = tsnn.spike(tx, grad_type)
    (gx,) = torch.autograd.grad(torch.sum(y * torch.from_numpy(g)), tx)
    np.testing.assert_array_equal(y.detach().numpy(), ref_y)
    np.testing.assert_allclose(gx.numpy(), ref_g, rtol=1e-12, atol=0)


def test_unknown_surrogate_raises():
    with pytest.raises(ValueError):
        tsnn.surrogate_grad(torch.zeros(2), "Sigmoid")


def test_poisson_spikes_match():
    x = np.random.default_rng(3).uniform(-1, 1, (2, 5, 6, 3))
    key = jax.random.PRNGKey(7)
    ref = _x64(lambda: jsnn.poisson_spikes(key, jnp.asarray(x)))
    u = _x64(lambda: jax.random.uniform(key, x.shape, jnp.float64))
    got = tsnn.poisson_spikes(to_nchw(x), to_nchw(u))
    np.testing.assert_array_equal(to_nhwc(got), ref)
    assert set(np.unique(ref)) <= {-1.0, 0.0, 1.0}


@pytest.mark.parametrize("hw", [(8, 8), (7, 9), (5, 4)])
def test_avg_pool_3s2p1_matches(hw):
    x = np.random.default_rng(4).standard_normal((2,) + hw + (3,))
    ref = _x64(lambda: jsnn.avg_pool_3s2p1(jnp.asarray(x)))
    got = to_nhwc(tsnn.avg_pool_3s2p1(to_nchw(x)))
    assert got.shape[1:3] == tuple(-(-s // 2) for s in hw)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-15)


def test_xavier_gain2_bound_and_spread():
    shape = (64, 32, 3, 3)
    w = tsnn._xavier_gain2(shape, torch.Generator().manual_seed(0))
    a = 2.0 * math.sqrt(6.0 / (32 * 9 + 64 * 9))
    assert float(w.abs().max()) <= a and float(w.abs().max()) > 0.95 * a
    ref = np.asarray(jsnn._xavier_gain2(jax.random.PRNGKey(0),
                                        (3, 3, 32, 64)))
    assert abs(float(w.std()) / ref.std() - 1) < 0.03


@pytest.mark.parametrize("ann", [False, True])
def test_bridge_round_trip(ann):
    """Root-level kernels (HWIO <-> OIHW) and stacked BNTT tensors for the
    SNN, the usual conv / BN map for the ANN, and back bit for bit."""
    _, v, tm, _ = snn_pair(2, ann=ann)
    params, stats = bridge.to_flax(tm.state_dict())
    for tree, ref in ((params, v["params"]), (stats, v["batch_stats"])):
        f, r = (traverse_util.flatten_dict(tree),
                traverse_util.flatten_dict(ref))
        assert set(f) == set(r)
        for p in r:
            np.testing.assert_array_equal(f[p], r[p])
    if not ann:
        assert tm.feat0.shape == (64, 3, 3, 3)
        assert tm.output.shape == (2, 1024, 1, 1)
        assert tm.feat_bn3_scale.shape == (2, 128)
        assert tm.cls_bn_mean.shape == (2, 1024)


# -- forwards --------------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
def test_snn_forward_matches_with_hebbax_draws(monkeypatch, train):
    """Full-width SNNVGG at T=3, float64, hebbax's uniforms; a training
    forward also moves every BNTT running statistic as hebbax's does."""
    jm, v, tm, x = snn_pair(3, seed=1)
    if not train:
        # fresh statistics (var 1) leave every membrane below threshold:
        # a running variance of 0.05 on both sides lets the spikes through
        for k in v["batch_stats"]:
            if k.endswith("_var"):
                v["batch_stats"][k] = np.full_like(v["batch_stats"][k], 0.05)
        tm.load_state_dict(bridge.from_flax(v["params"], v["batch_stats"]))
    rec = PoissonRecorder(monkeypatch)
    with jax.enable_x64(True):
        out = jm.apply(jax.tree_util.tree_map(jnp.asarray, v),
                       jnp.asarray(x), train=train,
                       rngs={"poisson": jax.random.PRNGKey(5)},
                       mutable=["batch_stats"] if train else False)
        ref, mut = out if train else (out, None)
        ref = np.asarray(ref)
        mut = jax.tree_util.tree_map(np.asarray, mut)
    tm.train(train)
    with torch.no_grad():
        got = to_nhwc(tm(to_nchw(x), uniforms=rec.take(3)))
    assert np.abs(ref).max() > 0.1          # the spikes reach the output
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    sd = tm.state_dict()
    if train:
        for k, val in mut["batch_stats"].items():
            np.testing.assert_allclose(sd[k].numpy(), val, rtol=1e-9,
                                       atol=1e-12, err_msg=k)
            assert not np.array_equal(val, v["batch_stats"][k]), k
    else:
        for k, val in v["batch_stats"].items():
            assert np.array_equal(sd[k].numpy(), val), k


def test_snn_draws_from_its_generator():
    tm = get_network("snn_vgg", 3, 2,
                     generator=torch.Generator().manual_seed(0),
                     poisson_generator=torch.Generator().manual_seed(4))
    tm.timesteps = 2
    x = torch.rand(1, 3, 16, 16) * 2 - 1
    u = tm.draw_uniforms(x)
    assert u.shape == (2, 1, 3, 16, 16)
    assert not torch.equal(u[0], u[1])
    ref = torch.rand((2, 1, 3, 16, 16),
                     generator=torch.Generator().manual_seed(4))
    tm.poisson_generator = torch.Generator().manual_seed(4)
    assert torch.equal(tm.draw_uniforms(x), ref)


@pytest.mark.parametrize("train", [False, True])
def test_ann_forward_matches(train):
    jm, v, _, x = snn_pair(ann=True, seed=2)
    v32 = jax.tree_util.tree_map(lambda a: a.astype(np.float32), v)
    tm = tsnn.ANNVGG(3, 2)
    tm.load_state_dict(bridge.from_flax(v32["params"], v32["batch_stats"]))
    x32 = x.astype(np.float32)
    out = jm.apply(v32, jnp.asarray(x32), train=train,
                   mutable=["batch_stats"] if train else False)
    ref, mut = (out if train else (out, None))
    tm.train(train)
    with torch.no_grad():
        got = to_nhwc(tm(to_nchw(x32)))
    tol = dict(rtol=0, atol=1e-4) if train else dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(ref), **tol)
    if train:
        sd = tm.state_dict()
        for path, val in traverse_util.flatten_dict(
                jax.tree_util.tree_map(np.asarray,
                                       mut["batch_stats"])).items():
            name = path[0] + (".running_mean" if path[1] == "mean"
                              else ".running_var")
            np.testing.assert_allclose(sd[name].numpy(), val, rtol=1e-4,
                                       atol=1e-5, err_msg=name)


def test_ann_bn_is_scale_only_eps_1e4():
    bn = tsnn.ScaleBatchNorm2d(4)
    assert bn.bias is None and bn.eps == 1e-4
    assert torch.equal(bn.weight, torch.ones(4))
    assert sorted(bn.state_dict()) == ["running_mean", "running_var",
                                       "weight"]


# -- one train step --------------------------------------------------------------

def _compare_step(jstate, tm, rtol, atol):
    sd = tm.state_dict()
    ref = bridge.from_flax(jax.tree_util.tree_map(np.asarray, jstate.params),
                           jax.tree_util.tree_map(np.asarray,
                                                  jstate.batch_stats))
    assert set(ref) == set(sd)
    for k, val in ref.items():
        np.testing.assert_allclose(sd[k].numpy(), val.numpy(), rtol=rtol,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("name", ["snn_vgg", "ann_vgg"])
def test_sup_train_step_matches(monkeypatch, name):
    """One SGD step (lr 0.1, momentum 0.9) of ``train_sup_2d``'s step on
    carried weights in float64: loss, every parameter and the batch
    statistics (the SNN's stacked BNTT ones after T=2 timesteps)."""
    ann = name == "ann_vgg"
    jm, v, tm, x = snn_pair(2, seed=3, ann=ann)
    mask = (np.random.default_rng(4).uniform(size=(2, 16, 16)) > 0.5)
    rec = PoissonRecorder(monkeypatch)
    with jax.enable_x64(True):
        tx = j_make_optimizer("sgd", lambda c: LR, momentum=0.9,
                              weight_decay=0.0)
        vj = jax.tree_util.tree_map(jnp.asarray, v)
        jstate = JState(params=vj["params"], batch_stats=vj["batch_stats"],
                        opt_state=tx.init(vj["params"]), step=0)
        jstep = j_sup_step(jm, name, j_dice, tx)
        jstate, jout = jstep(jstate, {"image": jnp.asarray(x),
                                      "mask": jnp.asarray(mask, jnp.int32)},
                             jax.random.PRNGKey(6))
        jloss = float(jout["loss"])
    if not ann:
        uniforms = rec.take(2)
        monkeypatch.setattr(tm, "draw_uniforms", lambda _x: uniforms)
    opt = make_optimizer("sgd", tm.parameters(), momentum=0.9,
                         weight_decay=0.0)
    state = TrainState(model=tm, optimizer=opt, schedule=lambda c: LR)
    step = make_sup_train_step(tm, name, dice_loss)
    state, out = step(state, {"image": to_nchw(x),
                              "mask": torch.from_numpy(mask).long()})
    np.testing.assert_allclose(float(out["loss"]), jloss, rtol=1e-6)
    _compare_step(jstate, tm, 1e-6, 1e-7)


# -- the CLIs --------------------------------------------------------------------

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "make_synth_data", os.path.join(REPO, "scripts",
                                        "make_synth_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    root = tmp_path_factory.mktemp("snn_synth") / "GlaS"
    mod.make_2d(str(root), 4, 2, 16, seed=3)
    return str(root)


def _at_16(loaders):
    for ld in loaders.values():
        ld.dataset.size = (16, 16)
    return loaders


def _train(synth, root, regime, network=None):
    argv = ["--device", "cpu", "--path_dataset", synth, "--dataset_name",
            "GlaS", "--path_root_exp", str(root), "-b", "2", "-e", "1",
            "-w", "1", "--regime", str(regime), "--num_workers", "1",
            "--optimizer", "adam", "-l", "1e-3", "--debug", ""]
    if network:
        argv += ["-n", network]
    parser = train_snn_sup_2d.add_args(
        common.base_parser_2d({"network": "snn_vgg"}))
    args = parser.parse_args(argv)
    loaders = _at_16(common.make_loaders_2d(args, dataset_cfg("GlaS")))
    trainer = train_snn_sup_2d.build(args, loaders)
    trainer.run()
    return args, trainer


@pytest.fixture(scope="module")
def snn_run(synth, tmp_path_factory):
    root = tmp_path_factory.mktemp("snn_runs")
    return root, _train(synth, root, 50)


def test_snn_cli_run_dir_and_snapshot(snn_run):
    root, (args, trainer) = snn_run
    assert args.network == "snn_vgg"
    rel = os.path.relpath(trainer.paths.run, root)
    assert rel == os.path.join("GlaS", "semi_sup", "kaiming_snn_vgg",
                               "inv_temp-1", "regime-50", "run-0")
    rows = trainer.train_log.rows
    assert len(rows) == 1 and np.isfinite(rows[0]["loss"])
    assert trainer.state.model.poisson_generator is not None
    for name in ("best_JI.ckpt", "last.ckpt"):
        assert os.path.exists(os.path.join(trainer.paths.checkpoints, name))


def test_ann_cli_fully_supervised_run_dir(synth, tmp_path):
    _, trainer = _train(synth, tmp_path, 100, network="ann_vgg")
    rel = os.path.relpath(trainer.paths.run, tmp_path)
    assert rel == os.path.join("GlaS", "fully_sup", "ann_vgg",
                               "inv_temp-1", "regime-100", "run-0")


def test_test_snn_2d_defaults_to_snn_vgg(synth, snn_run):
    """Without ``-n`` the tester builds ``snn_vgg`` (the snapshot loads
    strictly, which the default ``unet_s2d`` would refuse) and draws its
    Poisson input in eval."""
    _, (_, trainer) = snn_run
    from hebbax_torch.config.datasets import input_stats
    from hebbax_torch.data import Loader, SegDataset2D
    mean, std = input_stats(dataset_cfg("GlaS"), "image")
    ds = SegDataset2D(os.path.join(synth, "val"), "image", mean, std,
                      split="test", sup=True, size=(16, 16))
    argv = ["--device", "cpu", "--path_dataset", synth, "--path_exp",
            trainer.paths.run, "--best", "last", "-b", "2",
            "--num_workers", "1"]
    metrics = test_snn_2d.main(argv, Loader(ds, 2, num_workers=1))
    assert all(np.isfinite(v) for v in metrics.values())
    assert 0.0 <= metrics["segm/dice"] <= 1.0
    assert os.path.exists(os.path.join(trainer.paths.run, "test.csv"))


def test_port_snapshot_loads_in_hebbax(snn_run):
    """The port's SNN snapshot is hebbax's tree: same paths, shapes and
    dtypes as hebbax's init, the port's values."""
    _, (_, trainer) = snn_run
    path = os.path.join(trainer.paths.checkpoints, "last.ckpt")
    variables, _ = jckpt.load_snapshot(path)
    jm = jsnn.SNNVGG(in_channels=3, n_cls=2)
    init = jm.init({"params": jax.random.PRNGKey(0)},
                   jnp.zeros((1, 16, 16, 3)), train=False)
    flat_v = traverse_util.flatten_dict(variables)
    flat_i = traverse_util.flatten_dict(
        jax.tree_util.tree_map(np.asarray, init))
    assert set(flat_v) == set(flat_i)
    for p in flat_i:
        assert flat_v[p].shape == flat_i[p].shape, p
    sd = trainer.state.model.state_dict()
    np.testing.assert_array_equal(
        variables["params"]["feat0"],
        np.transpose(sd["feat0"].numpy(), (2, 3, 1, 0)))
    np.testing.assert_array_equal(variables["batch_stats"]["cls_bn_var"],
                                  sd["cls_bn_var"].numpy())


@pytest.mark.parametrize("ann", [False, True])
def test_hebbax_snapshot_loads_into_port_and_back(tmp_path, ann):
    jm = (jsnn.ANNVGG(in_channels=3, n_cls=2) if ann
          else jsnn.SNNVGG(in_channels=3, n_cls=2))
    v = jax.tree_util.tree_map(np.asarray, jm.init(
        {"params": jax.random.PRNGKey(2)}, jnp.zeros((1, 16, 16, 3)),
        train=False))
    p1 = jckpt.save_snapshot(v, str(tmp_path / "a"), threshold=0.5)
    sd, _ = tckpt.load_state_dict(p1)
    get_network("ann_vgg" if ann else "snn_vgg", 3, 2).load_state_dict(sd)
    p2 = tckpt.save_snapshot(sd, str(tmp_path / "b"), threshold=0.5)
    with open(p1, "rb") as f1, open(p2, "rb") as f2:
        assert f1.read() == f2.read()
