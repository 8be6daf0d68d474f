"""The port's 3D unsupervised baselines held against hebbax: the networks
``unet3d_vae`` (UNet3DVAE) and ``unet3d_superpix`` (UNet3DSuperpix), one
and two steps of their probe pretraining, the 3D superpixel pseudo-masks
and the central-slice superdiff step of ``pretrain_unsup_3d``, and the CLI
chain ``pretrain_unsup_3d`` -> ``train_semi_3d em --load_weights`` ->
``test_3d`` with snapshots crossing both ways.

The networks run at 4 initial features on numpy-seeded 2x32^3 inputs;
the CLI chain at 32^3 runs the sweep's names at 8 (``narrow_registry``:
at their full 64, each snapshot would take 360 MB of disk, and the
chain writes ten).  hebbax's latent eps is recorded
where it draws it (test_torch_unsup2d.py's ``DrawRecorder``) and passed to
the port; the superdiff draws are recomputed from hebbax's key splits
(test_torch_unsup2d.py's ``_forward_draws``).  The pseudo-masks and the
central slice come from each package's own trainer ``prep`` on the same
host batch (hebbax's built at 4 initial features).

Tolerances, those of test_torch_3d_semi_nets.py / _steps.py: outputs
within 1e-4 of max(1, their largest |value|); BN statistics rtol 1e-4 /
atol 1e-5; losses rtol 1e-4; after two SGD steps (warmup 1, lr 1e-2,
momentum 0.9, weight decay 5e-5) parameters and BN statistics rtol 1e-4 /
atol 1e-5.  The superdiff step's losses rtol 1e-4 and logits atol 1e-4
(test_torch_unsup2d.py's).  Pseudo-masks, slices, loads and snapshot
bytes are exact.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

import hebbax.cli.common3d as j_common3d
import hebbax.cli.pretrain_unsup_2d as j_cli2d
import hebbax.cli.pretrain_unsup_3d as j_cli3d
import hebbax.models.ddpm as jddpm
import hebbax.models.unet3d as j3d
from hebbax.engine.state import TrainState as JState
from hebbax.engine.steps import make_probe_pretrain_step as j_probe_step
from hebbax.models.registry import network_meta as j_meta
from hebbax.ops import losses as jlosses
from hebbax.utils import checkpoint as jckpt
from hebbax_torch import bridge
from hebbax_torch.cli import common3d
from hebbax_torch.cli import pretrain_unsup_3d as unsup3d
from hebbax_torch.cli import test_3d as ttest
from hebbax_torch.cli import train_semi_3d
from hebbax_torch.cli.pretrain_unsup_2d import make_superdiff_step
from hebbax_torch.engine.loop import to_device_batch_3d
from hebbax_torch.engine.state import TrainState
from hebbax_torch.engine.steps import make_probe_pretrain_step
from hebbax_torch.hebb.layers import transposed_paths
from hebbax_torch.models import get_network, network_meta
from hebbax_torch.models.unet3d import UNet3D, UNet3DSuperpix, UNet3DVAE
from hebbax_torch.models.unet3d_s2d import UNet3DS2D
from hebbax_torch.ops import losses as tlosses
from hebbax_torch.ops.dropout import Dropout
from hebbax_torch.ops.losses import dice_loss
from hebbax_torch.utils import checkpoint as tckpt

from test_torch_3d_semi_nets import outputs_close, stats_close
from test_torch_3d_semi_steps import (compare_state, j_batch_3d, j_opt,
                                      semi_batches_3d, t_opt)
from test_torch_unet2d import no_dropout, to_nhwc  # noqa: F401
from test_torch_unsup2d import (T, DrawRecorder, _forward_draws,
                                ddpm_variables)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEATURES = 4
NETS = {"unet3d_vae": (j3d.UNet3DVAE, UNet3DVAE),
        "unet3d_superpix": (j3d.UNet3DSuperpix, UNet3DSuperpix)}
KIND = {"vae": "unet3d_vae", "superpix": "unet3d_superpix"}
LR = 1e-2


def to_j(t):
    """NCDHW tensor -> NDHWC numpy."""
    return np.moveaxis(t.detach().numpy(), 1, -1)


def pair_3d(name, seed=0):
    """(hebbax model, numpy variables, port model carrying them, NDHWC
    input) at 4 initial features, 2x32^3."""
    jcls, tcls = NETS[name]
    jm = jcls(in_channels=1, n_cls=2, init_features=FEATURES)
    x = np.random.default_rng(seed).standard_normal(
        (2, 32, 32, 32, 1)).astype(np.float32)
    v = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(seed), jnp.asarray(x), train=False))
    tm = tcls(1, 2, init_features=FEATURES)
    tm.load_state_dict(bridge.from_flax(v["params"], v["batch_stats"],
                                        transposed_paths(tm)))
    return jm, v, tm, x


def _tx(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _vae_out(o):
    return [o[k] for k in ("output", "mu", "log_var", "reconstr")]


# -- networks --------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(NETS))
def test_registry_entries(name):
    assert network_meta(name) == j_meta(name)
    tm = get_network(name, 1, 2, generator=torch.Generator().manual_seed(0))
    assert isinstance(tm, NETS[name][1])
    assert tm.encoder.encoder1.conv1.weight.shape[0] == 64


def test_vae_eval_forward_matches_without_latent():
    jm, v, tm, x = pair_3d("unet3d_vae", seed=1)
    ref = jm.apply(v, jnp.asarray(x), train=False)          # eps = 0
    with torch.no_grad():
        got = tm.eval()(_tx(x))
    outputs_close(_vae_out(got), _vae_out(ref))


def test_vae_train_forward_with_hebbax_eps(monkeypatch):
    jm, v, tm, x = pair_3d("unet3d_vae", seed=2)
    rec = DrawRecorder(monkeypatch)
    ref, mut = jm.apply(v, jnp.asarray(x), train=True,
                        rngs={"latent": jax.random.PRNGKey(3)},
                        mutable=["batch_stats"])
    jax.effects_barrier()
    (kind, eps), = rec.records
    assert kind == "normal" and eps.shape == (2, 2, 2, 2, 64)
    with torch.no_grad():
        got = tm.train()(_tx(x), eps=_tx(eps))
    outputs_close(_vae_out(got), _vae_out(ref))
    stats_close(mut["batch_stats"], tm)


def test_vae_draws_eps_from_its_generator():
    tm = get_network("unet3d_vae", 1, 2,
                     generator=torch.Generator().manual_seed(0),
                     latent_generator=torch.Generator().manual_seed(3))
    std = torch.ones(1, 1024, 1, 1, 1)
    ref = torch.randn(std.shape, generator=torch.Generator().manual_seed(3))
    assert torch.equal(tm.draw_latent(std), ref)
    assert torch.equal(UNet3DVAE(1, 2, init_features=FEATURES).draw_latent(
        std), torch.zeros_like(std))


@pytest.mark.parametrize("train", [False, True])
def test_superpix_forward_matches(train):
    jm, v, tm, x = pair_3d("unet3d_superpix", seed=4)
    out = jm.apply(v, jnp.asarray(x), train=train,
                   mutable=["batch_stats"] if train else False)
    ref, mut = out if train else (out, None)
    tm.train(train)
    with torch.no_grad():
        got = tm(_tx(x))
    outputs_close(list(got), list(ref))
    if train:
        stats_close(mut["batch_stats"], tm)


@pytest.mark.parametrize("name", sorted(NETS))
def test_bridge_round_trip(name):
    _, v, tm, _ = pair_3d(name)
    params, stats = bridge.to_flax(tm.state_dict(), transposed_paths(tm))
    for tree, ref in ((params, v["params"]), (stats, v["batch_stats"])):
        f, r = (traverse_util.flatten_dict(tree),
                traverse_util.flatten_dict(ref))
        assert set(f) == set(r)
        for p in r:
            np.testing.assert_array_equal(f[p], r[p])


# -- probe pretraining steps -------------------------------------------------------

def _sp_masks(b, seed=0):
    return unsup3d.superpix_masks_3d(b["image"], seed).astype(np.int32)


@pytest.mark.parametrize("kind", ["vae", "superpix"])
def test_probe_pretrain_steps_match(monkeypatch, kind):
    """Two steps of ``pretrain_unsup_3d``'s probe step (the probe's dice
    trains only ``conv``; the ELBO or the superpixel dice trains every
    parameter) against hebbax's jitted step, hebbax's eps replayed."""
    name = KIND[kind]
    jm, v, tm, _ = pair_3d(name, seed=5)
    batches = [b for b, _ in semi_batches_3d(6)]
    for b in batches:
        b["mask_superpix"] = _sp_masks(b)
    rec = DrawRecorder(monkeypatch)
    if kind == "vae":
        j_unsup = lambda o, b: jlosses.elbo_metric(o, b["image"])  # noqa
        t_unsup = lambda o, b: tlosses.elbo_metric(o, b["image"])  # noqa
    else:
        j_unsup = lambda o, b: jlosses.dice_loss(  # noqa: E731
            o[1], b["mask_superpix"])
        t_unsup = lambda o, b: dice_loss(o[1], b["mask_superpix"])  # noqa
    tx = j_opt("sgd", LR)
    jstep = jax.jit(j_probe_step(jm, name, jlosses.dice_loss, tx, j_unsup,
                                 head_names=("conv",)))
    js = JState(params=v["params"], batch_stats=v["batch_stats"],
                opt_state=tx.init(v["params"]), step=0)
    jouts = []
    for i, b in enumerate(batches):
        jb = j_batch_3d(b)
        jb["mask_superpix"] = jnp.asarray(b["mask_superpix"])
        js, out = jstep(js, jb, jax.random.PRNGKey(10 + i))
        jouts.append({k: float(out[k]) for k in ("loss", "loss_unsup")})
    jax.effects_barrier()
    eps = [r for k, r in rec.records if k == "normal"]
    assert len(eps) == (2 if kind == "vae" else 0)
    if kind == "vae":
        draws = iter(_tx(e) for e in eps)
        tm.draw_latent = lambda std: next(draws)

    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    opt, sched = t_opt("sgd", tm.parameters(), LR)
    state = TrainState(model=tm, optimizer=opt, schedule=sched)
    step = make_probe_pretrain_step(tm, name, dice_loss, t_unsup,
                                    head_names=unsup3d.HEADS_3D[kind])
    for b, jout in zip(batches, jouts):
        tb = to_device_batch_3d(b, "cpu")
        tb["mask_superpix"] = torch.from_numpy(b["mask_superpix"]).long()
        state, out = step(state, tb)
        for k, ref in jout.items():
            np.testing.assert_allclose(float(out[k]), ref, rtol=1e-4,
                                       err_msg=k)
    compare_state(js.params, js.batch_stats, tm)
    after = dict(tm.named_parameters())
    assert {n for n in after if n.endswith(".weight")} <= {
        n for n in after if not torch.equal(after[n], before[n])}


# -- the CLI's preps and the central-slice superdiff step ---------------------------

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "make_synth_data", os.path.join(REPO, "scripts",
                                        "make_synth_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    root = tmp_path_factory.mktemp("unsup3d_synth") / "Atrial"
    mod.make_3d(str(root), 4, 2, (34, 32, 32), seed=5)
    return str(root)


def _argv(synth, root, patch="32,32,32", b="2"):
    return ["--path_dataset", synth, "--path_root_exp", str(root), "-b", b,
            "-e", "1", "-w", "1", "--patch_size", patch,
            "--samples_per_volume_train", "1", "--samples_per_volume_val",
            "1", "--num_workers", "1", "-l", "1e-3"]


def _hebbax_trainer(monkeypatch, synth, root, kind, patch="16,16,16"):
    """hebbax's pretrain_unsup_3d trainer of ``kind``, the 3D networks at
    4 initial features."""
    def small(name, in_ch, n_cls, **kw):
        if name in NETS:
            return NETS[name][0](in_channels=in_ch, n_cls=n_cls,
                                 init_features=FEATURES)
        return jddpm.DDPMUNet(in_channels=in_ch, n_cls=n_cls)
    monkeypatch.setattr(j_cli3d, "get_network", small)
    args = j_cli3d.add_args(j_common3d.base_parser_3d(), kind).parse_args(
        _argv(synth, root, patch))
    return j_cli3d.build(args, kind)


def _port_trainer(synth, root, kind, patch="16,16,16", extra=()):
    args = unsup3d.add_args(common3d.base_parser_3d(), kind).parse_args(
        ["--device", "cpu"] + _argv(synth, root, patch) + list(extra))
    return unsup3d.build(args, kind)


def test_superpix_prep_gives_hebbax_masks(monkeypatch, synth, tmp_path):
    """The same host patch batch through each package's prep: equal
    26-neighbourhood masks, from the 3D seed [seed, crc32 of the first
    volume's 2x2x2 corner] (the 2D prep's 4x4 corner gives others)."""
    jt = _hebbax_trainer(monkeypatch, synth, tmp_path / "j", "superpix")
    tt = _port_trainer(synth, tmp_path / "t", "superpix")
    n = 0
    for batch in tt.loaders["train"]:
        ref = np.asarray(jt.prep(batch)["mask_superpix"])
        got = tt.prep(batch)["mask_superpix"].numpy()
        np.testing.assert_array_equal(got, ref)
        assert got.shape == batch["image"].shape and got.any()
        n += 1
    assert n == 2
    from hebbax_torch.cli.pretrain_unsup_2d import superpix_masks
    other = superpix_masks(batch["image"][..., None], 0)
    assert not np.array_equal(other, ref)


def test_superdiff_central_slice_step_matches(no_dropout, monkeypatch, synth,
                                             tmp_path):
    """hebbax's and the port's prep take the same central z-slice (z =
    Z // 2 of the last spatial axis) of a host patch batch; the 2D
    superdiff step on it (unet_ddpm, 1 input channel, 8 timesteps) gives
    hebbax's losses with hebbax's draws.  32^3 patches: at 16^2 the
    DDPM's bottleneck is 1x1, and train-mode BN over its 2 values turns
    float32 rounding into 1e-3 differences."""
    p32 = "32,32,32"
    jt = _hebbax_trainer(monkeypatch, synth, tmp_path / "j", "superdiff",
                         p32)
    tt = _port_trainer(synth, tmp_path / "t", "superdiff", p32)
    batch = next(iter(tt.loaders["train"]))
    jb, tb = jt.prep(batch), tt.prep(batch)
    assert tb["image"].shape == (2, 1, 32, 32)
    np.testing.assert_array_equal(to_nhwc(tb["image"]),
                                  np.asarray(jb["image"]))
    np.testing.assert_array_equal(tb["mask"].numpy(),
                                  np.asarray(jb["mask"]))
    np.testing.assert_array_equal(tb["image"][:, 0].numpy(),
                                  batch["image"][..., 16])

    jm = jddpm.DDPMUNet(in_channels=1, n_cls=2)
    v = jax.tree_util.tree_map(np.asarray, ddpm_variables(
        jm, jax.random.PRNGKey(7), in_ch=1, shape=(2, 32, 32)))
    tm = get_network("unet_ddpm", 1, 2)
    tm.load_state_dict(bridge.from_flax(v["params"], v["batch_stats"]))
    for m in tm.modules():
        if isinstance(m, Dropout):
            m.p = 0.0                       # dropout off: the streams differ
    tx = j_opt("sgd", LR)
    js = JState(params=v["params"], batch_stats=v["batch_stats"],
                opt_state=tx.init(v["params"]), step=0)
    key = jax.random.PRNGKey(8)
    _, jout = j_cli2d.make_superdiff_step(jm, jlosses.dice_loss, tx, 2, T)(
        js, jb, key)
    k1, k2, _ = jax.random.split(key, 3)
    t_seg, noise_seg = _forward_draws(k1, 2, (2, 32, 32, 2))
    t_img, noise_img = _forward_draws(k2, 2, (2, 32, 32, 1))
    opt, sched = t_opt("sgd", tm.parameters(), LR)
    _, out = make_superdiff_step(tm, dice_loss, 2, T)(
        TrainState(model=tm, optimizer=opt, schedule=sched), tb,
        draws={"t_seg": t_seg, "noise_seg": noise_seg, "t_img": t_img,
               "noise_img": noise_img})
    for k in ("loss", "loss_unsup", "loss_superdiff"):
        np.testing.assert_allclose(float(out[k]), float(jout[k]),
                                   rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(to_nhwc(out["logits"]),
                               np.asarray(jout["logits"]), rtol=1e-4,
                               atol=1e-4)


def test_parser_matches_hebbax():
    for kind in unsup3d.KINDS:
        ours = unsup3d.add_args(common3d.base_parser_3d(), kind).parse_args(
            ["--device", "cpu"])
        ref = j_cli3d.add_args(j_common3d.base_parser_3d(),
                               kind).parse_args([])
        assert ours.network == ref.network == unsup3d.NETWORK_DEFAULT[kind]
        assert (ours.optimizer, ours.regime) == (ref.optimizer, ref.regime)
        assert (getattr(ours, "timestamp_diffusion", None)
                == getattr(ref, "timestamp_diffusion", None))
    assert unsup3d.HEADS_3D == j_cli3d.HEADS_3D
    assert unsup3d.NETWORK_DEFAULT == j_cli3d.NETWORK_DEFAULT


# -- the CLI chain at 32^3 ---------------------------------------------------

CHAIN_FEATURES = 8


def narrow_registry(mp):
    """The sweep's names ``unet3d_vae``, ``unet3d_superpix`` and
    ``unet3d_s2d`` at 8 initial features for the CLI chain: at their 64 a
    snapshot takes 360 MB of disk."""
    from hebbax_torch.models import registry
    for name, cls in (("unet3d_vae", UNet3DVAE),
                      ("unet3d_superpix", UNet3DSuperpix),
                      ("unet3d_s2d", UNet3DS2D)):
        meta = registry._REGISTRY[name][1]
        mp.setitem(registry._REGISTRY, name, (
            lambda _c=cls, **kw: _c(init_features=CHAIN_FEATURES, **kw),
            meta))


@pytest.fixture(scope="module")
def runs(synth, tmp_path_factory):
    """{kind: the port's pretraining trainer}, each run once at 32^3."""
    root = tmp_path_factory.mktemp("unsup3d_runs")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        narrow_registry(mp)
        for kind in unsup3d.KINDS:
            extra = (["--timestamp_diffusion", "8"] if kind == "superdiff"
                     else [])
            trainer = _port_trainer(synth, root, kind, "32,32,32", extra)
            trainer.run()
            rel = os.path.relpath(trainer.paths.run, root)
            assert rel == os.path.join("Atrial", f"{kind}_unsup",
                                       unsup3d.NETWORK_DEFAULT[kind],
                                       "inv_temp-1", "regime-100", "run-0")
            out[kind] = trainer
    return root, out


@pytest.mark.parametrize("kind", unsup3d.KINDS)
def test_pretrain_cli_writes_losses_and_snapshot(runs, kind):
    _, trainers = runs
    t = trainers[kind]
    rows = t.train_log.rows
    cols = ["loss", "loss_unsup"] + (["loss_superdiff"]
                                     if kind == "superdiff" else [])
    assert len(rows) == 1 and all(np.isfinite(rows[0][c]) for c in cols)
    assert os.path.exists(os.path.join(t.paths.checkpoints, "last.ckpt"))


@pytest.mark.parametrize("kind", ["vae", "superpix"])
def test_port_snapshot_is_hebbax_tree(runs, kind):
    _, trainers = runs
    variables, _ = jckpt.load_snapshot(os.path.join(
        trainers[kind].paths.checkpoints, "last.ckpt"))
    jm = NETS[KIND[kind]][0](in_channels=1, n_cls=2,
                             init_features=CHAIN_FEATURES)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 16, 1)), train=False))
    flat_v = traverse_util.flatten_dict(variables)
    flat_s = traverse_util.flatten_dict(shapes)
    assert set(flat_v) == set(flat_s)
    for p in flat_s:
        assert flat_v[p].shape == flat_s[p].shape, p


@pytest.mark.parametrize("kind", ["vae", "superpix"])
def test_hebbax_snapshot_loads_into_port_and_back(kind, tmp_path):
    jm, v, tm, _ = pair_3d(KIND[kind], seed=9)
    p1 = jckpt.save_snapshot(v, str(tmp_path / "a"), threshold=0.5)
    sd, _ = tckpt.load_state_dict(p1, transposed_paths(tm))
    tm.load_state_dict(sd)
    p2 = tckpt.save_snapshot(sd, str(tmp_path / "b"), threshold=0.5,
                             transposed=transposed_paths(tm))
    with open(p1, "rb") as f1, open(p2, "rb") as f2:
        assert f1.read() == f2.read()


def test_baseline_tree_into_unet3d_ignores_extras():
    """hebbax's 3D hand-off puts the whole loaded tree in place, extras
    and all; the port's ``load_variables_into`` takes the same tree into
    UNet3D (head ``conv`` included, as the 3D hand-off loads every
    parameter) and ignores ``mu`` / ``var`` / ``reconstr`` /
    ``out_superpix``: the eval logits are hebbax's UNet3D on the tree."""
    for name in NETS:
        _, v, _, x = pair_3d(name, seed=11)
        jm = j3d.UNet3D(in_channels=1, n_cls=2, init_features=FEATURES)
        ref = jm.apply(v, jnp.asarray(x), train=False)
        tm = UNet3D(1, 2, init_features=FEATURES)
        common3d.load_variables_into(tm, v)
        with torch.no_grad():
            got = tm.eval()(_tx(x))
        outputs_close([got], [ref])


def _em(synth, root, snap):
    args = train_semi_3d.add_args(common3d.base_parser_3d(), "em")\
        .parse_args(["--device", "cpu"] + _argv(synth, root, b="1") + [
            "--regime", "50", "-u", "5", "--optimizer", "sgd",
            "--load_weights", snap, "--validate_iter", "1"])
    return train_semi_3d.build(args, "em")


def _test_3d(synth, run, net="unet3d_s2d"):
    return ttest.main(["--device", "cpu", "--path_dataset", synth,
                       "--path_exp", run, "-n", net, "--patch_size",
                       "32,32,32", "--patch_overlap", "16,16,16", "-b", "2",
                       "--postprocessing", "True"])


@pytest.mark.parametrize("kind", ["vae", "superpix"])
def test_em_from_port_baseline_then_test_3d(synth, runs, tmp_path,
                                            monkeypatch, kind):
    """``reproduce_{vae,superpix}_semi_supervised_3d.sh``: EM on
    ``unet3d_s2d`` with ``--load_weights`` the baseline's last.ckpt (every
    entry the network has loads, the head ``conv`` too; the extras are
    dropped), then ``test_3d --postprocessing True``."""
    narrow_registry(monkeypatch)
    _, trainers = runs
    snap = os.path.join(trainers[kind].paths.checkpoints, "last.ckpt")
    trainer = _em(synth, tmp_path, snap)
    rel = os.path.relpath(trainer.paths.run, tmp_path)
    assert rel.startswith(os.path.join("Atrial", "semi_sup"))
    loaded, _ = tckpt.load_state_dict(snap, transposed_paths(
        trainers[kind].state.model))
    model = trainer.state.model
    for n, t in model.state_dict().items():
        assert torch.equal(t, loaded[n]), n
    trainer.run()
    assert all(np.isfinite(r["loss"]) for r in trainer.train_log.rows)
    res = _test_3d(synth, trainer.paths.run)
    assert 0.0 <= res["dice"] <= 1.0 and 0.0 <= res["jaccard"] <= 1.0


def test_hebbax_em_snapshot_with_extras_into_port_test_3d(synth, tmp_path,
                                                         monkeypatch):
    """hebbax's EM snapshot from a VAE baseline keeps ``mu`` / ``var`` /
    ``reconstr`` (its hand-off puts the whole tree in place): the port's
    ``test_3d -n unet3d_s2d`` takes it."""
    narrow_registry(monkeypatch)
    jm = j3d.UNet3DVAE(in_channels=1, n_cls=2, init_features=CHAIN_FEATURES)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 16, 1)), train=False))
    rng = np.random.default_rng(12)
    v = jax.tree_util.tree_map(
        lambda s: (0.05 * rng.standard_normal(s.shape)).astype(s.dtype),
        shapes)
    v["batch_stats"] = jax.tree_util.tree_map(
        np.abs, v["batch_stats"])                 # variances are positive
    run = tmp_path / "em_run"
    jckpt.save_snapshot(v, str(run / "checkpoints"), threshold=0.5,
                        save_best=True)
    assert {"mu", "var", "reconstr"} <= set(v["params"])
    res = _test_3d(synth, str(run))
    assert 0.0 <= res["dice"] <= 1.0 and 0.0 <= res["jaccard"] <= 1.0
    assert os.listdir(run / "test_seg_preds_postprocessed")
