"""The port's deep-supervision networks, ``unet_urpc`` (UNetURPC2D) and
``unet_cct`` (UNetCCT2D), held against hebbax's on carried weights, and
a few Hebbian pretraining steps of each.

hebbax's variables go through ``hebbax_torch.bridge.from_flax`` into the
port's model; both run the same numpy-seeded 2x32x32 input with dropout
off (see test_torch_unet2d.py).  CCT's perturbation draws are hebbax's:
:class:`DrawRecorder` wraps hebbax's ``perturb_features`` to record the
``jax.random`` draws it takes (an ordered ``jax.debug.callback``, so it
works inside hebbax's jitted steps) and replays them, in order, into the
port's ``draw_perturbations``.

Tolerances, as test_torch_unet2d.py / test_torch_steps.py state them:
eval logits rtol 1e-4 / atol 1e-5; training logits atol 1e-4 (train-mode
BN over the 2x2 bottleneck amplifies conv rounding); BN statistics rtol
1e-4 / atol 1e-5; Hebbian deltas 1e-3 of each site's largest delta;
pretraining losses rtol 1e-4 and parameters rtol 1e-4 / atol 1e-5 with
the Adam allowance of test_torch_steps.py (at most 1% of a tensor's
elements off, by no more than the steps' full travel).
"""

import argparse

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

import hebbax.models.unet2d as junet
from hebbax.config.schedules import make_optimizer as j_make_optimizer
from hebbax.config.schedules import warmup_step_schedule
from hebbax.engine.state import TrainState as JState
from hebbax.engine.steps import make_sup_train_step as j_make_step
from hebbax.hebb.spec import HebbSpec as JSpec
from hebbax.hebb.surgery import pretrain_trainable_mask
from hebbax.ops.losses import dice_loss as j_dice
from hebbax_torch.bridge import from_flax
from hebbax_torch.config.schedules import WarmupStepLR, make_optimizer
from hebbax_torch.engine.state import TrainState
from hebbax_torch.engine.steps import make_sup_train_step
from hebbax_torch.hebb import kernels
from hebbax_torch.hebb.spec import HebbSpec
from hebbax_torch.hebb.surgery import pop_deltas, pretrain_trainable_names
from hebbax_torch.models import get_network, network_meta
from hebbax_torch.models.common import CCT_PERTURB_KINDS
from hebbax_torch.models.unet2d import UNet2D, UNetCCT2D, UNetURPC2D
from hebbax_torch.models.unet2d_s2d import UNetCCT2DS2D, UNetURPC2DS2D
from hebbax_torch.ops.dropout import Dropout
from hebbax_torch.ops.losses import dice_loss

from test_torch_semi_ops import jax_draw, port_draw
from test_torch_steps import _compare
from test_torch_unet2d import _stats_close, no_dropout, to_nchw  # noqa: F401
from test_torch_unet2d import to_nhwc

torch.set_num_threads(2)

EXCLUDE = {"unet": ("out_conv",),
           "unet_urpc": ("out_conv_dp1", "out_conv_dp2", "out_conv_dp3",
                         "out_conv"),
           "unet_cct": ("out_conv",)}
CLASSES = {"unet": (junet.UNet2D, UNet2D),
           "unet_urpc": (junet.UNetURPC2D, UNetURPC2D),
           "unet_cct": (junet.UNetCCT2D, UNetCCT2D)}


class DrawRecorder:
    """Records the draws of hebbax's CCT perturbations (when given a
    monkeypatch; ``module`` is the hebbax model module whose
    ``perturb_features`` to wrap) and replays them into a port model, one
    perturbation kind at a time, in order."""

    def __init__(self, monkeypatch=None, records=(), module=junet):
        self.records = list(records)
        if monkeypatch is None:
            return
        orig = module.perturb_features

        def recording(key, feats, kind):
            keys = jax.random.split(key, len(feats))
            draws = [jax_draw(kind, k, f) for k, f in zip(keys, feats)]
            jax.debug.callback(
                lambda *d: self.records.append(
                    (kind, [port_draw(kind, x) for x in d])),
                *draws, ordered=True)
            return orig(key, feats, kind)

        monkeypatch.setattr(module, "perturb_features", recording)

    def install(self, tm):
        def draw_perturbations(feats):
            out = {}
            for kind in CCT_PERTURB_KINDS:
                got_kind, draws = self.records.pop(0)
                assert got_kind == kind
                out[kind] = draws
            return out
        tm.draw_perturbations = draw_perturbations


def make_net_pair(name, hebb=False, seed=0, alpha=1.0):
    """(hebbax model, its numpy variables, port model carrying them, numpy
    NHWC input); ``hebb``: swta_t K=50 with the network's heads excluded
    and ``alpha`` (1 pretraining, 0 the fine-tune spec)."""
    jcls, tcls = CLASSES[name]
    jspec = tspec = None
    if hebb:
        kw = dict(mode="swta_t", k=50.0, w_nrm=True, alpha=alpha,
                  exclude=EXCLUDE[name])
        jspec, tspec = JSpec(**kw), HebbSpec(**kw)
    jm = jcls(in_channels=3, n_cls=2, hebb=jspec)
    x = np.random.default_rng(seed).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                        train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    tm = tcls(3, 2, hebb=tspec, device="cpu")
    tm.load_state_dict(from_flax(variables["params"],
                                 variables["batch_stats"]))
    for m in tm.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return jm, variables, tm, x


def _deltas_close(mut, tm, n_sites):
    got = pop_deltas(tm)
    ref = {".".join(p[:-1]) + ".weight": np.transpose(np.asarray(v),
                                                      (3, 2, 0, 1))
           for p, v in traverse_util.flatten_dict(mut["hebb"]).items()}
    assert len(got) == len(ref) == n_sites
    assert set(got) == set(ref)
    for name, d in got.items():
        scale = float(np.abs(ref[name]).max())
        np.testing.assert_allclose(d.numpy(), ref[name], rtol=0,
                                   atol=1e-3 * scale, err_msg=name)


@pytest.fixture
def count_deltas(monkeypatch):
    """Counts the SWTA delta computations (the kernel's launches on the
    card) through the dispatcher."""
    calls = []
    orig = kernels.swta_delta

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(kernels, "swta_delta", counted)
    return calls


# -- registry and parameter trees --------------------------------------------

@pytest.mark.parametrize("name,base,cls", [
    ("unet_urpc", "unet_urpc", UNetURPC2D),
    ("unet_urpc_s2d", "unet_urpc", UNetURPC2DS2D),
    ("unet_cct", "unet_cct", UNetCCT2D),
    ("unet_cct_s2d", "unet_cct", UNetCCT2DS2D)])
def test_registry_entries(name, base, cls):
    """The ``_s2d`` names build hebbax's folded classes
    (``models/unet2d_s2d.py``) with the unfolded name's metadata and
    parameters."""
    from hebbax.models.registry import network_meta as j_meta
    assert network_meta(name) == j_meta(name) == j_meta(base)
    g = torch.Generator().manual_seed(0)
    m = get_network(name, 3, 2, generator=g)
    assert type(m) is cls
    base_m = get_network(base, 3, 2,
                         generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(v, base_m.state_dict()[k])
               for k, v in m.state_dict().items())


def test_batched_cct_is_not_registered():
    """``unet_cct_s2d_batched`` is registered now (the name is kept):
    hebbax's deep4 metadata, the folded ``UNetCCT2DS2D`` with the batched
    decode."""
    from hebbax.models.registry import network_meta as j_meta
    name = "unet_cct_s2d_batched"
    assert network_meta(name) == j_meta(name)
    assert network_meta(name)["outputs"] == "deep4"
    m = get_network(name, 3, 2, generator=torch.Generator().manual_seed(0))
    assert type(m) is UNetCCT2DS2D and m.batched_aux


@pytest.mark.parametrize("name", ["unet_urpc", "unet_cct"])
def test_param_tree_maps_one_to_one(name):
    _, variables, tm, _ = make_net_pair(name)
    flat = (len(traverse_util.flatten_dict(variables["params"]))
            + len(traverse_util.flatten_dict(variables["batch_stats"])))
    assert flat == len(tm.state_dict())
    assert sum(np.asarray(v).size for v in jax.tree_util.tree_leaves(
        variables["params"])) == sum(p.numel() for p in tm.parameters())


# -- forwards --------------------------------------------------------------

@pytest.mark.parametrize("hebb", [False, True])
@pytest.mark.parametrize("name", ["unet_urpc", "unet_cct"])
def test_eval_forward_matches(no_dropout, name, hebb):
    jm, variables, tm, x = make_net_pair(name, hebb=hebb, seed=1)
    ref = jm.apply(variables, jnp.asarray(x), train=False)
    tm.eval()
    with torch.no_grad():
        got = tm(to_nchw(x))
    # URPC: all four heads; CCT: the primary output (eval reads no other)
    n = 4 if name == "unet_urpc" else 1
    for g, r in zip(got[:n], ref[:n]):
        np.testing.assert_allclose(to_nhwc(g), np.asarray(r), rtol=1e-4,
                                   atol=1e-5)


def test_urpc_train_forward_matches(no_dropout, count_deltas):
    jm, variables, tm, x = make_net_pair("unet_urpc", hebb=True, seed=2)
    ref, mut = jm.apply(variables, jnp.asarray(x), train=True,
                        mutable=["batch_stats", "hebb"],
                        rngs={"dropout": jax.random.PRNGKey(5)})
    tm.train()
    with torch.no_grad():
        got = tm(to_nchw(x))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(to_nhwc(g), np.asarray(r), rtol=1e-4,
                                   atol=1e-4)
    _stats_close(mut["batch_stats"], tm)
    assert len(count_deltas) == 22          # heads excluded
    _deltas_close(mut, tm, 22)


def test_cct_train_forward_matches_with_hebbax_draws(no_dropout,
                                                     monkeypatch,
                                                     count_deltas):
    rec = DrawRecorder(monkeypatch)
    jm, variables, tm, x = make_net_pair("unet_cct", hebb=True, seed=3)
    ref, mut = jm.apply(variables, jnp.asarray(x), train=True,
                        mutable=["batch_stats", "hebb"],
                        rngs={"dropout": jax.random.PRNGKey(5),
                              "perturb": jax.random.PRNGKey(6)})
    jax.effects_barrier()
    assert [k for k, _ in rec.records] == list(CCT_PERTURB_KINDS)
    rec.install(tm)
    tm.train()
    with torch.no_grad():
        got = tm(to_nchw(x))
    assert rec.records == []
    for g, r in zip(got, ref):                # main + 3 perturbed passes
        np.testing.assert_allclose(to_nhwc(g), np.asarray(r), rtol=1e-4,
                                   atol=1e-4)
    assert not np.allclose(to_nhwc(got[0]), to_nhwc(got[1]))
    # the shared decoder's BN statistics took four momentum updates
    _stats_close(mut["batch_stats"], tm)
    # 10 encoder sites + 12 decoder sites x 4 passes, summed per site
    assert len(count_deltas) == 58
    _deltas_close(mut, tm, 22)


def test_cct_eval_forward_runs_one_pass(count_deltas):
    _, _, tm, x = make_net_pair("unet_cct", hebb=True, seed=4)
    tm.eval()
    tm.draw_perturbations = None              # an eval forward draws none
    with torch.no_grad():
        out = tm(to_nchw(x))
    assert all(o is out[0] for o in out) and count_deltas == []


# -- Hebbian pretraining steps -----------------------------------------------

N_STEPS = 3


def _batches(seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((2, 32, 32, 3)).astype(np.float32),
             (rng.random((2, 32, 32)) < 0.4).astype(np.int32))
            for _ in range(N_STEPS)]


@pytest.mark.parametrize("name", ["unet_urpc", "unet_cct"])
def test_pretrain_steps_match(no_dropout, monkeypatch, count_deltas, name):
    rec = DrawRecorder(monkeypatch)
    jm, variables, tm, _ = make_net_pair(name, hebb=True, seed=5)
    batches = _batches(7)
    exclude = EXCLUDE[name]
    tx = j_make_optimizer("adam", warmup_step_schedule(
        1e-3, warmup=1, step_size=50, gamma=0.5, steps_per_epoch=1))
    jstep = j_make_step(jm, name, j_dice, tx, deep_supervision=True,
                        hebb_alpha=1.0,
                        trainable_mask=pretrain_trainable_mask(
                            variables["params"], exclude),
                        backprop_only=exclude)
    jstate = JState(params=variables["params"],
                    batch_stats=variables["batch_stats"],
                    opt_state=tx.init(variables["params"]), step=0)
    lj = []
    for i, (x, m) in enumerate(batches):
        jstate, out = jstep(jstate, {"image": jnp.asarray(x),
                                     "mask": jnp.asarray(m)},
                            jax.random.PRNGKey(i))
        lj.append(float(out["loss"]))
    jax.effects_barrier()
    if name == "unet_cct":
        assert len(rec.records) == 3 * N_STEPS
        rec.install(tm)

    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    names = set(pretrain_trainable_names(tm, exclude))
    opt = make_optimizer("adam", [p for n, p in tm.named_parameters()
                                  if n in names])
    state = TrainState(model=tm, optimizer=opt, schedule=WarmupStepLR(
        1e-3, warmup=1, step_size=50, gamma=0.5, steps_per_epoch=1))
    step = make_sup_train_step(tm, name, dice_loss, deep_supervision=True,
                               hebb_alpha=1.0, backprop_only=exclude)
    lt = []
    for x, m in batches:
        state, out = step(state, {"image": to_nchw(x),
                                  "mask": torch.from_numpy(m).long()})
        lt.append(float(out["loss"]))
    assert len(count_deltas) == (22 if name == "unet_urpc" else 58) * N_STEPS
    _compare(jstate, tm, lj, lt, adam=True)
    after = dict(tm.named_parameters())
    assert not torch.equal(after["up4.conv.conv1.weight"],
                           before["up4.conv.conv1.weight"])
    assert torch.equal(after["up4.conv.bn1.weight"],
                       before["up4.conv.bn1.weight"])
    assert not torch.equal(after["out_conv.bias"], before["out_conv.bias"])


# -- snapshot / network match -------------------------------------------------

def test_snapshot_loads_only_into_its_network(tmp_path):
    from hebbax_torch.cli import common
    from hebbax_torch.config.datasets import dataset_cfg
    from hebbax_torch.utils.checkpoint import save_snapshot

    spec = HebbSpec(exclude=("out_conv",))
    unet = get_network("unet", 3, 2, hebb=spec,
                       generator=torch.Generator().manual_seed(0))
    meta = {"hebb_params": spec.to_dict(), "layers_excluded": ["out_conv"]}
    path = save_snapshot(unet.state_dict(), str(tmp_path), **meta)
    cfg = dataset_cfg("GlaS")
    args = argparse.Namespace(seed=0, network="unet_urpc",
                              init_weights="kaiming")
    with pytest.raises(RuntimeError, match="state_dict"):
        common.build_model_2d(args, cfg, "cpu", load_hebbian=path)
    args.network = "unet"
    model, hebb = common.build_model_2d(args, cfg, "cpu", load_hebbian=path)
    assert hebb.alpha == 0.0
