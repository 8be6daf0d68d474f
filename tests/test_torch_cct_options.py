"""The CCT networks' two options in the port: the ``*_batched`` decode
(the clean and 3 perturbed decoder passes as one of 4N) held against
hebbax's ``batched_aux=True`` folded classes, and the ``*_rc``
recompute (``remat_policy="convs"``: the shared decoder recomputed in the
backward with its conv outputs saved) held against the port's plain
classes, with the three guards of a recomputed forward.

Batched: hebbax's ``UNetCCT2DS2D`` / ``UNet3DCCTS2D`` / ``VNetCCTS2D``
with ``batched_aux=True`` (``remat_policy="convs"`` for the ``_rc``
names) and the port's registry names, on the same weights (carried by
``hebbax_torch.bridge``) and hebbax's perturbation draws (replayed by
test_torch_deep4.py's ``DrawRecorder``), dropout off in both.  Eval
outputs and training outputs, batch statistics (one momentum update over
the 4N batch) and Hebbian deltas (one per decoder site, over 4N) at the
tolerances and input sizes of test_torch_deep4.py (2D, 2x32x32) and
test_torch_3d_semi_nets.py / test_torch_vnet.py (2x32^3: a 2^3
bottleneck; at 16^3 train-mode BN over one voxel per sample amplifies
XLA-vs-oneDNN rounding past those gates; VNet without Hebbian sites).

Recompute: in float64 at 16^3 (``UNet3DCCT`` at 4 initial features,
``VNetCCT`` at its full width) the grads, the BN running statistics and
the Hebbian deltas of a training forward and backward equal the plain
class's to the bit, and every decoder pass was recomputed once.  Under 2
gloo ranks the step makes as many all-reduces as the plain one: the
recomputed batch norms replay their global statistics.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hebbax.models.common as jcommon
import hebbax.models.unet2d as junet
import hebbax.models.unet2d_s2d as j2s2d
import hebbax.models.unet3d_s2d as j3s2d
import hebbax.models.vnet as jvnet
import hebbax.models.vnet_s2d as jvs2d
from hebbax.hebb.spec import HebbSpec as JSpec
from hebbax.models.registry import network_meta as j_meta
from hebbax_torch import parallel
from hebbax_torch.hebb.layers import HConv
from hebbax_torch.hebb.spec import HebbSpec
from hebbax_torch.hebb.surgery import pop_deltas
from hebbax_torch.models import common, get_network, network_meta
from hebbax_torch.models.common import (BatchNorm3d, Dropout3d,
                                        checkpointed, remat_policy)
from hebbax_torch.models.unet3d import UNet3DCCT
from hebbax_torch.models.vnet import VNetCCT
from hebbax_torch.models.unet2d_s2d import UNetCCT2DS2D
from hebbax_torch.models.unet3d_s2d import UNet3DCCTS2D
from hebbax_torch.models.vnet_s2d import VNetCCTS2D
from hebbax_torch.ops.dropout import Dropout
from hebbax_torch.utils import remat

import torch_remat_cases as cases
from test_torch_3d_model import to_j, to_t
from test_torch_3d_semi_nets import (_LinenNoDropout, deltas_close,
                                     make_net_pair_3d, outputs_close,
                                     stats_close)
from test_torch_deep4 import DrawRecorder, _deltas_close, make_net_pair
from test_torch_unet2d import _NoDropout, _stats_close, to_nchw, to_nhwc
from test_torch_vnet import make_vnet_pair

torch.set_num_threads(2)

BATCHED = ("unet_cct_s2d_batched", "unet3d_cct_s2d_batched",
           "unet3d_cct_s2d_batched_rc", "vnet_cct_s2d_batched",
           "vnet_cct_s2d_batched_rc")
SPEC = dict(mode="swta_t", k=50.0, w_nrm=True, alpha=1.0)


@pytest.fixture
def no_dropout(monkeypatch):
    """hebbax's dropouts as the identity (the port's p is set to 0 by the
    pair helpers): the streams differ by design."""
    for mod in (j2s2d, junet):
        monkeypatch.setattr(mod, "FastDropout", _NoDropout)
    for mod in (jvnet, jvs2d):
        monkeypatch.setattr(mod, "nn", _LinenNoDropout())


def _options(name):
    return dict(batched_aux="_batched" in name,
                remat_policy="convs" if name.endswith("_rc") else None)


@pytest.mark.parametrize("name", BATCHED)
def test_batched_names_take_their_options(name):
    assert network_meta(name) == j_meta(name)
    assert network_meta(name)["outputs"] == "deep4"
    m = get_network(name, 1, 2, device="meta")
    opts = _options(name)
    assert m.batched_aux
    # the folded classes, hebbax's (models/*_s2d.py)
    assert type(m) in (UNetCCT2DS2D, UNet3DCCTS2D, VNetCCTS2D)
    if isinstance(m, (UNet3DCCTS2D, VNetCCTS2D)):
        assert m.remat == name.endswith("_rc")
        assert m.remat_policy == opts["remat_policy"]


def _pair(name, seed):
    """(hebbax batched model, its variables, the port's model of ``name``
    carrying them, NHWC / NDHWC input, hebbax's module calling
    ``perturb_features``, the port's layout converters, Hebbian sites)."""
    opts = _options(name)
    if name.startswith("unet_"):
        _, variables, tm, x = make_net_pair("unet_cct", hebb=True,
                                            seed=seed)
        jm = j2s2d.UNetCCT2DS2D(
            in_channels=3, n_cls=2, batched_aux=True,
            hebb=JSpec(**SPEC, exclude=("out_conv",)))
        return jm, variables, tm, x, j2s2d, (to_nchw, to_nhwc), 22
    if name.startswith("unet3d"):
        _, variables, tm, x = make_net_pair_3d("unet3d_cct", hebb=True,
                                               seed=seed)
        jm = j3s2d.UNet3DCCTS2D(
            in_channels=1, n_cls=2, init_features=4,
            hebb=JSpec(**SPEC, exclude=("conv",)), **opts)
        tm.remat, tm.remat_policy = name.endswith("_rc"), \
            opts["remat_policy"]
        return jm, variables, tm, x, jcommon, (to_t, to_j), 22
    _, variables, tm, x = make_vnet_pair("vnet_cct", seed=seed)
    jm = jvs2d.VNetCCTS2D(in_channels=1, n_cls=2, **opts)
    tb = get_network(name, 1, 2, device="cpu")
    tb.load_state_dict(tm.state_dict())
    for m in tb.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return jm, variables, tb, x, jcommon, (to_t, to_j), 0


@pytest.mark.parametrize("name", BATCHED)
def test_batched_matches_hebbax(name, no_dropout, monkeypatch):
    jm, variables, tm, x, perturb_mod, (to_port, to_hebbax), sites = \
        _pair(name, seed=BATCHED.index(name))
    tm.batched_aux = True
    apply = jax.jit(functools.partial(jm.apply, train=False))
    ref = apply(variables, jnp.asarray(x))
    tm.eval()
    with torch.no_grad():
        got = tm(to_port(x))
    if sites == 22 and name.startswith("unet_"):
        np.testing.assert_allclose(to_hebbax(got[0]), np.asarray(ref[0]),
                                   rtol=1e-4, atol=1e-5)
    else:
        outputs_close(got[:1], ref[:1])

    rec = DrawRecorder(monkeypatch, module=perturb_mod)
    train = jax.jit(functools.partial(jm.apply, train=True,
                                      mutable=["batch_stats", "hebb"]))
    ref, mut = train(variables, jnp.asarray(x),
                     rngs={"perturb": jax.random.PRNGKey(6),
                           "dropout": jax.random.PRNGKey(5)})
    jax.effects_barrier()
    assert [k for k, _ in rec.records] == list(common.CCT_PERTURB_KINDS)
    rec.install(tm)
    tm.train()
    with torch.no_grad():
        got = tm(to_port(x))
    assert rec.records == []
    assert len(got) == 4 and got[0].shape == got[1].shape
    assert not np.allclose(to_hebbax(got[0]), to_hebbax(got[1]))
    if name.startswith("unet_"):
        for g, r in zip(got, ref):
            np.testing.assert_allclose(to_hebbax(g), np.asarray(r),
                                       rtol=1e-4, atol=1e-4)
        _stats_close(mut["batch_stats"], tm)
        _deltas_close(mut, tm, sites)
    else:
        outputs_close(got, ref)
        stats_close(mut["batch_stats"], tm)
        if sites:
            deltas_close(mut, tm, sites)


def test_batched_decode_runs_the_decoder_once(monkeypatch):
    """The 2D batched forward decodes one 4N batch: 12 decoder sites see
    batch 8 once (22 SWTA deltas per forward, not 58)."""
    from hebbax_torch.hebb import kernels
    calls = []
    orig = kernels.swta_delta

    def counted(w, x, *a, **k):
        calls.append(x.shape[0])
        return orig(w, x, *a, **k)
    monkeypatch.setattr(kernels, "swta_delta", counted)
    spec = HebbSpec(**SPEC, exclude=("out_conv",))
    tm = get_network("unet_cct_s2d_batched", 3, 2, hebb=spec,
                     generator=torch.Generator().manual_seed(0),
                     perturb_generator=torch.Generator().manual_seed(1))
    tm.train()
    with torch.no_grad():
        tm(torch.randn(2, 3, 32, 32))
    assert sorted(calls) == [2] * 10 + [8] * 12


# -- the recompute ------------------------------------------------------------

def test_remat_policy_names():
    assert remat_policy(None) is None
    assert callable(remat_policy("convs"))
    with pytest.raises(ValueError, match="unknown remat policy"):
        remat_policy("dots")


def _step(model, x):
    """Training forward and backward: grads, running statistics and the
    Hebbian deltas."""
    model.train()
    outs = model(x)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o ** 2).mean() for o in outs)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return grads, stats, pop_deltas(model)


def _equal_steps(a, b):
    for ga, gb in zip(a[0], b[0]):
        assert torch.equal(ga, gb)
    assert a[1].keys() == b[1].keys()
    for k in a[1]:
        assert torch.equal(a[1][k], b[1][k]), k
    assert a[2].keys() == b[2].keys()
    for k in a[2]:
        assert torch.equal(a[2][k], b[2][k]), k


def _count_recomputations(monkeypatch):
    runs = []
    orig = remat.Tape.run

    def run(self):
        runs.append(self.runs)
        return orig(self)
    monkeypatch.setattr(remat.Tape, "run", run)
    return runs


@pytest.mark.parametrize("name,policy", [
    ("unet3d_cct_s2d_rc", "convs"), ("unet3d_cct_s2d_batched_rc", "convs"),
    ("unet3d_cct_s2d_rc", None), ("vnet_cct_s2d_rc", "convs"),
    ("vnet_cct_s2d_batched_rc", "convs")])
def test_rc_step_equals_the_plain_class(name, policy, monkeypatch):
    """Grads, BN statistics and Hebbian deltas (recorded once per pass)
    equal the plain class's to the bit; every decoder pass ran twice.
    VNet's skip dropout is on: the recomputation replays its masks."""
    runs = _count_recomputations(monkeypatch)
    spec = HebbSpec(**SPEC, exclude=("conv", "out_tr.conv2"))
    opts = dict(batched_aux="_batched" in name)
    steps = []
    for rc in (False, True):
        gens = dict(generator=torch.Generator().manual_seed(1),
                    perturb_generator=torch.Generator().manual_seed(2))
        if name.startswith("unet3d"):
            m = UNet3DCCT(1, 2, init_features=4, hebb=spec, remat=rc,
                          remat_policy=policy, **opts, **gens)
        else:
            m = VNetCCT(1, 2, hebb=spec, remat=rc, remat_policy=policy,
                        dropout_generator=torch.Generator().manual_seed(3),
                        **opts, **gens)
        x = torch.randn((1, 1, 16, 16, 16), dtype=torch.float64,
                        generator=torch.Generator().manual_seed(0))
        steps.append(_step(m.double(), x))
    _equal_steps(*steps)
    passes = 1 if opts["batched_aux"] else 4
    assert sorted(runs) == [0] * passes + [1] * passes
    assert len(steps[1][2]) == (22 if name.startswith("unet3d") else 25)


def test_recomputed_batch_norm_moves_once():
    """A checkpointed batch norm: the running statistics take one
    momentum update, and the grads are the plain ones."""
    x = torch.randn((3, 4, 5, 5, 5), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    out = []
    for rc in (False, True):
        bn = BatchNorm3d(4).double()
        xi = x.clone().requires_grad_(True)
        f = checkpointed(bn, "convs") if rc else bn
        y = f(xi)
        g = torch.autograd.grad((y ** 3).sum(), [xi, bn.weight])
        out.append((g, bn.running_mean.clone(), bn.running_var.clone()))
    for a, b in zip(out[0][0], out[1][0]):
        assert torch.equal(a, b)
    mean = x.mean(dim=(0, 2, 3, 4))
    torch.testing.assert_close(out[1][1], 0.1 * mean, rtol=1e-12, atol=0)
    assert torch.equal(out[0][1], out[1][1])
    assert torch.equal(out[0][2], out[1][2])


@pytest.mark.parametrize("mode", ["swta", "hpca", "contrastive"])
def test_recomputed_hconv_records_one_delta(mode):
    """A checkpointed Hebbian conv adds its delta once (hebbax sums sown
    deltas: a second one would double it); contrastive draws its
    permutation once."""
    spec = HebbSpec(mode=mode, k=20.0, w_nrm=True, alpha=1.0)
    x = torch.randn((2, 3, 6, 6, 6), generator=torch.Generator().manual_seed(0))
    out = []
    for rc in (False, True):
        conv = HConv(3, 4, (3, 3, 3), padding=1,
                     generator=torch.Generator().manual_seed(1))
        conv.spec = spec
        conv.hebb_generator = torch.Generator().manual_seed(2)
        conv.train()
        xi = x.clone().requires_grad_(True)
        y = (checkpointed(conv, "convs") if rc else conv)(xi)
        g = torch.autograd.grad(torch.tanh(y).sum(), [xi, conv.weight])
        out.append((g, conv.delta, conv.hebb_generator.get_state()))
    for a, b in zip(out[0][0], out[1][0]):
        assert torch.equal(a, b)
    assert torch.equal(out[0][1], out[1][1])
    assert torch.equal(out[0][2], out[1][2])


def test_recomputed_dropout_replays_its_mask():
    x = torch.randn((4, 6, 3, 3, 3), generator=torch.Generator().manual_seed(0))
    out = []
    for rc in (False, True):
        for drop in (Dropout3d(0.5, torch.Generator().manual_seed(5)),
                     Dropout(0.3, torch.Generator().manual_seed(6))):
            drop.train()
            xi = x.clone().requires_grad_(True)
            y = (checkpointed(lambda t: drop(t) * t) if rc else
                 (lambda t: drop(t) * t))(xi)
            g, = torch.autograd.grad(y.sum(), [xi])
            out.append((y.detach(), g, drop.generator.get_state()))
    for a, b in zip(out[:2], out[2:]):
        for u, v in zip(a, b):
            assert torch.equal(u, v)


def test_recomputed_forward_makes_no_collective():
    """2 gloo ranks, each on its row of a float64 batch of 2: the
    recomputed step makes the plain step's all-reduces (the batch norms'
    global sums replay; their backward all-reduces run as before) and
    gives its grads, statistics and deltas to the bit."""
    for plain, rc in parallel.run_ranks(cases.rc_pair, 2, (), timeout=60,
                                        deadline=600, threads=1):
        assert plain["recomputed"] == 0 and rc["recomputed"] == 4
        assert rc["all_reduce"] == plain["all_reduce"] > 0
        for key in ("grads", "stats", "deltas"):
            assert plain[key].keys() == rc[key].keys()
            for k in plain[key]:
                np.testing.assert_array_equal(rc[key][k], plain[key][k],
                                              err_msg=k)


def test_replay_outside_a_region_is_a_no_op():
    t = torch.ones(3, requires_grad=True)
    assert remat.current() is None and not remat.replaying()
    assert remat.pin(t) is t
    assert remat.stash(lambda: 7) == 7
    tape = remat.Tape()
    with tape.run():
        assert remat.stash(lambda: 1) == 1
    with tape.run():
        assert remat.replaying() and remat.stash(lambda: 2) == 1
        with pytest.raises(RuntimeError, match="more kept values"):
            tape.next()
