"""One Hebbian pretraining step of the port under the rules and networks
this slice adds, held against hebbax's training forward on carried
weights and the same numpy-seeded batch:

* ``unet`` (2D, batch 3, 32x32) under hpca and under contrastive (each
  site's batch permutation hebbax's, recorded from its ``make_rng
  ("hebb")`` keys and injected), ``out_conv`` excluded;
* ``unet3d`` (8 initial features, so the last upconv has 64 outputs and
  the 32-channel Sanger chunk matters; batch 2, 32^3) under hpca_t:
  forward hpca on the 3x3x3 convs, chunked hpca_t on the transpose convs,
  ``conv`` excluded;
* ``vnet`` (full width, batch 1, 32^3: the 3D sweeps' batch) under
  swta_t, ``out_tr.conv2`` excluded: strided swta on the 4 down convs,
  swta_t on the 4 up convs.

The port's step is ``make_sup_train_step`` at alpha 1 with
``backprop_only`` over the head and SGD at a constant lr 1 without
momentum or decay, so each Hebbian kernel moves by exactly its delta;
hebbax's deltas are its mutable ``hebb`` collection.  The step's moves
are held against hebbax's deltas within 1e-3 of each site's max|delta|
(the 3D delta gate of tests/test_torch_3d_semi_nets.py: sums over up to
2*32^3 voxels, through train-mode batch norm, in other orders; measured
7.9e-6 hpca, 1.6e-5 contrastive, 1.8e-5 unet3d, 7.2e-5 vnet), the batch
statistics at rtol 1e-4 / atol 1e-5; the head
moved, the converted biases and BN affine did not.
"""

import numpy as np
import pytest
import torch
from flax import traverse_util

import jax
import jax.numpy as jnp

import hebbax.models.unet2d as junet
from hebbax.hebb import rules as jrules
from hebbax.hebb.spec import HebbSpec as JSpec
from hebbax.models.unet3d import UNet3D as JUNet3D
from hebbax.models.registry import get_network as j_get_network
from hebbax_torch import bridge
from hebbax_torch.config.schedules import make_optimizer
from hebbax_torch.engine.loop import to_device_batch_3d
from hebbax_torch.engine.state import TrainState
from hebbax_torch.engine.steps import make_sup_train_step
from hebbax_torch.hebb.layers import HConv, transposed_paths
from hebbax_torch.hebb.spec import HebbSpec
from hebbax_torch.hebb.surgery import pop_deltas, pretrain_trainable_names
from hebbax_torch.models import get_network
from hebbax_torch.models.unet2d import UNet2D, UNetCCT2D
from hebbax_torch.models.unet3d import UNet3D
from hebbax_torch.ops.dropout import Dropout
from hebbax_torch.ops.losses import dice_loss
from hebbax_torch.utils.seeding import make_generator

from test_torch_deep4 import DrawRecorder
from test_torch_unet2d import no_dropout  # noqa: F401
from test_torch_vnet import no_dropout as vnet_no_dropout  # noqa: F401

torch.set_num_threads(2)

TOL = 1e-3


class PermRecorder:
    """Records the batch permutation hebbax's contrastive rule draws at
    each site (through an ordered ``jax.debug.callback``, so under jit
    too), and replays them into a port model's HConvs in call order."""

    def __init__(self, monkeypatch):
        self.perms = []
        orig = jrules.contrastive_delta

        def recording(w, x, key, *a, **kw):
            jax.debug.callback(lambda p: self.perms.append(np.array(p)),
                               jax.random.permutation(key, x.shape[0]),
                               ordered=True)
            return orig(w, x, key, *a, **kw)

        monkeypatch.setattr(jrules, "contrastive_delta", recording)

    def install(self, tm):
        def replay(n):
            perm = torch.from_numpy(self.perms.pop(0))
            assert perm.shape == (n,)
            return perm
        for m in tm.modules():
            if isinstance(m, HConv):
                m.draw_permutation = replay


def _spec_pair(mode, exclude):
    kw = dict(mode=mode, k=50.0, w_nrm=True, alpha=1.0, exclude=exclude)
    return JSpec(**kw), HebbSpec(**kw)


def _carry(tm):
    """The port model's weights as hebbax variables (hebbax's own init
    runs op by op on the CPU for half a minute)."""
    params, stats = jax.tree_util.tree_map(np.array, bridge.to_flax(
        tm.state_dict(), transposed_paths(tm)))   # copies, not views
    return {"params": params, "batch_stats": stats}


def _hebbax_forward(jm, variables, x, rngs=None):
    """hebbax's training forward, jitted: (batch stats, {weight name:
    delta in hebbax's layout})."""
    fwd = jax.jit(lambda v, x_: jm.apply(v, x_, train=True,
                                         mutable=["batch_stats", "hebb"],
                                         rngs=rngs or {}))
    _, mut = fwd(variables, jnp.asarray(x))
    jax.effects_barrier()
    deltas = {}
    for path, v in traverse_util.flatten_dict(mut["hebb"]).items():
        deltas[".".join(path[:-1]) + ".weight"] = np.asarray(v)
    return mut["batch_stats"], deltas


def _port_step(tm, network, exclude, batch):
    """One pretraining step at alpha 1, SGD lr 1: returns the parameters
    before and after."""
    names = set(pretrain_trainable_names(tm, exclude))
    opt = make_optimizer("sgd", [p for n, p in tm.named_parameters()
                                 if n in names], momentum=0.0)
    step = make_sup_train_step(tm, network, dice_loss, hebb_alpha=1.0,
                               backprop_only=exclude)
    state = TrainState(model=tm, optimizer=opt, schedule=lambda count: 1.0)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    state, out = step(state, batch)
    assert np.isfinite(float(out["loss"]))
    return before, {n: p.detach().clone() for n, p in tm.named_parameters()}


def _check(tm, stats, deltas, before, after, n_sites, head, frozen):
    tp = transposed_paths(tm)
    assert len(deltas) == n_sites
    for name, ref in deltas.items():
        mod = name.rsplit(".", 1)[0]
        nd = ref.ndim - 2
        perm = ((nd, nd + 1) if mod in tp else (nd + 1, nd)) + tuple(
            range(nd))
        ref = np.transpose(ref, perm)
        moved = (after[name] - before[name]).numpy()
        scale = float(np.abs(ref).max())
        if scale == 0.0:
            # contrastive at a site whose permutation is the identity:
            # the two terms cancel exactly in both packages
            assert not moved.any(), name
            continue
        err = float(np.abs(moved - ref).max()) / scale
        assert err <= TOL, (name, err)
    sd = tm.state_dict()
    for path, v in traverse_util.flatten_dict(stats).items():
        name = ".".join(path[:-1]) + (".running_mean" if path[-1] == "mean"
                                      else ".running_var")
        np.testing.assert_allclose(sd[name].numpy(), np.asarray(v),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    assert not torch.equal(after[head], before[head]), head
    for name in frozen:
        assert torch.equal(after[name], before[name]), name


@pytest.mark.parametrize("mode", ["hpca", "contrastive"])
def test_unet_pretrain_step_matches(no_dropout, monkeypatch, mode):
    jspec, tspec = _spec_pair(mode, ("out_conv",))
    jm = junet.UNet2D(in_channels=3, n_cls=2, hebb=jspec)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    mask = (rng.random((3, 32, 32)) < 0.4).astype(np.int64)
    tm = UNet2D(3, 2, hebb=tspec, device="cpu", generator=make_generator(5))
    for m in tm.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    rec = PermRecorder(monkeypatch)
    stats, deltas = _hebbax_forward(jm, _carry(tm), x,
                                    {"hebb": jax.random.PRNGKey(8)})
    assert len(rec.perms) == (22 if mode == "contrastive" else 0)
    assert any((p != np.arange(3)).any() for p in rec.perms) or \
        mode != "contrastive"
    rec.install(tm)
    before, after = _port_step(
        tm, "unet", ("out_conv",),
        {"image": torch.from_numpy(np.ascontiguousarray(
            x.transpose(0, 3, 1, 2))), "mask": torch.from_numpy(mask)})
    assert rec.perms == []
    _check(tm, stats, deltas, before, after, 22, "out_conv.conv1.weight",
           ("encoder.in_conv.conv1.bias", "encoder.in_conv.bn1.weight"))


def test_unet3d_hpca_t_pretrain_step_matches():
    jspec, tspec = _spec_pair("hpca_t", ("conv",))
    jm = JUNet3D(in_channels=1, n_cls=2, init_features=8, hebb=jspec)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 32, 32, 32)).astype(np.float32)
    mask = (rng.random((2, 32, 32, 32)) < 0.4).astype(np.int32)
    tm = UNet3D(1, 2, init_features=8, hebb=tspec,
                generator=make_generator(6))
    assert tm.decoder.upconv4.weight.shape[1] == 64   # the chunk matters
    stats, deltas = _hebbax_forward(jm, _carry(tm), x[..., None])
    before, after = _port_step(tm, "unet3d", ("conv",),
                               to_device_batch_3d({"image": x, "mask": mask},
                                                  "cpu"))
    _check(tm, stats, deltas, before, after, 22, "conv.weight",
           ("encoder.encoder1.conv1.bias", "decoder.upconv1.bias"))


def test_vnet_swta_t_pretrain_step_matches(vnet_no_dropout):
    exclude = ("out_tr.conv2",)
    jspec, tspec = _spec_pair("swta_t", exclude)
    tm = get_network("vnet", 1, 2, hebb=tspec, device="cpu",
                     generator=make_generator(7))
    for m in tm.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    jm = j_get_network("vnet", 1, 2, hebb=jspec)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 32, 32, 32)).astype(np.float32)
    mask = (rng.random((1, 32, 32, 32)) < 0.4).astype(np.int32)
    stats, deltas = _hebbax_forward(jm, _carry(tm), x[..., None])
    before, after = _port_step(tm, "vnet", exclude,
                               to_device_batch_3d({"image": x, "mask": mask},
                                                  "cpu"))
    _check(tm, stats, deltas, before, after, 24, "out_tr.conv2.weight",
           ("down_tr32.down_conv.bias", "up_tr32.up_conv.bias",
            "in_tr.bn1.weight"))


def test_unet_cct_contrastive_deltas_match_nan_sites_included(
        no_dropout, monkeypatch):
    """``unet_cct`` under contrastive, hebbax's perturbation draws and
    permutations injected: every delta summed over the four decoder
    passes matches, and the sites whose delta is NaN — where a
    perturbation zeroes a neighbourhood of a level, so an output voxel's
    channel vector is exactly zero and ``normalize`` differentiates sqrt
    at 0 — are the same in both packages, NaN voxel for NaN voxel."""
    jspec, tspec = _spec_pair("contrastive", ("out_conv",))
    jm = junet.UNetCCT2D(in_channels=3, n_cls=2, hebb=jspec)
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    tm = UNetCCT2D(3, 2, hebb=tspec, device="cpu",
                   generator=make_generator(0))
    for m in tm.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    draws = DrawRecorder(monkeypatch)
    perms = PermRecorder(monkeypatch)
    _, deltas = _hebbax_forward(jm, _carry(tm), x,
                                {"perturb": jax.random.PRNGKey(2),
                                 "hebb": jax.random.PRNGKey(3)})
    draws.install(tm)
    perms.install(tm)
    tm.train()
    with torch.no_grad():
        tm(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    assert draws.records == [] and perms.perms == []
    got = pop_deltas(tm)
    assert set(got) == set(deltas)
    nan_sites = []
    for name, ref in deltas.items():
        ref = np.transpose(ref, (3, 2, 0, 1))
        g = got[name].numpy()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(ref),
                                      err_msg=name)
        if np.isnan(ref).any():
            nan_sites.append(name)
            continue
        scale = float(np.abs(ref).max())
        assert float(np.abs(g - ref).max()) <= TOL * scale, name
    assert nan_sites, "no perturbation zeroed a neighbourhood"
