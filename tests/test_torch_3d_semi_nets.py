"""The port's 3D semi-supervised networks, ``unet3d_dtc`` (UNet3DDTC),
``unet3d_cct`` (UNet3DCCT) and ``unet3d_urpc`` (UNet3DURPC), held against
hebbax's on carried weights, with their registry names and snapshots.

hebbax's variables go through ``hebbax_torch.bridge.from_flax`` — told
which modules are transpose convs — into the port's model, and both run
the same numpy-seeded 2x32^3 input (URPC's bottleneck is then 2^3, so its
instance norm has 8 voxels; the UNet3D variants run at 4 initial features
and have a 2^3 BN bottleneck over 16 values, as in
test_torch_3d_model.py).  URPC's channel dropout is off in both (the
streams differ by design; hebbax's ``nn.Dropout`` is swapped for the
identity); CCT's perturbation draws are hebbax's, replayed by
test_torch_deep4.py's ``DrawRecorder``.

Tolerances: eval and training outputs within 1e-4 of max(1, max|output|)
(the logits reach 7; train-mode BN over the 2^3 bottleneck amplifies
XLA-vs-oneDNN conv rounding to 1.6e-4 on them at some seeds, 2e-5 of
their scale: the gate chip_smoke.py's phase 8 uses, card against CPU); BN
statistics rtol 1e-4 / atol 1e-5; Hebbian deltas within 1e-3 of each
site's largest |delta|, as test_torch_deep4.py and chip_smoke.py hold them
(K=50 softmax over sums of up to 2*32^3 voxels: CCT's
``encoder.bottleneck.conv1`` reaches 1.4e-4 of its scale).  Snapshots are
exact and byte-equal.
"""

import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax import traverse_util

import jax
import jax.numpy as jnp

import hebbax.models.unet3d as j3d
import hebbax.models.urpc3d as jurpc
from hebbax.hebb.spec import HebbSpec as JSpec
from hebbax.models.registry import network_meta as j_meta
from hebbax.utils import checkpoint as jckpt
from hebbax_torch import bridge
from hebbax_torch.hebb.layers import transposed_paths
from hebbax_torch.hebb.spec import HebbSpec
from hebbax_torch.hebb.surgery import pop_deltas
from hebbax_torch.models import get_network, network_meta, primary_logits
from hebbax_torch.models.common import CCT_PERTURB_KINDS
from hebbax_torch.models.unet3d import UNet3D, UNet3DCCT, UNet3DDTC
from hebbax_torch.models.urpc3d import UNet3DURPC
from hebbax_torch.models.unet3d_s2d import UNet3DCCTS2D, UNet3DDTCS2D
from hebbax_torch.models.urpc3d_s2d import UNet3DURPCS2D
from hebbax_torch.ops.dropout import Dropout
from hebbax_torch.utils import checkpoint as tckpt

from test_torch_3d_model import to_j, to_t
from test_torch_deep4 import DrawRecorder, count_deltas  # noqa: F401

torch.set_num_threads(2)

# the sweep's exclude list (reproduce_hebbian_unsupervised_pretraining_3d)
EXCLUDE = ("conv", "dsv1", "dsv2", "dsv3", "dsv4", "out_conv", "out_sdf",
           "out_seg")
FEATURES = 4
CLASSES = {"unet3d": (j3d.UNet3D, UNet3D),
           "unet3d_dtc": (j3d.UNet3DDTC, UNet3DDTC),
           "unet3d_cct": (j3d.UNet3DCCT, UNet3DCCT),
           "unet3d_urpc": (jurpc.UNet3DURPC, UNet3DURPC)}
# Hebbian sites: 18 3x3x3 convs + 4 transpose convs in the UNet3D family,
# URPC's 18 3x3x3 convs; the heads are excluded
SITES = {"unet3d": 22, "unet3d_dtc": 22, "unet3d_cct": 22, "unet3d_urpc": 18}


class _NoDropout(fnn.Module):
    rate: float
    broadcast_dims: tuple = ()
    deterministic: bool = None

    @fnn.compact
    def __call__(self, x):
        return x


class _LinenNoDropout:
    """flax.linen with ``Dropout`` as the identity, for hebbax's urpc3d."""

    Dropout = _NoDropout

    def __getattr__(self, name):
        return getattr(fnn, name)


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(jurpc, "nn", _LinenNoDropout())


def make_net_pair_3d(name, hebb=False, seed=0, alpha=1.0,
                     shape=(2, 32, 32, 32)):
    """(hebbax model, its numpy variables, the port's model carrying them
    with dropout off, numpy NDHWC input); ``hebb``: swta_t K=50 with the
    sweep's exclude list and ``alpha`` (1 pretraining, 0 fine-tuning)."""
    jcls, tcls = CLASSES[name]
    kw = {} if name == "unet3d_urpc" else {"init_features": FEATURES}
    jspec = tspec = None
    if hebb:
        skw = dict(mode="swta_t", k=50.0, w_nrm=True, alpha=alpha,
                   exclude=EXCLUDE)
        jspec, tspec = JSpec(**skw), HebbSpec(**skw)
    jm = jcls(in_channels=1, n_cls=2, hebb=jspec, **kw)
    x = np.random.default_rng(seed).standard_normal(
        shape + (1,)).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                        train=False)
    variables = dict(jax.tree_util.tree_map(np.asarray, variables))
    tm = tcls(1, 2, hebb=tspec, device="cpu", **kw)
    tm.load_state_dict(bridge.from_flax(variables["params"],
                                        variables.get("batch_stats"),
                                        transposed_paths(tm)))
    for m in tm.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return jm, variables, tm, x


def stats_close(jstats, tm):
    flat = traverse_util.flatten_dict(jstats or {})
    sd = tm.state_dict()
    assert len(flat) == sum(k.endswith(("running_mean", "running_var"))
                            for k in sd)
    for path, v in flat.items():
        name = ".".join(path[:-1]) + (".running_mean" if path[-1] == "mean"
                                      else ".running_var")
        np.testing.assert_allclose(sd[name].numpy(), np.asarray(v),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def outputs_close(got, ref):
    """Every output within 1e-4 of max(1, its largest |value|)."""
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        r = np.asarray(r)
        np.testing.assert_allclose(to_j(g), r, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(r).max()),
                                   err_msg=f"output {i}")


def deltas_close(mut, tm, n_sites, tol=1e-3):
    got = pop_deltas(tm)
    tp = transposed_paths(tm)
    ref = {}
    for p, v in traverse_util.flatten_dict(mut["hebb"]).items():
        mod = ".".join(p[:-1])
        perm = (3, 4, 0, 1, 2) if mod in tp else (4, 3, 0, 1, 2)
        ref[mod + ".weight"] = np.transpose(np.asarray(v), perm)
    assert len(got) == len(ref) == n_sites and set(got) == set(ref)
    for name, d in got.items():
        scale = float(np.abs(ref[name]).max())
        np.testing.assert_allclose(d.numpy(), ref[name], rtol=0,
                                   atol=tol * scale, err_msg=name)


# -- registry -----------------------------------------------------------------

@pytest.mark.parametrize("name,cls", [
    ("unet3d_dtc", UNet3DDTC), ("unet3d_dtc_s2d", UNet3DDTCS2D),
    ("unet3d_cct", UNet3DCCT), ("unet3d_cct_s2d", UNet3DCCTS2D),
    ("unet3d_cct_s2d_rc", UNet3DCCTS2D), ("unet3d_cct_min", UNet3DCCT),
    ("unet3d_urpc", UNet3DURPC), ("unet3d_urpc_s2d", UNet3DURPCS2D)])
def test_registry_entries(name, cls):
    """The ``_s2d`` names build hebbax's folded classes
    (``models/unet3d_s2d.py``, ``urpc3d_s2d.py``)."""
    assert network_meta(name) == j_meta(name)
    m = get_network(name, 1, 2, device="meta")
    assert type(m) is cls
    if cls in (UNet3DCCT, UNet3DCCTS2D):
        f = 32 if name.endswith("_min") else 64
        assert m.conv.weight.shape == (2, f, 1, 1, 1)


def test_batched_names_are_not_registered():
    """The two 4N-batched 3D CCT names are registered now (the name is
    kept): hebbax's deep4 metadata, the folded ``UNet3DCCTS2D`` with the
    batched decode, the ``_rc`` one recomputing its decoder with the conv
    outputs saved."""
    for name in ("unet3d_cct_s2d_batched", "unet3d_cct_s2d_batched_rc"):
        assert network_meta(name) == j_meta(name)
        assert network_meta(name)["outputs"] == "deep4"
        m = get_network(name, 1, 2, device="meta")
        assert type(m) is UNet3DCCTS2D and m.batched_aux
        assert m.remat == name.endswith("_rc")
        assert m.remat_policy == ("convs" if m.remat else None)


def test_primary_logits_of_dtc_is_the_segmentation():
    sdf, seg = torch.zeros(1), torch.ones(1)
    assert primary_logits("unet3d_dtc_s2d", (sdf, seg)) is seg
    assert primary_logits("unet3d_urpc", (seg, sdf, sdf, sdf)) is seg


# -- parameter trees and snapshots ------------------------------------------

@pytest.mark.parametrize("name", ["unet3d_dtc", "unet3d_cct", "unet3d_urpc"])
def test_param_tree_maps_one_to_one(name):
    _, variables, tm, _ = make_net_pair_3d(name, shape=(1, 16, 16, 16))
    flat = {**traverse_util.flatten_dict(variables["params"]),
            **traverse_util.flatten_dict(variables.get("batch_stats", {}))}
    assert len(flat) == len(tm.state_dict())
    sd = tm.state_dict()
    tp = transposed_paths(tm)
    for path, v in flat.items():
        mod = ".".join(path[:-1])
        t_name = mod + {"kernel": ".weight", "scale": ".weight",
                        "bias": ".bias", "mean": ".running_mean",
                        "var": ".running_var"}[path[-1]]
        t_shape = tuple(sd[t_name].shape)
        if path[-1] == "kernel":
            io = v.shape[3:] if mod in tp else v.shape[3:][::-1]
            assert t_shape == io + v.shape[:3], t_name
        else:
            assert t_shape == v.shape, t_name
    if name == "unet3d_urpc":
        assert "batch_stats" not in variables
        assert {"conv1.conv1", "center.conv2", "up_concat1.conv.conv1",
                "dsv4"} <= {".".join(p[:-1]) for p in flat}
    if name == "unet3d_cct":
        assert tp == {f"main_decoder.upconv{i}" for i in range(1, 5)}


META = dict(threshold=0.41, hebb_params=HebbSpec(exclude=EXCLUDE).to_dict(),
            layers_excluded=list(EXCLUDE))


@pytest.mark.parametrize("name", ["unet3d_dtc", "unet3d_cct", "unet3d_urpc"])
def test_snapshots_cross_both_ways(tmp_path, name):
    _, variables, tm, _ = make_net_pair_3d(name, seed=3,
                                           shape=(1, 16, 16, 16))
    # hebbax -> port: a strict load under the port's names
    pj = jckpt.save_snapshot(variables, str(tmp_path / "j"), **META)
    fresh = CLASSES[name][1](1, 2, **({} if name == "unet3d_urpc" else
                                      {"init_features": FEATURES}))
    sd, meta = tckpt.load_state_dict(pj, transposed_paths(fresh))
    fresh.load_state_dict(sd)
    assert meta["threshold"] == 0.41
    for k, v in tm.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    # port -> hebbax: the same bytes, read back to the same tree
    pt = tckpt.save_snapshot(tm.state_dict(), str(tmp_path / "t"),
                             transposed=transposed_paths(tm), **META)
    with open(pj, "rb") as fj, open(pt, "rb") as ft:
        assert fj.read() == ft.read()
    back, _ = jckpt.load_snapshot(pt)
    assert set(back) == set(variables)
    flat_b = traverse_util.flatten_dict(back)
    for k, v in traverse_util.flatten_dict(variables).items():
        np.testing.assert_array_equal(flat_b[k], v)


# -- forwards -----------------------------------------------------------------

@pytest.mark.parametrize("hebb", [False, True])
@pytest.mark.parametrize("name", ["unet3d_dtc", "unet3d_cct", "unet3d_urpc"])
def test_eval_forward_matches(no_dropout, name, hebb):
    jm, variables, tm, x = make_net_pair_3d(name, hebb=hebb, seed=1,
                                            alpha=0.0)
    ref = jm.apply(variables, jnp.asarray(x), train=False)
    tm.eval()
    with torch.no_grad():
        got = tm(to_t(x))
    # DTC: sdf and seg; URPC: all four heads; CCT: the primary output
    n = {"unet3d_dtc": 2, "unet3d_cct": 1, "unet3d_urpc": 4}[name]
    assert len(got) == len(ref)
    outputs_close(got[:n], ref[:n])
    if name == "unet3d_dtc":
        assert float(got[0].abs().max()) <= 1.0               # tanh head
    if name == "unet3d_cct":
        assert all(o is got[0] for o in got)


def test_dtc_train_forward_matches(count_deltas):
    jm, variables, tm, x = make_net_pair_3d("unet3d_dtc", hebb=True, seed=2)
    ref, mut = jm.apply(variables, jnp.asarray(x), train=True,
                        mutable=["batch_stats", "hebb"])
    tm.train()
    with torch.no_grad():
        got = tm(to_t(x))
    outputs_close(got, ref)
    stats_close(mut["batch_stats"], tm)
    # the 18 forward convs go through the dispatcher, which sends every
    # 5-D weight to the composed 3D rule; the 4 transpose convs do not
    assert len(count_deltas) == 18
    deltas_close(mut, tm, 22)


def test_cct_train_forward_matches_with_hebbax_draws(monkeypatch):
    rec = DrawRecorder(monkeypatch, module=j3d)
    jm, variables, tm, x = make_net_pair_3d("unet3d_cct", hebb=True, seed=3)
    ref, mut = jm.apply(variables, jnp.asarray(x), train=True,
                        mutable=["batch_stats", "hebb"],
                        rngs={"perturb": jax.random.PRNGKey(6)})
    jax.effects_barrier()
    assert [k for k, _ in rec.records] == list(CCT_PERTURB_KINDS)
    assert all(len(d) == 5 for _, d in rec.records)    # 4 skips + bottleneck
    rec.install(tm)
    tm.train()
    with torch.no_grad():
        got = tm(to_t(x))
    assert rec.records == []
    outputs_close(got, ref)                     # main + 3 perturbed passes
    assert not np.allclose(to_j(got[0]), to_j(got[1]))
    # the shared decoder's BN statistics took four momentum updates
    stats_close(mut["batch_stats"], tm)
    deltas_close(mut, tm, 22)


def test_cct_eval_forward_draws_nothing():
    _, _, tm, x = make_net_pair_3d("unet3d_cct", hebb=True, seed=4,
                                   shape=(1, 16, 16, 16))
    tm.eval()
    tm.draw_perturbations = None
    with torch.no_grad():
        out = tm(to_t(x))
    assert len(out) == 4 and pop_deltas(tm) == {}


def test_urpc_train_forward_matches(no_dropout):
    jm, variables, tm, x = make_net_pair_3d("unet3d_urpc", hebb=True,
                                            seed=5)
    ref, mut = jm.apply(variables, jnp.asarray(x), train=True,
                        mutable=["hebb"],
                        rngs={"dropout": jax.random.PRNGKey(1)})
    assert "batch_stats" not in mut
    tm.train()
    with torch.no_grad():
        got = tm(to_t(x))
    outputs_close(got, ref)
    deltas_close(mut, tm, SITES["unet3d_urpc"])
