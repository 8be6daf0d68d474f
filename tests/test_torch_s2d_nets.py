"""The 17 ``*_s2d`` names on the port's folded networks
(``hebbax_torch/models/unet2d_s2d.py``, ``unet3d_s2d.py``,
``urpc3d_s2d.py``, ``vnet_s2d.py``), held against hebbax's folded classes
and against the port's unfolded twins.

* Registry: every ``_s2d`` name builds its folded class with hebbax's
  metadata and options; the plain names keep the unfolded classes.
* Twins: a folded network and its unfolded twin built from the same
  generators have the same parameters, and with dropout and the CCT
  perturbations ON (the folded ones draw the twin's masks and draws) give
  the same eval and training outputs, BN statistics, Hebbian deltas
  (swta_t, K=50, heads excluded) and one step's gradients.  The
  ``unet3d_s2d`` names build their twins (``models/unet3d_s2d.py``), so
  for them the checks against hebbax's folded classes are the ones that
  bind.
* hebbax: its folded class on the port's weights (``bridge.to_flax``),
  dropout off in both (the streams differ by design), CCT draws replayed
  from hebbax (``DrawRecorder``): eval outputs of every name, and the
  training outputs, BN statistics and deltas of the 2D and 3D UNet names;
  one step's gradients of ``unet_s2d``, ``unet_urpc_s2d``,
  ``unet3d_s2d`` and ``unet3d_urpc_s2d``; ``head_depth=2``; bfloat16.
* Snapshots cross ``unet`` <-> ``unet_s2d``, ``unet3d`` <->
  ``unet3d_s2d`` and hebbax <-> the port; 2 gloo ranks match one process
  (float64).  The VNet names are in test_torch_s2d_vnet.py.

Sizes: 2D at 2x32x32 full width; 3D at 2x32^3 (16^3 is too small for
train-mode BN), the UNet3D names at 4 initial features, URPC at full
width.  Tolerances, each the larger of the port's test of the unfolded
class against hebbax and hebbax's own s2d test: outputs within 1e-4 of
max(1, max|output|) (test_torch_3d_semi_nets.py; hebbax's s2d tests hold
3e-5 / 5e-5), training BN statistics rtol 1e-4 / atol 1e-5 (both),
deltas within 2e-3 of each site's largest |delta| (hebbax
``tests/test_s2d.py``; the port's 1e-3), gradients within 2e-4 of the
network's largest |gradient| (hebbax ``tests/test_unet3d_s2d.py``; 2D
against hebbax 2e-3 of it, hebbax's delta bound: hebbax has no 2D
gradient test, and its own folded and unfolded 2D gradients differ by
9.5e-4 of it; URPC 5e-3 of it, hebbax's VNet delta bound: instance
norm over its 2^3 bottleneck conditions it worse, and hebbax's own
folded and unfolded URPC gradients differ by 2.8e-3 of it in float32);
bfloat16 outputs within 3e-2 of max(1, max|output|)
(test_torch_bf16.py); twins (same package, same float32 ops but the
layout) the same bounds; float64 ranks rtol 1e-9 (their deltas, which
the 2D swta sites compute in float32, the delta bound).
"""

import dataclasses

import numpy as np
import pytest
import torch
from flax import traverse_util

import jax
import jax.numpy as jnp

import hebbax.models.common as jcommon
import hebbax.models.unet2d as junet
import hebbax.models.unet2d_s2d as j2s2d
import hebbax.models.urpc3d as jurpc
import hebbax.models.urpc3d_s2d as jurpc_s2d
from hebbax.hebb.spec import HebbSpec as JSpec
from hebbax.models.registry import get_network as j_get_network
from hebbax.models.registry import network_meta as j_meta
from hebbax.utils import checkpoint as jckpt
from hebbax_torch import bridge, parallel
from hebbax_torch.hebb.layers import (FoldedHConv, FoldedHConv3, HConv,
                                      transposed_paths)
from hebbax_torch.hebb.spec import HebbSpec
from hebbax_torch.hebb.surgery import pop_deltas
from hebbax_torch.models import get_network, network_meta, registry
from hebbax_torch.models.unet2d import UNet2D, UNetCCT2D, UNetURPC2D
from hebbax_torch.models.unet2d_s2d import (UNet2DS2D, UNetCCT2DS2D,
                                            UNetURPC2DS2D)
from hebbax_torch.models.unet3d import UNet3D, UNet3DCCT, UNet3DDTC
from hebbax_torch.models.unet3d_s2d import (UNet3DCCTS2D, UNet3DDTCS2D,
                                            UNet3DS2D)
from hebbax_torch.models.urpc3d import UNet3DURPC
from hebbax_torch.models.urpc3d_s2d import UNet3DURPCS2D
from hebbax_torch.models.vnet import VNet, VNetCCT, VNetDTC
from hebbax_torch.models.vnet_s2d import VNetCCTS2D, VNetDTCS2D, VNetS2D
from hebbax_torch.ops.dropout import Dropout
from hebbax_torch.utils import checkpoint as tckpt

import test_torch_s2d_cases as cases
from test_torch_deep4 import DrawRecorder
from test_torch_3d_semi_nets import _LinenNoDropout
from test_torch_unet2d import _NoDropout

torch.set_num_threads(2)

OUT_TOL, DELTA_TOL, GRAD_TOL, BF16_TOL = 1e-4, 2e-3, 2e-4, 3e-2
GRAD_TOL_2D, GRAD_TOL_URPC = 2e-3, 5e-3

# name -> (folded class, unfolded twin class, twin options)
FOLDED = {
    "unet_s2d": (UNet2DS2D, UNet2D, {}),
    "unet_urpc_s2d": (UNetURPC2DS2D, UNetURPC2D, {}),
    "unet_cct_s2d": (UNetCCT2DS2D, UNetCCT2D, {}),
    "unet_cct_s2d_batched": (UNetCCT2DS2D, UNetCCT2D,
                             dict(batched_aux=True)),
    "unet3d_s2d": (UNet3DS2D, UNet3D, {}),
    "unet3d_dtc_s2d": (UNet3DDTCS2D, UNet3DDTC, {}),
    "unet3d_cct_s2d": (UNet3DCCTS2D, UNet3DCCT, {}),
    "unet3d_cct_s2d_rc": (UNet3DCCTS2D, UNet3DCCT,
                          dict(remat=True, remat_policy="convs")),
    "unet3d_cct_s2d_batched": (UNet3DCCTS2D, UNet3DCCT,
                               dict(batched_aux=True)),
    "unet3d_cct_s2d_batched_rc": (UNet3DCCTS2D, UNet3DCCT, dict(
        batched_aux=True, remat=True, remat_policy="convs")),
    "unet3d_urpc_s2d": (UNet3DURPCS2D, UNet3DURPC, {}),
    "vnet_s2d": (VNetS2D, VNet, {}),
    "vnet_dtc_s2d": (VNetDTCS2D, VNetDTC, {}),
    "vnet_cct_s2d": (VNetCCTS2D, VNetCCT, {}),
    "vnet_cct_s2d_rc": (VNetCCTS2D, VNetCCT,
                        dict(remat=True, remat_policy="convs")),
    "vnet_cct_s2d_batched": (VNetCCTS2D, VNetCCT, dict(batched_aux=True)),
    "vnet_cct_s2d_batched_rc": (VNetCCTS2D, VNetCCT, dict(
        batched_aux=True, remat=True, remat_policy="convs")),
}
NETS = [n for n in FOLDED if not n.startswith("vnet")]
HEADS = {"unet": ("out_conv",), "unet_urpc": (
    "out_conv_dp1", "out_conv_dp2", "out_conv_dp3", "out_conv"),
    "unet_cct": ("out_conv",), "unet3d": ("conv",),
    "unet3d_dtc": ("out_sdf", "out_seg"), "unet3d_cct": ("conv",),
    "unet3d_urpc": ("dsv1", "dsv2", "dsv3", "dsv4"),
    "vnet": ("out_tr.conv2",), "vnet_dtc": ("out_sdf.conv2", "out_seg.conv2"),
    "vnet_cct": ("main_decoder.out_tr.conv2",)}


def family(name):
    for base in sorted(HEADS, key=len, reverse=True):
        if name.startswith(base + "_s2d"):
            return base
    raise KeyError(name)


def spec_kw(name, alpha=1.0):
    return dict(mode="swta_t", k=50.0, w_nrm=True, alpha=alpha,
                exclude=HEADS[family(name)])


def geometry(name):
    """(in_channels, input spatial shape, extra constructor keywords)."""
    if network_meta(name)["nd"] == 2:
        return 3, (32, 32), {}
    small = name.startswith("unet3d") and "urpc" not in name
    return 1, (32, 32, 32), ({"init_features": 4} if small else {})


def twin_pair(name, hebb=True, seed=0, dropout=True, dtype=None):
    """(folded model of ``name``, its unfolded twin), built from the same
    generators, in training mode."""
    folded_cls, twin_cls, opts = FOLDED[name]
    in_ch, _, extra = geometry(name)
    models = []
    for factory in (registry._REGISTRY[name][0],
                    lambda **kw: twin_cls(**opts, **kw)):
        kw = dict(in_channels=in_ch, n_cls=2, dtype=dtype,
                  hebb=HebbSpec(**spec_kw(name)) if hebb else None,
                  generator=torch.Generator().manual_seed(seed),
                  dropout_generator=torch.Generator().manual_seed(seed + 1),
                  **extra)
        if "cct" in name:
            kw["perturb_generator"] = torch.Generator().manual_seed(seed + 2)
        m = factory(**kw)
        if not dropout:
            for mod in m.modules():
                if isinstance(mod, Dropout):
                    mod.p = 0.0
        models.append(m.train())
    assert type(models[0]) is folded_cls
    return models


def port_input(name, seed, batch=2):
    in_ch, shape, _ = geometry(name)
    return np.random.default_rng(seed).standard_normal(
        (batch,) + shape + (in_ch,)).astype(np.float32)


def to_t(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def to_j(t):
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


def as_tuple(out):
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def outputs_close(got, ref, tol=OUT_TOL):
    got, ref = as_tuple(got), as_tuple(ref)
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        r = np.asarray(r, np.float32)
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=tol * max(1.0, np.abs(r).max()),
                                   err_msg=f"output {i}")


def deltas_close(got, ref):
    assert set(got) == set(ref) and got
    for k, d in got.items():
        r = np.asarray(ref[k])
        np.testing.assert_allclose(np.asarray(d), r, rtol=0,
                                   atol=DELTA_TOL * np.abs(r).max(),
                                   err_msg=k)


def stats_of(model):
    return {k: v.numpy() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def stats_close(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def grads_close(got, ref):
    assert set(got) == set(ref)
    scale = max(float(np.abs(r).max()) for r in ref.values())
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=k)


def port_grads(model, x):
    outs = as_tuple(model(x.to(next(model.parameters()).dtype)))
    loss = sum(torch.mean(o ** 2) for o in outs)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return {n: g.numpy() for n, g in zip(names, grads)}


# -- hebbax -------------------------------------------------------------------

@pytest.fixture
def no_dropout(monkeypatch):
    """hebbax's dropouts as the identity (the port's p is set to 0)."""
    for mod in (junet, j2s2d):
        monkeypatch.setattr(mod, "FastDropout", _NoDropout)
    for mod in (jurpc, jurpc_s2d):
        monkeypatch.setattr(mod, "nn", _LinenNoDropout())


def hebbax_pair(name, tm, hebb=True, dtype=None, **kw):
    """(hebbax's folded network of ``name``, the port's variables)."""
    _, _, extra = geometry(name)
    jm = j_get_network(name, geometry(name)[0], 2,
                       hebb=JSpec(**spec_kw(name)) if hebb else None,
                       dtype=dtype, **extra, **kw)
    params, stats = jax.tree_util.tree_map(np.array, bridge.to_flax(
        tm.state_dict(), transposed_paths(tm)))
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    return jm, variables


def hebbax_deltas(mut, tm):
    tp = transposed_paths(tm)
    out = {}
    for p, v in traverse_util.flatten_dict(mut.get("hebb", {})).items():
        mod = ".".join(p[:-1])
        v = np.asarray(v)
        nd = v.ndim - 2
        perm = ((nd, nd + 1) if mod in tp else (nd + 1, nd)) + tuple(
            range(nd))
        out[mod + ".weight"] = np.transpose(v, perm)
    return out


def hebbax_stats(mut):
    out = {}
    for p, v in traverse_util.flatten_dict(mut.get("batch_stats",
                                                   {})).items():
        key = ".".join(p[:-1]) + (".running_mean" if p[-1] == "mean"
                                  else ".running_var")
        out[key] = np.asarray(v)
    return out


# -- registry -----------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(FOLDED))
def test_s2d_names_build_the_folded_classes(name):
    folded_cls, twin_cls, opts = FOLDED[name]
    assert network_meta(name) == j_meta(name)
    m = get_network(name, 1, 2, device="meta")
    assert type(m) is folded_cls
    for k, v in opts.items():
        assert getattr(m, k) == v, k
    if folded_cls in (UNet3DCCTS2D, VNetCCTS2D, UNetCCT2DS2D):
        assert m.batched_aux == ("_batched" in name)
    if folded_cls in (UNet3DCCTS2D, VNetCCTS2D):
        # the plain folded names recompute nothing
        assert m.remat == name.endswith("_rc")
        assert m.remat_policy == ("convs" if m.remat else None)
    twin = twin_cls(1, 2, device="meta", **opts)
    assert {k: v.shape for k, v in m.state_dict().items()} == {
        k: v.shape for k, v in twin.state_dict().items()}
    assert transposed_paths(m) == transposed_paths(twin)


def test_the_plain_names_keep_the_unfolded_classes():
    for name, cls in (("unet", UNet2D), ("unet_urpc", UNetURPC2D),
                      ("unet_cct", UNetCCT2D), ("unet3d", UNet3D),
                      ("unet3d_dtc", UNet3DDTC), ("unet3d_cct", UNet3DCCT),
                      ("unet3d_urpc", UNet3DURPC), ("vnet", VNet),
                      ("vnet_cct", VNetCCT), ("vnet_dtc", VNetDTC)):
        m = get_network(name, 1, 2, device="meta")
        assert type(m) is cls
        assert not any(isinstance(c, (FoldedHConv, FoldedHConv3))
                       for c in m.modules())
    assert sum(n.endswith("_s2d") or "_s2d_" in n
               for n in registry.available_networks()) == 17


# -- twins --------------------------------------------------------------------

def twin_check(name, seed=0, batch=2, backward=True, hebb=True):
    """Eval and training outputs, BN statistics, (``hebb``) deltas and
    (``backward``) gradients of the folded network against its unfolded
    twin, dropout and perturbations on."""
    tm, twin = twin_pair(name, hebb=hebb, seed=seed)
    sd, sd_twin = tm.state_dict(), twin.state_dict()
    assert sd.keys() == sd_twin.keys()
    assert all(torch.equal(sd[k], sd_twin[k]) for k in sd)
    x = to_t(port_input(name, seed + 3, batch))
    tm.eval(), twin.eval()
    with torch.no_grad():
        outputs_close([o.numpy() for o in as_tuple(tm(x))],
                      [o.numpy() for o in as_tuple(twin(x))])
    tm.train(), twin.train()
    with torch.no_grad():
        got, ref = as_tuple(tm(x)), as_tuple(twin(x))
    outputs_close([o.numpy() for o in got], [o.numpy() for o in ref])
    stats_close(stats_of(tm), stats_of(twin))
    if hebb:
        deltas_close(pop_deltas(tm), pop_deltas(twin))
    if backward:
        # the fine-tune spec (alpha 0): normalized weights, no delta
        for m in list(tm.modules()) + list(twin.modules()):
            if isinstance(m, HConv) and m.spec is not None:
                m.spec = dataclasses.replace(m.spec, alpha=0.0)
        grads_close(port_grads(tm, x), port_grads(twin, x))


@pytest.mark.parametrize("name", NETS)
def test_folded_network_matches_its_unfolded_twin(name):
    twin_check(name)


def test_head_depth2_matches_the_twin_and_hebbax(no_dropout):
    spec = HebbSpec(**spec_kw("unet_s2d"))
    g = torch.Generator
    tm = UNet2DS2D(3, 2, hebb=spec, head_depth=2,
                   generator=g().manual_seed(0),
                   dropout_generator=g().manual_seed(1)).train()
    twin = UNet2D(3, 2, hebb=spec, generator=g().manual_seed(0),
                  dropout_generator=g().manual_seed(1)).train()
    x = port_input("unet_s2d", 4)
    with torch.no_grad():
        outputs_close(tm(to_t(x)).numpy(), twin(to_t(x)).numpy())
    deltas_close(pop_deltas(tm), pop_deltas(twin))
    jm = j2s2d.UNet2DS2D(in_channels=3, n_cls=2, head_depth=2,
                         hebb=JSpec(**spec_kw("unet_s2d")))
    params, stats = jax.tree_util.tree_map(np.array, bridge.to_flax(
        tm.state_dict()))
    for m in tm.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    ref, mut = jm.apply({"params": params, "batch_stats": stats},
                        jnp.asarray(x), train=True,
                        mutable=["batch_stats", "hebb"])
    with torch.no_grad():
        got = tm(to_t(x))
    outputs_close(to_j(got), ref)
    stats_close(stats_of(tm), hebbax_stats(mut))
    deltas_close(pop_deltas(tm), hebbax_deltas(mut, tm))


# -- against hebbax -----------------------------------------------------------

@pytest.mark.parametrize("name", NETS)
def test_eval_and_training_forward_match_hebbax(name, no_dropout,
                                                monkeypatch):
    rec = DrawRecorder(monkeypatch, module=(
        j2s2d if network_meta(name)["nd"] == 2 else jcommon))
    tm, _ = twin_pair(name, seed=5, dropout=False)
    jm, variables = hebbax_pair(name, tm)
    x = port_input(name, 6)
    ref = jax.jit(lambda v, a: jm.apply(v, a, train=False))(
        variables, jnp.asarray(x))
    tm.eval()
    with torch.no_grad():
        outputs_close([to_j(o) for o in as_tuple(tm(to_t(x)))], ref)
    rngs = {"perturb": jax.random.PRNGKey(7)} if "cct" in name else {}
    ref, mut = jax.jit(lambda v, a: jm.apply(
        v, a, train=True, mutable=["batch_stats", "hebb"], rngs=rngs))(
            variables, jnp.asarray(x))
    jax.effects_barrier()
    if "cct" in name:
        rec.install(tm)
    tm.train()
    with torch.no_grad():
        got = as_tuple(tm(to_t(x)))
    assert rec.records == []
    outputs_close([to_j(o) for o in got], ref)
    stats_close(stats_of(tm), hebbax_stats(mut))
    deltas_close(pop_deltas(tm), hebbax_deltas(mut, tm))


@pytest.mark.parametrize("name", ["unet_s2d", "unet_urpc_s2d", "unet3d_s2d",
                                  "unet3d_urpc_s2d"])
def test_step_gradients_match_hebbax(name, no_dropout):
    """One training step's gradients (the module docstring gives the
    bounds: float32 rounding, amplified by the normalizations over the
    small bottleneck, separates hebbax's own folded and unfolded
    gradients by 1e-3 of the largest; its batch norms reduce in float32,
    so float64 does not remove that)."""
    tm, _ = twin_pair(name, hebb=False, seed=8, dropout=False)
    jm, variables = hebbax_pair(name, tm, hebb=False)
    x = port_input(name, 9)
    tol = (GRAD_TOL if name == "unet3d_s2d" else GRAD_TOL_2D
           if network_meta(name)["nd"] == 2 else GRAD_TOL_URPC)

    def loss(params):
        outs, _ = jm.apply({**variables, "params": params}, jnp.asarray(x),
                           train=True, mutable=["batch_stats"])
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum(jnp.mean(o ** 2) for o in outs)

    jgrads = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(
        variables["params"]))
    ref = bridge.from_flax(jgrads, None, transposed_paths(tm))
    got = port_grads(tm, to_t(x))
    assert set(ref) == set(got)
    scale = max(float(np.abs(r).max()) for r in got.values())
    for k, v in got.items():
        np.testing.assert_allclose(v, np.asarray(ref[k]), rtol=0,
                                   atol=tol * scale, err_msg=k)


@pytest.mark.parametrize("name", ["unet_s2d", "unet3d_s2d"])
def test_bfloat16_matches_hebbax_and_the_twin(name, no_dropout):
    tm, twin = twin_pair(name, hebb=False, seed=10, dropout=False,
                         dtype=torch.bfloat16)
    jm, variables = hebbax_pair(name, tm, hebb=False, dtype=jnp.bfloat16)
    x = port_input(name, 11)
    ref = jax.jit(lambda v, a: jm.apply(v, a, train=False))(
        variables, jnp.asarray(x))
    tm.eval(), twin.eval()
    with torch.no_grad():
        got, other = tm(to_t(x)), twin(to_t(x))
    assert got.dtype == torch.bfloat16
    outputs_close(to_j(got), np.asarray(ref, np.float32), BF16_TOL)
    outputs_close(got.float().numpy(), other.float().numpy(), BF16_TOL)


# -- snapshots ----------------------------------------------------------------

META = dict(threshold=0.4, hebb_params=HebbSpec().to_dict(),
            layers_excluded=[])


@pytest.mark.parametrize("plain,folded", [("unet", "unet_s2d"),
                                          ("unet3d", "unet3d_s2d")])
def test_snapshots_cross_folded_and_unfolded(tmp_path, plain, folded):
    """A snapshot of either loads into the other (port <-> port), and the
    port's snapshot of the folded network is hebbax's byte for byte."""
    _, _, extra = geometry(folded)
    g = torch.Generator().manual_seed(12)
    in_ch = geometry(folded)[0]
    a = get_network(plain, in_ch, 2, generator=g) if not extra else \
        FOLDED[folded][1](in_ch, 2, generator=g, **extra)
    b = get_network(folded, in_ch, 2) if not extra else \
        FOLDED[folded][0](in_ch, 2, **extra)
    for src, dst in ((a, b), (b, a)):
        path = tckpt.save_snapshot(src.state_dict(), str(tmp_path / "s"),
                                   transposed=transposed_paths(src), **META)
        sd, meta = tckpt.load_state_dict(path, transposed_paths(dst))
        dst.load_state_dict(sd)
        assert meta["threshold"] == 0.4
    assert all(torch.equal(a.state_dict()[k], v)
               for k, v in b.state_dict().items())
    # hebbax <-> the port
    jm, variables = hebbax_pair(folded, b, hebb=False)
    p1 = jckpt.save_snapshot(variables, str(tmp_path / "j"), **META)
    p2 = tckpt.save_snapshot(b.state_dict(), str(tmp_path / "t"),
                             transposed=transposed_paths(b), **META)
    with open(p1, "rb") as f1, open(p2, "rb") as f2:
        assert f1.read() == f2.read()
    sd, _ = tckpt.load_state_dict(p1, transposed_paths(b))
    b.load_state_dict(sd)
    x = port_input(folded, 13, batch=1)
    b.eval()
    with torch.no_grad():
        got = b(to_t(x))
    ref = jax.jit(lambda v, t: jm.apply(v, t, train=False))(
        variables, jnp.asarray(x))
    outputs_close(to_j(got), ref)


# -- data parallelism ---------------------------------------------------------

@pytest.mark.parametrize("name", ["unet_s2d", "unet_cct_s2d",
                                  "unet3d_cct_s2d_batched"])
def test_two_gloo_ranks_match_one_process(name):
    """float64, dropout and perturbations on: the 2 ranks' grads and BN
    statistics are one process's, their summed deltas its deltas."""
    size = 32 if network_meta(name)["nd"] == 2 else 16
    single = cases.folded_step(name, size=size)
    ranks = parallel.run_ranks(cases.folded_step, 2, (name, 4, size),
                               timeout=60, deadline=600, threads=1)
    for r in ranks:
        for key in ("grads", "stats"):
            assert r[key].keys() == single[key].keys()
            for k, v in single[key].items():
                np.testing.assert_allclose(r[key][k], v, rtol=1e-9,
                                           atol=1e-12, err_msg=k)
    # the 2D swta sites take the kernel's plain version, in float32
    assert ranks[0]["deltas"].keys() == single["deltas"].keys()
    deltas_close({k: ranks[0]["deltas"][k] + ranks[1]["deltas"][k]
                  for k in single["deltas"]}, single["deltas"])
