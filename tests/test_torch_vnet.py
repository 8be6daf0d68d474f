"""The port's VNet family — ``vnet`` (VNet), ``vnet_cct`` (VNetCCT),
``vnet_dtc`` (VNetDTC) and their ``_s2d`` / ``_rc`` names — held
against hebbax's on carried weights: registry, parameter tree and count,
snapshots both ways, eval forwards (test_torch_vnet_train.py: the
training forwards).

Weights are the port's initialisation carried to hebbax through
``hebbax_torch.bridge.to_flax`` (hebbax's own init of 45.6 M parameters
runs op by op on the CPU for half a minute; the tree it would make is
checked against the carried one by shape through ``jax.eval_shape``).
Both packages run the same numpy-seeded 2x32^3 input (VNet halves it four
times: a 2^3 bottleneck).  The skip dropout is off in both (hebbax's
``nn.Dropout`` swapped for the identity, the port's ``p`` set to 0: the
streams differ by design); VNetCCT's perturbation draws are hebbax's,
replayed by test_torch_deep4.py's ``DrawRecorder``.

Tolerances: outputs within 1e-4 of max(1, max|output|), the 3D gate of
ROADMAP Queue 3 (train-mode batch norm over the 2^3 bottleneck amplifies
XLA-vs-oneDNN conv rounding; measured 8.5e-6 of scale in training, 2.3e-6
in eval); BN statistics rtol 1e-4 / atol 1e-5.  Snapshots are exact and
byte-equal.
"""

import shutil

import numpy as np
import pytest
import torch
from flax import traverse_util

import jax
import jax.numpy as jnp

import hebbax.models.vnet as jvnet
from hebbax.models.registry import get_network as j_get_network
from hebbax.models.registry import network_meta as j_meta
from hebbax.utils import checkpoint as jckpt
from hebbax_torch import bridge
from hebbax_torch.hebb.layers import HConv, transposed_paths
from hebbax_torch.hebb.spec import HebbSpec
from hebbax_torch.models import get_network, network_meta, primary_logits
from hebbax_torch.models.vnet import VNet, VNetCCT, VNetDTC
from hebbax_torch.models.vnet_s2d import VNetCCTS2D, VNetDTCS2D, VNetS2D
from hebbax_torch.ops.dropout import Dropout
from hebbax_torch.utils import checkpoint as tckpt
from hebbax_torch.utils.seeding import make_generator

from test_torch_3d_model import to_t
from test_torch_3d_semi_nets import _LinenNoDropout, outputs_close

torch.set_num_threads(2)

NAMES = {"vnet": VNet, "vnet_cct": VNetCCT, "vnet_dtc": VNetDTC}
N_PARAMS = 45_600_316           # tests/test_models.py: hebbax's VNet


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(jvnet, "nn", _LinenNoDropout())


@pytest.fixture
def run_dir(tmp_path):
    """``tmp_path``, removed when the test ends: a VNet snapshot is 182 MB
    and pytest keeps every test's directory."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def make_vnet_pair(name, seed=0, shape=(2, 32, 32, 32)):
    """(hebbax model, the port's weights as its numpy variables, the port
    model with dropout off, numpy NDHWC input)."""
    tm = get_network(name, 1, 2, device="cpu",
                     generator=make_generator(seed))
    for m in tm.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    # copies: to_flax's arrays share the port's buffers, which its own
    # training forward moves while hebbax's dispatch may still read them
    params, stats = jax.tree_util.tree_map(np.array, bridge.to_flax(
        tm.state_dict(), transposed_paths(tm)))
    jm = j_get_network(name, 1, 2)
    x = np.random.default_rng(seed).standard_normal(
        shape + (1,)).astype(np.float32)
    return jm, {"params": params, "batch_stats": stats}, tm, x


# -- registry -----------------------------------------------------------------

@pytest.mark.parametrize("name,cls", [
    ("vnet", VNet), ("vnet_s2d", VNetS2D), ("vnet_cct", VNetCCT),
    ("vnet_cct_s2d", VNetCCTS2D), ("vnet_cct_s2d_rc", VNetCCTS2D),
    ("vnet_dtc", VNetDTC), ("vnet_dtc_s2d", VNetDTCS2D)])
def test_registry_entries(name, cls):
    """The plain names build the unfolded classes, the ``_s2d`` names
    hebbax's folded ones (``models/vnet_s2d.py``)."""
    assert network_meta(name) == j_meta(name)
    m = get_network(name, 1, 2, device="meta")
    assert type(m) is cls
    a, b = torch.zeros(1), torch.ones(1)
    if cls in (VNetDTC, VNetDTCS2D):
        assert primary_logits(name, (a, b)) is b
    elif cls in (VNetCCT, VNetCCTS2D):
        assert primary_logits(name, (a, b, b, b)) is a
    else:
        assert primary_logits(name, a) is a


def test_batched_names_are_not_registered():
    """The two 4N-batched VNet CCT names are registered now (the name is
    kept): hebbax's deep4 metadata, the folded ``VNetCCTS2D`` with the
    batched decode, the ``_rc`` one recomputing its decoder with the conv
    outputs saved."""
    for name in ("vnet_cct_s2d_batched", "vnet_cct_s2d_batched_rc"):
        assert network_meta(name) == j_meta(name)
        assert network_meta(name)["outputs"] == "deep4"
        m = get_network(name, 1, 2, device="meta")
        assert type(m) is VNetCCTS2D and m.batched_aux
        assert m.remat == name.endswith("_rc")
        assert m.remat_policy == ("convs" if m.remat else None)


@pytest.mark.parametrize("name", list(NAMES))
def test_param_tree_matches_hebbax_by_shape(name):
    """The carried tree has hebbax's paths and shapes, and VNet's count is
    hebbax's 45,600,316."""
    jm, variables, tm, x = make_vnet_pair(name, shape=(1, 16, 16, 16))
    abstract = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros(x.shape), train=False))
    for coll in ("params", "batch_stats"):
        want = {k: v.shape for k, v in
                traverse_util.flatten_dict(abstract[coll]).items()}
        got = {k: v.shape for k, v in
               traverse_util.flatten_dict(variables[coll]).items()}
        assert got == want, coll
    n = sum(p.numel() for p in tm.parameters())
    assert n == sum(int(np.prod(s)) for s in jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda a: a.shape, abstract["params"]),
        is_leaf=lambda a: isinstance(a, tuple)))
    if name in ("vnet", "vnet_cct"):
        assert n == N_PARAMS


def test_hebbian_sites_and_kernel_layouts():
    """25 Hebbian sites: the 4 strided k = s = 2 down convs, the 4
    transpose up convs, the 5x5x5 convs and the 1x1x1 head; a transpose
    kernel maps as (I, O, *k)."""
    tm = VNet(1, 2, hebb=HebbSpec(exclude=("out_tr.conv2",)),
              device="meta")
    sites = [n for n, m in tm.named_modules()
             if isinstance(m, HConv) and m.spec is not None]
    assert len(sites) == 24 and "out_tr.conv2" not in sites
    assert transposed_paths(tm) == {f"up_tr{c}.up_conv"
                                    for c in (256, 128, 64, 32)}
    for c, o in ((32, 32), (64, 64), (128, 128), (256, 256)):
        down = tm.get_submodule(f"down_tr{c}.down_conv")
        assert down.stride == (2, 2, 2) and down.weight.shape == (
            o, o // 2 if c > 32 else 16, 2, 2, 2)
    assert tm.up_tr256.up_conv.weight.shape == (256, 128, 2, 2, 2)
    cct = VNetCCT(1, 2, device="meta")
    assert transposed_paths(cct) == {f"main_decoder.up_tr{c}.up_conv"
                                     for c in (256, 128, 64, 32)}


# -- snapshots ----------------------------------------------------------------

META = dict(threshold=0.37, hebb_params=HebbSpec(
    exclude=("out_tr.conv2",)).to_dict(), layers_excluded=["out_tr.conv2"])


@pytest.mark.parametrize("name", list(NAMES))
def test_snapshots_cross_both_ways(run_dir, name):
    _, variables, tm, _ = make_vnet_pair(name, seed=3, shape=(1, 16, 16, 16))
    flat = traverse_util.flatten_dict(variables["params"])
    for path in {"vnet": ("in_tr", "conv1", "kernel"),
                 "vnet_cct": ("main_decoder", "up_tr32", "up_conv",
                              "kernel"),
                 "vnet_dtc": ("out_sdf", "conv2", "kernel")}[name], \
            ("down_tr32", "down_conv", "kernel"), \
            ("down_tr64", "ops", "conv2", "kernel"):
        assert path in flat, path
    # hebbax -> port: a strict load under the port's names
    pj = jckpt.save_snapshot(variables, str(run_dir / "j"), **META)
    fresh = NAMES[name](1, 2, generator=make_generator(99))
    sd, meta = tckpt.load_state_dict(pj, transposed_paths(fresh))
    fresh.load_state_dict(sd)
    assert meta["threshold"] == 0.37
    for k, v in tm.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    # port -> hebbax: the same bytes, read back to the same tree
    pt = tckpt.save_snapshot(tm.state_dict(), str(run_dir / "t"),
                             transposed=transposed_paths(tm), **META)
    with open(pj, "rb") as fj, open(pt, "rb") as ft:
        assert fj.read() == ft.read()
    back, _ = jckpt.load_snapshot(pt)
    flat_b = traverse_util.flatten_dict(back)
    for k, v in traverse_util.flatten_dict(variables).items():
        np.testing.assert_array_equal(flat_b[k], v)
    # the transpose kernel is (I, O, *k) in the port, (*k, I, O) in hebbax
    up = "main_decoder.up_tr256.up_conv" if name == "vnet_cct" else \
        "up_tr256.up_conv"
    np.testing.assert_array_equal(
        np.transpose(sd[up + ".weight"].numpy(), (2, 3, 4, 0, 1)),
        flat[tuple(up.split(".")) + ("kernel",)])


# -- forwards -----------------------------------------------------------------

@pytest.mark.parametrize("name", list(NAMES))
def test_eval_forward_matches(name):
    jm, variables, tm, x = make_vnet_pair(name, seed=1)
    ref = jax.jit(lambda v, x_: jm.apply(v, x_, train=False))(
        variables, jnp.asarray(x))
    tm.eval()
    with torch.no_grad():
        got = tm(to_t(x))
    if name == "vnet":
        got, ref = (got,), (ref,)
    outputs_close(got, ref)
    if name == "vnet_dtc":
        assert float(got[0].abs().max()) <= 1.0               # tanh head
    if name == "vnet_cct":
        assert all(o is got[0] for o in got)


def test_input_transition_tiles_the_input_to_16_channels():
    """``16 // in_channels`` copies of the input are added before the
    ELU: with in_channels 2, 8 copies."""
    tm = VNet(2, 2, generator=make_generator(0))
    tm.eval()
    x = torch.randn(1, 2, 16, 16, 16)
    out = tm.in_tr.bn1(tm.in_tr.conv1(x))
    with torch.no_grad():
        got = tm.in_tr(x)
        want = torch.nn.functional.elu(out + torch.cat([x] * 8, dim=1))
    assert torch.equal(got, want)
