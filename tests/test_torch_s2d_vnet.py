"""The six VNet ``*_s2d`` names (``hebbax_torch/models/vnet_s2d.py``:
``vnet_s2d``, ``vnet_dtc_s2d``, ``vnet_cct_s2d`` and its ``_rc``,
``_batched``, ``_batched_rc`` variants) held against hebbax's folded
classes and against the port's unfolded twins, full width at 2x32^3, as
test_torch_s2d_nets.py holds the other eleven (its module docstring
states the checks and the tolerances; the VNet deltas within 5e-3 of each
site's largest |delta|, hebbax ``tests/test_vnet_s2d.py``).

hebbax's own init of a VNet runs op by op for half a minute, so the
port's init is carried to hebbax with ``bridge.to_flax`` and hebbax's
applies are jitted.  Every name of one class draws the same parameters
from the same seed, so hebbax's eval output is taken once per class.
hebbax's training forward is held on ``vnet_s2d`` (the CCT draws on the
3D UNet, test_torch_s2d_nets.py): VNet's four decoder passes at full
width take minutes on the CPU.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hebbax.models.common as jcommon
import hebbax.models.vnet as jvnet
import hebbax.models.vnet_s2d as jvs2d
from hebbax.utils import checkpoint as jckpt
from hebbax_torch.hebb.layers import transposed_paths
from hebbax_torch.hebb.surgery import pop_deltas
from hebbax_torch.models import get_network
from hebbax_torch.utils import checkpoint as tckpt

import test_torch_s2d_nets as nets
from test_torch_deep4 import DrawRecorder
from test_torch_3d_semi_nets import _LinenNoDropout

torch.set_num_threads(2)

VNETS = [n for n in nets.FOLDED if n.startswith("vnet")]
VNET_DELTA_TOL = 5e-3


@pytest.fixture
def no_dropout(monkeypatch):
    for mod in (jvnet, jvs2d):
        monkeypatch.setattr(mod, "nn", _LinenNoDropout())


@pytest.fixture(autouse=True)
def vnet_delta_bound(monkeypatch):
    monkeypatch.setattr(nets, "DELTA_TOL", VNET_DELTA_TOL)


@pytest.mark.parametrize("name", VNETS)
def test_folded_vnet_matches_its_unfolded_twin(name):
    """``vnet_s2d`` in full; the other names share its modules and take
    one sample and no backward, and the CCT names (four decoder passes a
    forward) no Hebbian spec."""
    full = name == "vnet_s2d"
    nets.twin_check(name, seed=20, batch=2 if full else 1, backward=full,
                    hebb="cct" not in name)


@functools.lru_cache(maxsize=None)
def _hebbax_eval(cls_name):
    """hebbax's eval output of the class on the seed-21 weights."""
    name = {"VNetS2D": "vnet_s2d", "VNetDTCS2D": "vnet_dtc_s2d",
            "VNetCCTS2D": "vnet_cct_s2d"}[cls_name]
    tm, _ = nets.twin_pair(name, hebb=False, seed=21, dropout=False)
    jm, variables = nets.hebbax_pair(name, tm, hebb=False)
    out = jax.jit(lambda v, a: jm.apply(v, a, train=False))(
        variables, jnp.asarray(nets.port_input(name, 22)))
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("name", VNETS)
def test_eval_matches_hebbax(name):
    tm, _ = nets.twin_pair(name, hebb=False, seed=21, dropout=False)
    tm.eval()
    with torch.no_grad():
        got = tm(nets.to_t(nets.port_input(name, 22)))
    nets.outputs_close([nets.to_j(o) for o in nets.as_tuple(got)],
                       _hebbax_eval(type(tm).__name__))


@pytest.mark.parametrize("name", ["vnet_s2d"])
def test_training_forward_matches_hebbax(name, no_dropout, monkeypatch):
    rec = DrawRecorder(monkeypatch, module=jcommon)
    tm, _ = nets.twin_pair(name, seed=23, dropout=False)
    jm, variables = nets.hebbax_pair(name, tm)
    x = nets.port_input(name, 24)
    rngs = {"perturb": jax.random.PRNGKey(25)} if "cct" in name else {}
    ref, mut = jax.jit(lambda v, a: jm.apply(
        v, a, train=True, mutable=["batch_stats", "hebb"], rngs=rngs))(
            variables, jnp.asarray(x))
    jax.effects_barrier()
    if "cct" in name:
        rec.install(tm)
    with torch.no_grad():
        got = nets.as_tuple(tm(nets.to_t(x)))
    assert rec.records == []
    nets.outputs_close([nets.to_j(o) for o in got], ref)
    nets.stats_close(nets.stats_of(tm), nets.hebbax_stats(mut))
    nets.deltas_close(pop_deltas(tm), nets.hebbax_deltas(mut, tm))


def test_step_gradients_match_hebbax(no_dropout):
    """``vnet_s2d``: one training step's gradients within 5e-3 of the
    largest (as URPC's in test_torch_s2d_nets.py)."""
    tm, _ = nets.twin_pair("vnet_s2d", hebb=False, seed=26, dropout=False)
    jm, variables = nets.hebbax_pair("vnet_s2d", tm, hebb=False)
    x = nets.port_input("vnet_s2d", 27)

    def loss(params):
        out, _ = jm.apply({**variables, "params": params}, jnp.asarray(x),
                          train=True, mutable=["batch_stats"])
        return jnp.mean(out ** 2)

    jgrads = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(
        variables["params"]))
    ref = nets.bridge.from_flax(jgrads, None, transposed_paths(tm))
    got = nets.port_grads(tm, nets.to_t(x))
    assert set(ref) == set(got)
    scale = max(float(np.abs(r).max()) for r in got.values())
    for k, v in got.items():
        np.testing.assert_allclose(v, np.asarray(ref[k]), rtol=0,
                                   atol=nets.GRAD_TOL_URPC * scale,
                                   err_msg=k)


def test_snapshots_cross_vnet_and_vnet_s2d(tmp_path):
    a = get_network("vnet", 1, 2, generator=torch.Generator().manual_seed(28))
    b = get_network("vnet_s2d", 1, 2)
    for src, dst in ((a, b), (b, a)):
        path = tckpt.save_snapshot(src.state_dict(), str(tmp_path / "s"),
                                   transposed=transposed_paths(src),
                                   **nets.META)
        sd, _ = tckpt.load_state_dict(path, transposed_paths(dst))
        dst.load_state_dict(sd)
    assert all(torch.equal(a.state_dict()[k], v)
               for k, v in b.state_dict().items())
    _, variables = nets.hebbax_pair("vnet_s2d", b, hebb=False)
    p1 = jckpt.save_snapshot(variables, str(tmp_path / "j"), **nets.META)
    p2 = tckpt.save_snapshot(b.state_dict(), str(tmp_path / "t"),
                             transposed=transposed_paths(b), **nets.META)
    with open(p1, "rb") as f1, open(p2, "rb") as f2:
        assert f1.read() == f2.read()
