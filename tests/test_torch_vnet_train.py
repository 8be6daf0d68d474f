"""Training forwards of the port's ``vnet``, ``vnet_dtc`` and
``vnet_cct`` held against hebbax's on carried weights
(test_torch_vnet.py's ``make_vnet_pair``): batch 2, 32^3, the skip
dropout off in both, VNetCCT with hebbax's perturbation draws replayed by
test_torch_deep4.py's ``DrawRecorder``.  Outputs within 1e-4 of max(1,
max|output|) (train-mode batch norm over the 2^3 bottleneck amplifies
XLA-vs-oneDNN conv rounding; measured 8.5e-6 of scale), batch statistics
rtol 1e-4 / atol 1e-5 (VNetCCT's decoder statistics take four momentum
updates).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hebbax.models.common as jcommon
from hebbax_torch.models.common import CCT_PERTURB_KINDS

from test_torch_3d_model import to_j, to_t
from test_torch_3d_semi_nets import outputs_close, stats_close
from test_torch_deep4 import DrawRecorder
from test_torch_vnet import make_vnet_pair, no_dropout  # noqa: F401

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["vnet", "vnet_dtc"])
def test_train_forward_matches(no_dropout, name):
    jm, variables, tm, x = make_vnet_pair(name, seed=2)
    ref, mut = jax.jit(lambda v, x_: jm.apply(
        v, x_, train=True, mutable=["batch_stats"]))(variables,
                                                     jnp.asarray(x))
    tm.train()
    with torch.no_grad():
        got = tm(to_t(x))
    if name == "vnet":
        got, ref = (got,), (ref,)
    outputs_close(got, ref)
    stats_close(mut["batch_stats"], tm)


def test_cct_train_forward_matches_with_hebbax_draws(no_dropout,
                                                     monkeypatch):
    rec = DrawRecorder(monkeypatch, module=jcommon)
    jm, variables, tm, x = make_vnet_pair("vnet_cct", seed=3)
    ref, mut = jax.jit(lambda v, x_: jm.apply(
        v, x_, train=True, mutable=["batch_stats"],
        rngs={"perturb": jax.random.PRNGKey(6)}))(variables, jnp.asarray(x))
    jax.effects_barrier()
    assert [k for k, _ in rec.records] == list(CCT_PERTURB_KINDS)
    assert all(len(d) == 5 for _, d in rec.records)     # all five levels
    rec.install(tm)
    tm.train()
    with torch.no_grad():
        got = tm(to_t(x))
    assert rec.records == []
    outputs_close(got, ref)                     # main + 3 perturbed passes
    assert not np.allclose(to_j(got[0]), to_j(got[1]))
    # the shared decoder's BN statistics took four momentum updates
    stats_close(mut["batch_stats"], tm)
