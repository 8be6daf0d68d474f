"""The ``unet3d_s2d`` names run unfolded: ``hebbax_torch/models/unet3d_s2d.py``
builds them as their ``unet3d`` twins on every device, while hebbax folds
their full-resolution level at (2, 1, 1).  test_torch_s2d_nets.py holds
every name's eval and training outputs, BN statistics and deltas against
hebbax's folded class, and ``unet3d_s2d``'s gradients; here:

* one step's gradient of every parameter of ``unet3d_dtc_s2d`` and
  ``unet3d_cct_s2d`` with its ``_rc``, ``_batched`` and ``_batched_rc``
  variants against hebbax's folded class, at test_torch_s2d_nets.py's
  size (2x32^3, 4 initial features, dropout off, CCT draws replayed from
  hebbax) and bound (2e-4 of the largest |gradient|);
* the pool that replaces hebbax's folded one: the port's ``max_pool`` on
  the unfolded tensor routes each window's cotangent to the voxel that
  hebbax's ``subpixel_max3`` on the folded tensor routes it to (the
  first maximum in (z, y, x) order), exactly, on windows full of ties;
* no name builds a folded module or opens a fold span.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hebbax.models.common as jcommon
import hebbax.ops.s2d3d as js2d3d
from hebbax_torch.hebb.layers import (FoldedHConv3, FoldedHConvTranspose3,
                                      transposed_paths)
from hebbax_torch import bridge
from hebbax_torch.models.common import max_pool
from hebbax_torch.models.unet3d_s2d import FoldedBatchNorm3
from hebbax_torch.utils import trace

from test_torch_deep4 import DrawRecorder
from test_torch_s2d_nets import (GRAD_TOL, as_tuple, hebbax_pair,
                                 port_grads, port_input, to_t, twin_pair)
from test_torch_s2d_nets import no_dropout  # noqa: F401

FOLD = (2, 1, 1)                # hebbax's fold of the full-resolution level

NAMES = ["unet3d_s2d", "unet3d_dtc_s2d", "unet3d_cct_s2d",
         "unet3d_cct_s2d_rc", "unet3d_cct_s2d_batched",
         "unet3d_cct_s2d_batched_rc"]


def tied(pattern, seed=20):
    """An unfolded (N, C, D, H, W) tensor whose 2x2x2 windows hold ties:
    ``relu`` the post-ReLU zeros of a shifted normal, ``levels`` three
    values, ``constant`` one."""
    g = torch.Generator().manual_seed(seed)
    shape = (2, 3, 8, 6, 4)
    if pattern == "relu":
        return torch.relu(torch.randn(shape, generator=g) - 1.5)
    if pattern == "levels":
        return torch.randint(0, 3, shape, generator=g).float()
    return torch.full(shape, 0.5)


def tied_share(x):
    """The share of x's 2x2x2 windows whose maximum is held twice or
    more."""
    n, c, d, h, w = x.shape
    win = x.reshape(n, c, d // 2, 2, h // 2, 2, w // 2, 2).permute(
        0, 1, 2, 4, 6, 3, 5, 7).reshape(n, c, d // 2, h // 2, w // 2, 8)
    top = (win == win.amax(dim=-1, keepdim=True)).sum(dim=-1)
    return float((top > 1).float().mean())


def recorder(name, monkeypatch):
    return DrawRecorder(monkeypatch, module=jcommon) if "cct" in name \
        else None


@pytest.mark.parametrize("name", NAMES[1:])
def test_step_gradients_match_hebbax(name, no_dropout, monkeypatch):
    rec = recorder(name, monkeypatch)
    tm, _ = twin_pair(name, hebb=False, seed=15, dropout=False)
    jm, variables = hebbax_pair(name, tm, hebb=False)
    x = port_input(name, 16)
    rngs = {"perturb": jax.random.PRNGKey(17)} if rec else {}

    def loss(params):
        outs, _ = jm.apply({**variables, "params": params}, jnp.asarray(x),
                           train=True, mutable=["batch_stats"], rngs=rngs)
        return sum(jnp.mean(o ** 2) for o in as_tuple(outs))

    if rec:
        # the draws of one plain training forward, which the gradient's
        # forward repeats from the same key
        jm.apply(variables, jnp.asarray(x), train=True,
                 mutable=["batch_stats"], rngs=rngs)
        jax.effects_barrier()
        draws = list(rec.records)
    jgrads = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(
        variables["params"]))
    if rec:
        jax.effects_barrier()
        rec.records = draws
        rec.install(tm)
    ref = bridge.from_flax(jgrads, None, transposed_paths(tm))
    got = port_grads(tm, to_t(x))
    assert set(ref) == set(got)
    scale = max(float(np.abs(r).max()) for r in got.values())
    for k, v in got.items():
        np.testing.assert_allclose(v, np.asarray(ref[k]), rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=k)


@pytest.mark.parametrize("pattern", ["relu", "levels", "constant"])
def test_pool_routes_tied_windows_as_hebbax(pattern):
    x = tied(pattern)
    assert tied_share(x) > 0.25
    cot = torch.randn((2, 3, 4, 3, 2),
                      generator=torch.Generator().manual_seed(21))
    xt = x.clone().requires_grad_(True)
    y = max_pool(xt)
    (got,) = torch.autograd.grad(y, xt, cot)
    xj = jnp.asarray(np.moveaxis(x.numpy(), 1, -1))

    def pooled(a):
        return js2d3d.subpixel_max3(js2d3d.fold3(a, FOLD), FOLD)

    ref_y, vjp = jax.vjp(pooled, xj)
    (ref,) = vjp(jnp.asarray(np.moveaxis(cot.numpy(), 1, -1)))
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.moveaxis(np.asarray(ref_y), -1, 1))
    assert float((got != 0).sum()) == cot.numel()
    np.testing.assert_array_equal(got.numpy(),
                                  np.moveaxis(np.asarray(ref), -1, 1))


@pytest.mark.parametrize("name", NAMES)
def test_builds_nothing_folded_and_opens_no_fold_span(name):
    tm, _ = twin_pair(name, hebb=False, seed=18, dropout=False)
    folded = (FoldedHConv3, FoldedHConvTranspose3, FoldedBatchNorm3)
    assert not any(isinstance(m, folded) for m in tm.modules())
    trace.reset()
    trace.enable(cuda=False)
    try:
        out = as_tuple(tm(to_t(port_input(name, 19, batch=1))))
        sum(o.square().mean() for o in out).backward()
    finally:
        trace.disable()
    names = {iv[0] for iv in trace.intervals()}
    trace.reset()
    assert "hx.fold" not in names
