"""The port's four folded Hebbian layers (``hebbax_torch/hebb/layers.py``
``FoldedHConv``, ``FoldedHConv3``, ``FoldedHConvTranspose3``,
``FoldedDownHConv3``) held against hebbax's (``hebbax/hebb/layers.py``)
and against the port's own unfolded ``HConv`` / ``HConvTranspose`` on the
same weights and numpy-seeded inputs.

Each case checks the forward and, on a training forward, the Hebbian
delta (swta and hpca on the forward convs; swta_t, hpca_t, swta, hpca and
contrastive on the transpose, its batch permutation injected into both
packages as the reversal).  Tolerances, each the larger of the port's
unfolded-layer tests and hebbax's own s2d tests: outputs within 5e-5 of
max(1, max|y|) (hebbax ``tests/test_unet3d_s2d.py``; the port's unfolded
layers hold 1e-5 / 1e-4); deltas within 2e-3 of each site's largest
|delta| (hebbax ``tests/test_s2d.py`` and ``test_unet3d_s2d.py``; the
port's hold 1e-3).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hebbax.hebb import layers as jl
from hebbax.hebb.spec import HebbSpec as JSpec
from hebbax.ops import s2d as js2d
from hebbax.ops import s2d3d as js3
from hebbax_torch.hebb import kernels
from hebbax_torch.hebb.layers import (FoldedDownHConv3, FoldedHConv,
                                      FoldedHConv3, FoldedHConvTranspose3,
                                      HConv, HConvTranspose)
from hebbax_torch.hebb.spec import HebbSpec
from hebbax_torch.ops import s2d, s2d3d

torch.set_num_threads(2)

OUT_TOL, DELTA_TOL = 5e-5, 2e-3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _j(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _conv_w(w):
    nd = w.ndim - 2
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(w, (nd + 1, nd) + tuple(range(nd)))))


def _tconv_w(w):
    """hebbax's transpose kernel (*k, I, O) -> torch (I, O, *k)."""
    nd = w.ndim - 2
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(w, (nd, nd + 1) + tuple(range(nd)))))


def _spec(mode, cls=HebbSpec):
    return cls(mode=mode, k=50.0, w_nrm=True, alpha=1.0)


def _close(got, ref, tol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


def _delta_close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=DELTA_TOL * float(np.abs(ref).max()))


def _hebbax(jm, x, train):
    """hebbax's params, output and (train) delta for ``jm`` on ``x``."""
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    if not train:
        return variables["params"], jm.apply(variables, jnp.asarray(x),
                                             train=False), None
    y, mut = jm.apply(variables, jnp.asarray(x), train=True,
                      mutable=["hebb"], rngs={"hebb": jax.random.PRNGKey(1)})
    return variables["params"], y, np.asarray(mut["hebb"]["delta"])


def _port(m, x, mode, bias):
    m.spec = _spec(mode)
    with torch.no_grad():
        m.bias.copy_(torch.from_numpy(np.array(bias)))
    m.train()
    with torch.no_grad():
        y = m(x)
    d, m.delta = m.delta, None
    return y, d


@pytest.fixture
def reversed_perm(monkeypatch):
    """The contrastive batch permutation: the reversal, in both."""
    monkeypatch.setattr(jax.random, "permutation",
                        lambda key, n: jnp.arange(n)[::-1])


def _folded_2d(x, groups, depth):
    parts, off = [], 0
    for g in groups:
        p = x[..., off:off + g]
        for _ in range(depth):
            p = js2d.fold(p)
        parts.append(np.asarray(p))
        off += g
    return np.concatenate(parts, -1)


# -- FoldedHConv --------------------------------------------------------------

@pytest.mark.parametrize("mode", ["swta", "hpca"])
@pytest.mark.parametrize("k,groups,depth", [(3, (3,), 1), (3, (3, 4), 1),
                                            (1, (5,), 1), (3, (4,), 2),
                                            (1, (4,), 2)])
def test_folded_hconv_matches_hebbax_and_hconv(mode, k, groups, depth,
                                               monkeypatch):
    rng = np.random.default_rng(k + 10 * depth + len(groups))
    x = rng.standard_normal((2, 16, 16, sum(groups))).astype(np.float32)
    xf = _folded_2d(x, groups, depth)
    jm = jl.FoldedHConv(6, k, groups, depth=depth, hebb=_spec(mode, JSpec))
    params, ref, ref_d = _hebbax(jm, xf, True)
    params = jax.tree_util.tree_map(np.asarray, params)
    params["bias"] = rng.standard_normal(6).astype(np.float32) * 0.1
    ref, mut = jm.apply({"params": params}, jnp.asarray(xf), train=True,
                        mutable=["hebb"])
    ref_d = np.asarray(mut["hebb"]["delta"])

    calls = []
    orig = kernels.swta_delta
    monkeypatch.setattr(kernels, "swta_delta",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    tm = FoldedHConv(groups, 6, k, depth=depth)
    with torch.no_grad():
        tm.weight.copy_(_conv_w(params["kernel"]))
    y, d = _port(tm, _t(xf), mode, params["bias"])
    _close(_j(y), ref, OUT_TOL)
    _delta_close(d.numpy(), np.transpose(ref_d, (3, 2, 0, 1)))
    # an swta site reaches the dispatcher (the CUDA kernel on the card)
    assert len(calls) == (mode == "swta")

    # against the port's unfolded HConv on the unfolded input
    hm = HConv(sum(groups), 6, k, padding=k // 2)
    hm.load_state_dict(tm.state_dict())
    hy, hd = _port(hm, _t(x), mode, params["bias"])
    yu = y
    for _ in range(depth):
        yu = s2d.unfold(yu)
    _close(yu.numpy(), hy.numpy(), OUT_TOL)
    _delta_close(d.numpy(), hd.numpy())


@pytest.mark.parametrize("mode", ["swta", "hpca"])
@pytest.mark.parametrize("groups", [(3,), (3, 4)])
def test_folded_delta_env_matches_hebbax(mode, groups, monkeypatch):
    """``HEBBAX_S2D_FOLDED_DELTA``: the folded-layout weight gradient,
    read at the call, in both packages; it agrees with the unfolded
    rule."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 16, sum(groups))).astype(np.float32)
    xf = _folded_2d(x, groups, 1)
    jm = jl.FoldedHConv(6, 3, groups, hebb=_spec(mode, JSpec))
    params, _, plain_ref = _hebbax(jm, xf, True)
    monkeypatch.setenv("HEBBAX_S2D_FOLDED_DELTA", "1")
    _, ref, ref_d = _hebbax(jm, xf, True)
    tm = FoldedHConv(groups, 6, 3)
    with torch.no_grad():
        tm.weight.copy_(_conv_w(np.asarray(params["kernel"])))
    y, d = _port(tm, _t(xf), mode, params["bias"])
    _close(_j(y), ref, OUT_TOL)
    _delta_close(d.numpy(), np.transpose(ref_d, (3, 2, 0, 1)))
    _delta_close(d.numpy(), np.transpose(plain_ref, (3, 2, 0, 1)))
    monkeypatch.delenv("HEBBAX_S2D_FOLDED_DELTA")
    _, plain = _port(tm, _t(xf), mode, params["bias"])
    _delta_close(d.numpy(), plain.numpy())


def test_folded_layers_refuse_other_modes():
    x = torch.zeros(2, 12, 8, 8)
    tm = FoldedHConv((3,), 4, 3)
    tm.spec = _spec("contrastive")
    tm.train()
    with pytest.raises(NotImplementedError, match="swta/hpca"):
        tm(x)
    t3 = FoldedHConv3((3,), 4, 3, (2, 2, 2))
    t3.spec = _spec("contrastive")
    t3.train()
    with pytest.raises(NotImplementedError, match="swta/hpca"):
        t3(torch.zeros(1, 24, 4, 4, 4))
    td = FoldedDownHConv3((3,), 4)
    td.spec = _spec("contrastive")
    td.train()
    with pytest.raises(NotImplementedError, match="swta/hpca"):
        td(torch.zeros(1, 24, 4, 4, 4))
    tm.depth, tm.in_groups = 2, (1, 2)
    tm.spec = _spec("swta")
    with pytest.raises(NotImplementedError, match="single-group"):
        tm(torch.zeros(2, 48, 4, 4))


# -- FoldedHConv3 -------------------------------------------------------------

@pytest.mark.parametrize("mode", ["swta", "hpca"])
@pytest.mark.parametrize("k,f,groups,out_groups", [
    (3, (2, 1, 1), (2, 3), None), (3, (2, 2, 2), (4,), None),
    (5, (2, 2, 2), (2, 2), (2, 3)), (5, (2, 2, 1), (3,), None),
    (1, (2, 2, 2), (4,), None)])
def test_folded_hconv3_matches_hebbax_and_hconv(mode, k, f, groups,
                                                out_groups):
    rng = np.random.default_rng(k + sum(f))
    x = rng.standard_normal((2, 8, 8, 8, sum(groups))).astype(np.float32)
    parts, off = [], 0
    for g in groups:
        parts.append(np.asarray(js3.fold3(x[..., off:off + g], f)))
        off += g
    xf = np.concatenate(parts, -1)
    jm = jl.FoldedHConv3(5, k, groups, fold=f, out_groups=out_groups,
                         hebb=_spec(mode, JSpec))
    params, _, _ = _hebbax(jm, xf, False)
    params = jax.tree_util.tree_map(np.asarray, params)
    params["bias"] = rng.standard_normal(5).astype(np.float32) * 0.1
    ref, mut = jm.apply({"params": params}, jnp.asarray(xf), train=True,
                        mutable=["hebb"])
    tm = FoldedHConv3(groups, 5, k, f, out_groups=out_groups)
    with torch.no_grad():
        tm.weight.copy_(_conv_w(params["kernel"]))
    y, d = _port(tm, _t(xf), mode, params["bias"])
    _close(_j(y), ref, OUT_TOL)
    _delta_close(d.numpy(), np.transpose(np.asarray(mut["hebb"]["delta"]),
                                         (4, 3, 0, 1, 2)))

    hm = HConv(sum(groups), 5, (k, k, k), padding=k // 2)
    hm.load_state_dict(tm.state_dict())
    hy, hd = _port(hm, _t(x), mode, params["bias"])
    want = (s2d3d.fold3(hy, f) if out_groups is None else torch.cat(
        [s2d3d.fold3(hy[:, :out_groups[0]], f),
         s2d3d.fold3(hy[:, out_groups[0]:], f)], 1))
    _close(y.numpy(), want.numpy(), OUT_TOL)
    _delta_close(d.numpy(), hd.numpy())


# -- FoldedHConvTranspose3 ----------------------------------------------------

@pytest.mark.parametrize("mode", ["swta_t", "hpca_t", "swta", "hpca",
                                  "contrastive"])
@pytest.mark.parametrize("f", [(2, 1, 1), (2, 2, 2)])
def test_folded_hconv_transpose3_matches_hebbax_and_hconv(mode, f,
                                                          reversed_perm):
    rng = np.random.default_rng(7 + sum(f))
    x = rng.standard_normal((2, 4, 4, 4, 6)).astype(np.float32)
    jm = jl.FoldedHConvTranspose3(5, fold=f, hebb=_spec(mode, JSpec))
    params, _, _ = _hebbax(jm, x, False)
    params = jax.tree_util.tree_map(np.asarray, params)
    params["bias"] = rng.standard_normal(5).astype(np.float32) * 0.1
    ref, mut = jm.apply({"params": params}, jnp.asarray(x), train=True,
                        mutable=["hebb"], rngs={"hebb": jax.random.PRNGKey(2)})
    tm = FoldedHConvTranspose3(6, 5, f)
    with torch.no_grad():
        tm.weight.copy_(_tconv_w(params["kernel"]))
    flip = lambda n: torch.arange(n).flip(0)              # noqa: E731
    tm.draw_permutation = flip
    y, d = _port(tm, _t(x), mode, params["bias"])
    _close(_j(y), ref, OUT_TOL)
    _delta_close(d.numpy(), np.transpose(np.asarray(mut["hebb"]["delta"]),
                                         (3, 4, 0, 1, 2)))

    hm = HConvTranspose(6, 5, (2, 2, 2), stride=2)
    hm.load_state_dict(tm.state_dict())
    hm.draw_permutation = flip
    hy, hd = _port(hm, _t(x), mode, params["bias"])
    _close(y.numpy(), s2d3d.fold3(hy, f).numpy(), OUT_TOL)
    _delta_close(d.numpy(), hd.numpy())


# -- FoldedDownHConv3 ---------------------------------------------------------

@pytest.mark.parametrize("mode", ["swta", "hpca"])
@pytest.mark.parametrize("f,groups", [((2, 2, 2), (4,)),
                                      ((2, 2, 2), (2, 3)),
                                      ((2, 1, 1), (3,))])
def test_folded_down_hconv3_matches_hebbax_and_hconv(mode, f, groups):
    rng = np.random.default_rng(11 + len(groups))
    x = rng.standard_normal((2, 8, 8, 8, sum(groups))).astype(np.float32)
    parts, off = [], 0
    for g in groups:
        parts.append(np.asarray(js3.fold3(x[..., off:off + g], f)))
        off += g
    xf = np.concatenate(parts, -1)
    jm = jl.FoldedDownHConv3(5, fold=f, in_groups=groups,
                             hebb=_spec(mode, JSpec))
    params, _, _ = _hebbax(jm, xf, False)
    params = jax.tree_util.tree_map(np.asarray, params)
    params["bias"] = rng.standard_normal(5).astype(np.float32) * 0.1
    ref, mut = jm.apply({"params": params}, jnp.asarray(xf), train=True,
                        mutable=["hebb"])
    tm = FoldedDownHConv3(groups, 5, f)
    with torch.no_grad():
        tm.weight.copy_(_conv_w(params["kernel"]))
    y, d = _port(tm, _t(xf), mode, params["bias"])
    _close(_j(y), ref, OUT_TOL)
    _delta_close(d.numpy(), np.transpose(np.asarray(mut["hebb"]["delta"]),
                                         (4, 3, 0, 1, 2)))

    hm = HConv(sum(groups), 5, (2, 2, 2), stride=2)
    hm.load_state_dict(tm.state_dict())
    hy, hd = _port(hm, _t(x), mode, params["bias"])
    _close(y.numpy(), hy.numpy(), OUT_TOL)
    _delta_close(d.numpy(), hd.numpy())


def test_folded_layers_keep_hconv_parameters():
    """The original weight shapes and names: the state dicts are the
    unfolded layers'."""
    pairs = [(FoldedHConv((3, 4), 6, 3), HConv(7, 6, 3, padding=1)),
             (FoldedHConv3((2, 3), 5, 5, (2, 2, 2), out_groups=(2, 3)),
              HConv(5, 5, (5, 5, 5), padding=2)),
             (FoldedHConvTranspose3(6, 5, (2, 1, 1)),
              HConvTranspose(6, 5, (2, 2, 2), stride=2)),
             (FoldedDownHConv3((4,), 8), HConv(4, 8, (2, 2, 2), stride=2))]
    for folded, plain in pairs:
        a, b = folded.state_dict(), plain.state_dict()
        assert {k: v.shape for k, v in a.items()} == {
            k: v.shape for k, v in b.items()}
        assert isinstance(folded, type(plain))
