"""Every Hebbian rule of the port held against ``hebbax.hebb.rules`` on
random tensors from a numpy seed, in 2D and 3D: hpca on forward convs
(stride 1 and strided, with and without a Sanger chunk), hpca_t (chunked
and unchunked), swta and hpca on transpose convs (x and y swapped),
strided forward swta through the dispatcher, and contrastive with and
without uniformity, on forward and transpose convs, with hebbax's
permutation injected; then ``compute_delta``'s routing, the dispatcher's
stride gate, and a contrastive HConv inside an outer autograd graph.

hebbax is channels-last with kernels ``(*k, I, O)``; the port is
channels-first with torch's ``(O, I, *k)`` conv and ``(I, O, *k)``
transpose-conv weights.

Tolerance: max|err| <= 1e-5 * max|hebbax delta|, as in
``tests/test_torch_3d_rules.py`` (float32 sums over the voxels of the
batch, taken by XLA and oneDNN in other orders).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from hebbax.hebb import rules as jrules
from hebbax.hebb.spec import HebbSpec as JSpec
from hebbax_torch.hebb import kernels
from hebbax_torch.hebb import rules as trules
from hebbax_torch.hebb.layers import HConv, HConvTranspose
from hebbax_torch.hebb.spec import HebbSpec

torch.set_num_threads(2)

K = 50.0
TOL = 1e-5


def _fwd_perm(nd):
    """flax (*k, I, O) -> torch (O, I, *k)."""
    return (nd + 1, nd) + tuple(range(nd))


def _tr_perm(nd):
    """flax (*k, I, O) -> torch (I, O, *k) of a transpose conv."""
    return (nd, nd + 1) + tuple(range(nd))


def _cf(nd):
    """channels-last -> channels-first activations."""
    return (0, nd + 1) + tuple(range(1, nd + 1))


def _t(a, perm):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, perm)))


def _jit(fn, *arrays):
    """hebbax's ``fn`` of the numpy ``arrays``, jitted: one compile costs
    less than op-by-op dispatch on the CPU (3.9 s -> 0.4 s for a
    contrastive delta)."""
    return np.asarray(jax.jit(fn)(*[jnp.asarray(a) for a in arrays]))


def _close(got, ref, perm, tol=TOL):
    """got (torch layout) against ref (flax layout), within tol of
    max|ref|."""
    ref = np.asarray(ref)
    got = np.transpose(got.detach().numpy(), np.argsort(perm))
    err = float(np.abs(got - ref).max())
    assert err <= tol * float(np.abs(ref).max()), err


def _fwd_case(nd, n, s, i, o, k, stride, seed):
    """(w, x, y, padding) in flax layout for a forward conv with padding
    k // 2 and the given stride; y is the conv of x (so hpca's Gram is of
    real outputs)."""
    rng = np.random.default_rng(seed)
    shape = (s, s + 1, s + 2)[:nd]
    x = rng.standard_normal((n,) + shape + (i,)).astype(np.float32)
    w = (0.3 * rng.standard_normal((k,) * nd + (i, o))).astype(np.float32)
    p = k // 2
    y = _jit(lambda x_, w_: jrules.conv_fwd(x_, w_, (stride,) * nd,
                                            ((p, p),) * nd), x, w)
    return w, x, y, p


def _tr_case(nd, n, q, i, o, k, s, seed):
    """(w, x, y) in flax layout for a transpose conv: y its output."""
    rng = np.random.default_rng(seed)
    shape = (q, q + 1, q)[:nd]
    x = rng.standard_normal((n,) + shape + (i,)).astype(np.float32)
    w = (0.3 * rng.standard_normal((k,) * nd + (i, o))).astype(np.float32)
    y = _jit(lambda x_, w_: jrules.conv_transpose_fwd(x_, w_, (s,) * nd),
             x, w)
    return w, x, y


# -- hpca on forward convs ---------------------------------------------------

@pytest.mark.parametrize("nd,n,s,i,o,k,stride,chunk", [
    (2, 2, 8, 3, 5, 3, 1, None), (2, 2, 8, 4, 6, 2, 2, None),
    (2, 3, 7, 4, 6, 3, 2, 4), (3, 2, 6, 2, 4, 3, 1, None),
    (3, 1, 6, 3, 6, 2, 2, None), (3, 2, 6, 2, 9, 3, 1, 4)])
def test_hpca_conv_delta_matches(nd, n, s, i, o, k, stride, chunk):
    w, x, y, p = _fwd_case(nd, n, s, i, o, k, stride, seed=nd * 10 + k)
    ref = _jit(lambda *a: jrules.hpca_conv_delta(
        *a, (stride,) * nd, chunk=chunk, padding=((p, p),) * nd), w, x, y)
    got = trules.hpca_conv_delta(_t(w, _fwd_perm(nd)), _t(x, _cf(nd)),
                                 _t(y, _cf(nd)), p, stride, chunk=chunk)
    assert got.dtype == torch.float32
    _close(got, ref, _fwd_perm(nd))


def test_sanger_tril_chunk_is_block_diagonal():
    for o, chunk in ((6, None), (7, 3), (40, 32)):
        ref = np.asarray(jrules._sanger_tril(o, jnp.float32, chunk))
        np.testing.assert_array_equal(trules.sanger_tril(o, chunk=chunk)
                                      .numpy(), ref)
    t = trules.sanger_tril(40, chunk=32).numpy()
    assert t[31, 0] == 1 and t[32, 0] == 0 and t[33, 32] == 1


# -- hpca_t -------------------------------------------------------------------

@pytest.mark.parametrize("nd,n,q,i,o,k,s,chunk", [
    (2, 2, 4, 5, 3, 2, 2, None), (2, 2, 4, 4, 6, 3, 2, 4),
    (3, 2, 3, 4, 3, 2, 2, None), (3, 1, 3, 3, 6, 2, 2, 4),
    (3, 2, 3, 4, 5, 3, 2, 2)])
def test_hpca_t_delta_matches(nd, n, q, i, o, k, s, chunk):
    w, x, y = _tr_case(nd, n, q, i, o, k, s, seed=q * 7 + o)
    ref = _jit(lambda *a: jrules.hpca_t_delta(*a, (s,) * nd, chunk=chunk),
               w, x, y)
    got = trules.hpca_t_delta(_t(w, _tr_perm(nd)), _t(x, _cf(nd)),
                              _t(y, _cf(nd)), s, chunk=chunk)
    _close(got, ref, _tr_perm(nd))


def test_strided_grams_match_hebbax():
    w, x, y = _tr_case(3, 2, 3, 2, 4, 3, 2, seed=1)
    ref = jrules._strided_patches_m(jnp.asarray(y), x.shape, (3, 3, 3),
                                    (2, 2, 2))
    got = trules.strided_grams(_t(y, _cf(3)), x.shape[1:4], (3, 3, 3),
                               (2, 2, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))


# -- swta / hpca on transpose convs (x and y swapped) ------------------------

def test_transpose_weight_is_the_forward_weight_from_y_to_x():
    """The claim the swapped rules rest on: a transpose conv's (I, O, *k)
    weight is the (out, in, *k) weight of the forward conv from y to x
    with the same stride and no padding — the two are adjoint."""
    rng = np.random.default_rng(0)
    for nd, conv, tconv in ((2, F.conv2d, F.conv_transpose2d),
                            (3, F.conv3d, F.conv_transpose3d)):
        w = torch.from_numpy(rng.standard_normal(
            (4, 3) + (2,) * nd).astype(np.float64))
        x = torch.from_numpy(rng.standard_normal(
            (2, 4) + (3,) * nd).astype(np.float64))
        y = torch.from_numpy(rng.standard_normal(
            (2, 3) + (6,) * nd).astype(np.float64))
        lhs = torch.sum(tconv(x, w, stride=2) * y)
        rhs = torch.sum(x * conv(y, w, stride=2))
        assert conv(y, w, stride=2).shape == x.shape
        assert abs(float(lhs - rhs)) <= 1e-12 * abs(float(lhs))


@pytest.mark.parametrize("mode", ["swta", "hpca"])
@pytest.mark.parametrize("nd,n,q,i,o,k,s", [
    (2, 2, 4, 5, 3, 2, 2), (2, 2, 5, 4, 6, 3, 1), (2, 1, 4, 3, 4, 3, 2),
    (3, 2, 3, 4, 3, 2, 2), (3, 1, 3, 3, 5, 3, 2)])
def test_swapped_transpose_rules_match(mode, nd, n, q, i, o, k, s):
    w, x, y = _tr_case(nd, n, q, i, o, k, s, seed=q * 5 + i + nd)
    spec = dict(mode=mode, k=K)
    ref = _jit(lambda *a: jrules.compute_delta(JSpec(**spec), *a,
                                               (s,) * nd, True), w, x, y)
    wt = _t(w, _tr_perm(nd))
    xt, yt = _t(x, _cf(nd)), _t(y, _cf(nd))
    before = kernels.SWTA_DELTA.launches
    got = trules.compute_delta(HebbSpec(**spec), wt, xt, yt, 0, True, s)
    assert kernels.SWTA_DELTA.launches == before
    _close(got, ref, _tr_perm(nd))
    # the stored weight, no transposition: the forward rule from y to x
    if mode == "swta":
        direct = trules.swta_wgrad_delta(wt, yt, xt, K, 0, s)
    else:
        direct = trules.hpca_conv_delta(wt, yt, xt, 0, s)
    assert torch.equal(got, direct)


# -- strided forward swta ----------------------------------------------------

@pytest.mark.parametrize("nd,n,s,i,o,k,stride", [
    (2, 2, 8, 3, 5, 2, 2), (2, 2, 9, 4, 6, 3, 2), (3, 2, 6, 2, 4, 2, 2),
    (3, 1, 7, 3, 5, 3, 2)])
def test_strided_swta_through_the_dispatcher_matches(nd, n, s, i, o, k,
                                                     stride):
    w, x, y, p = _fwd_case(nd, n, s, i, o, k, stride, seed=s + k)
    y = (0.2 * y).astype(np.float32)
    ref = _jit(lambda *a: jrules.swta_conv_delta(
        *a, K, (stride,) * nd, padding=((p, p),) * nd), w, x, y)
    wt, xt, yt = _t(w, _fwd_perm(nd)), _t(x, _cf(nd)), _t(y, _cf(nd))
    before = kernels.SWTA_DELTA.launches
    got = kernels.swta_delta(wt, xt, yt, K, (p,) * nd, stride)
    assert kernels.SWTA_DELTA.launches == before
    assert torch.equal(got, trules.swta_wgrad_delta(wt, xt, yt, K, p,
                                                    stride))
    _close(got, ref, _fwd_perm(nd))


def test_dispatcher_sends_no_strided_2d_site_to_the_plain_version(
        monkeypatch):
    """The stride and shape gate comes before the device: a strided (or
    VALID stride-1) 2D call goes to the composed rule, never to K1's
    plain version — so never to K1 on the card (tests/test_torch_kernels.py
    holds the card's launch count)."""
    def forbidden(*a, **kw):
        raise AssertionError("a strided 2D site reached K1's plain version")

    torch.manual_seed(3)
    w, x, y, p = _fwd_case(2, 2, 8, 3, 4, 2, 2, seed=3)
    wt, xt, yt = _t(w, _fwd_perm(2)), _t(x, _cf(2)), _t(y, _cf(2))
    monkeypatch.setattr(trules, "swta_conv_delta", forbidden)
    got = kernels.swta_delta(wt, xt, yt, K, (p, p), (2, 2))
    assert torch.equal(got, trules.swta_wgrad_delta(wt, xt, yt, K, p, 2))
    # a VALID stride-1 site (a swapped k=3, s=1 transpose conv) likewise
    yv = torch.randn(2, 4, 6, 7)
    w3 = torch.randn(4, 3, 3, 3)
    got = kernels.swta_delta(w3, xt, yv, K, (0, 0), 1)
    assert torch.equal(got, trules.swta_wgrad_delta(w3, xt, yv, K, 0, 1))
    # a same-size stride-1 2D CPU site still takes the plain version
    with pytest.raises(AssertionError, match="plain version"):
        kernels.swta_delta(w3, xt, torch.randn(2, 4, 8, 9), K, (1, 1), 1)


# -- contrastive --------------------------------------------------------------

def _jax_perm(seed, n):
    key = jax.random.PRNGKey(seed)
    return key, np.array(jax.random.permutation(key, n))


@pytest.mark.parametrize("uniformity", [False, True])
@pytest.mark.parametrize("nd,n,s,i,o,k,stride,w_nrm,contrast", [
    (2, 2, 8, 3, 5, 3, 1, True, 1.0), (2, 3, 8, 4, 6, 3, 1, True, 0.5),
    (2, 3, 8, 3, 4, 2, 2, False, 1.0), (3, 2, 6, 2, 4, 3, 1, True, 1.0),
    (3, 3, 6, 3, 4, 2, 2, True, 0.7)])
def test_contrastive_forward_matches(uniformity, nd, n, s, i, o, k, stride,
                                     w_nrm, contrast):
    w, x, _, p = _fwd_case(nd, n, s, i, o, k, stride, seed=n * 3 + s)
    bias = (0.1 * np.random.default_rng(9).standard_normal(o)).astype(
        np.float32)
    key, perm = _jax_perm(n + s, n)
    ref = _jit(lambda w_, x_, k_, b_: jrules.contrastive_delta(
        w_, x_, k_, (stride,) * nd, False, w_nrm, contrast, uniformity, b_,
        padding=((p, p),) * nd), w, x, key, bias)
    got = trules.contrastive_delta(
        _t(w, _fwd_perm(nd)), _t(x, _cf(nd)), torch.from_numpy(perm),
        stride, p, False, w_nrm, contrast, uniformity,
        torch.from_numpy(bias))
    _close(got, ref, _fwd_perm(nd))


@pytest.mark.parametrize("uniformity", [False, True])
@pytest.mark.parametrize("nd,n,q,i,o,k,s", [
    (2, 2, 4, 5, 3, 2, 2), (2, 3, 4, 4, 6, 3, 2), (3, 2, 3, 4, 3, 2, 2),
    (3, 1, 3, 3, 4, 2, 2)])
def test_contrastive_transpose_matches(uniformity, nd, n, q, i, o, k, s):
    w, x, _ = _tr_case(nd, n, q, i, o, k, s, seed=q + o + nd)
    bias = (0.1 * np.random.default_rng(8).standard_normal(o)).astype(
        np.float32)
    key, perm = _jax_perm(q * n, n)
    ref = _jit(lambda w_, x_, k_, b_: jrules.contrastive_delta(
        w_, x_, k_, (s,) * nd, True, True, 1.0, uniformity, b_), w, x, key,
        bias)
    got = trules.contrastive_delta(
        _t(w, _tr_perm(nd)), _t(x, _cf(nd)), torch.from_numpy(perm), s, 0,
        True, True, 1.0, uniformity, torch.from_numpy(bias))
    _close(got, ref, _tr_perm(nd))


def test_contrastive_at_batch_one_is_the_positive_term_scaled():
    """At batch 1 (the 3D sweeps) the permutation is the identity, so the
    objective is (contrast - 1) x the positive term: at contrast 1 the
    delta vanishes, at 0 it is the positive term alone."""
    w, x, _, p = _fwd_case(3, 1, 6, 2, 4, 3, 1, seed=2)
    args = (_t(w, _fwd_perm(3)), _t(x, _cf(3)), torch.zeros(1,
                                                            dtype=torch.long),
            1, p, False, True)
    pos = trules.contrastive_delta(*args, contrast=0.0)
    assert float(pos.abs().max()) > 0
    half = trules.contrastive_delta(*args, contrast=0.5)
    torch.testing.assert_close(half, 0.5 * pos, rtol=1e-5,
                               atol=1e-6 * float(pos.abs().max()))
    zero = trules.contrastive_delta(*args, contrast=1.0)
    assert float(zero.abs().max()) <= 1e-6 * float(pos.abs().max())


def test_neighborhood_sum_matches_hebbax():
    rng = np.random.default_rng(4)
    for nd in (2, 3):
        y = rng.standard_normal((2,) + (5, 6, 4)[:nd] + (3,)).astype(
            np.float32)
        ref = jrules._neighborhood_sum(jnp.asarray(y))
        got = trules.neighborhood_sum(_t(y, _cf(nd)))
        np.testing.assert_allclose(
            np.transpose(got.numpy(), np.argsort(_cf(nd))), np.asarray(ref),
            rtol=1e-6, atol=1e-6)


def test_contrastive_layer_leaves_no_trace_in_the_outer_graph():
    """Inside a training forward that records a graph (the excluded
    head's backward), a contrastive HConv's delta is taken on its own
    detached copy: the delta carries no graph, and the outer backward
    gives the weight and the input exactly the grads of the conv's own
    forward."""
    torch.manual_seed(0)
    conv = HConv(3, 4, 3, padding=1)
    conv.spec = HebbSpec(mode="contrastive")
    conv.draw_permutation = lambda n: torch.tensor([1, 0])
    x = torch.randn(2, 3, 6, 6, requires_grad=True)
    conv.train()
    y = conv(x)
    assert conv.delta is not None and conv.delta.grad_fn is None
    assert not conv.delta.requires_grad and conv.weight.grad is None
    (y * y).sum().backward()
    w = conv.weight.detach().clone().requires_grad_(True)
    x2 = x.detach().clone().requires_grad_(True)
    plain = F.conv2d(x2, trules.normalize(w, (1, 2, 3)), conv.bias.detach(),
                     padding=1)
    gw, gx = torch.autograd.grad((plain * plain).sum(), [w, x2])
    assert torch.equal(conv.weight.grad, gw) and torch.equal(x.grad, gx)
    ref = trules.contrastive_delta(conv.weight, x.detach(),
                                   torch.tensor([1, 0]), 1, 1, False, True,
                                   bias=conv.bias)
    assert torch.equal(conv.delta, ref)


# -- compute_delta ------------------------------------------------------------

MODES = ("swta", "hpca", "swta_t", "hpca_t", "contrastive")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("transpose", [False, True])
def test_compute_delta_matches_hebbax(mode, nd, transpose):
    """Every mode hebbax serves, on both kinds of conv, against hebbax's
    own ``compute_delta`` (its routing included: the 3D hpca_t chunk, no
    chunk for hpca, the swap on transpose convs)."""
    o = 40 if (nd == 3 and mode.startswith("hpca")) else 5
    if transpose:
        w, x, y = _tr_case(nd, 2, 3, 3, o, 2, 2, seed=o + nd)
        y = (0.2 * y).astype(np.float32)
        pad, perm_w, stride = 0, _tr_perm(nd), 2
        jpad = None
    else:
        w, x, y, pad = _fwd_case(nd, 2, 5, 3, o, 3, 1, seed=o + nd)
        y = (0.2 * y).astype(np.float32)
        perm_w, stride = _fwd_perm(nd), 1
        jpad = ((pad, pad),) * nd
    bias = np.linspace(-0.1, 0.1, o).astype(np.float32)
    key, perm = _jax_perm(7, 2)
    spec = dict(mode=mode, k=K)
    ref = _jit(lambda w_, x_, y_, k_, b_: jrules.compute_delta(
        JSpec(**spec), w_, x_, y_, (stride,) * nd, transpose, key=k_,
        bias=b_, padding=jpad), w, x, y, key, bias)
    got = trules.compute_delta(HebbSpec(**spec), _t(w, perm_w),
                               _t(x, _cf(nd)), _t(y, _cf(nd)), pad,
                               transpose, stride,
                               bias=torch.from_numpy(bias),
                               perm=torch.from_numpy(perm))
    _close(got, ref, perm_w)


def test_compute_delta_chunks_only_3d_hpca_t():
    """hebbax chunks only the 3D transpose hpca_t's Sanger tril
    (``hebbax/hebb/rules.py:416,426,434-436``): the 3D forward hpca and
    the 2D hpca_t take none."""
    spec = HebbSpec(mode="hpca_t")
    w, x, y = _tr_case(3, 1, 3, 2, 40, 2, 2, seed=1)
    wt, xt, yt = _t(w, _tr_perm(3)), _t(x, _cf(3)), _t(y, _cf(3))
    got = trules.compute_delta(spec, wt, xt, yt, 0, True, 2)
    assert torch.equal(got, trules.hpca_t_delta(wt, xt, yt, 2, chunk=32))
    assert not torch.equal(got, trules.hpca_t_delta(wt, xt, yt, 2))
    w, x, y, p = _fwd_case(3, 1, 4, 2, 40, 3, 1, seed=2)
    wf, xf, yf = _t(w, _fwd_perm(3)), _t(x, _cf(3)), _t(y, _cf(3))
    got = trules.compute_delta(spec, wf, xf, yf, p, False, 1)
    assert torch.equal(got, trules.hpca_conv_delta(wf, xf, yf, p, 1))
    assert not torch.equal(got, trules.hpca_conv_delta(wf, xf, yf, p, 1,
                                                       chunk=32))
    w2, x2, y2 = _tr_case(2, 1, 3, 2, 40, 2, 2, seed=3)
    w2, x2, y2 = _t(w2, _tr_perm(2)), _t(x2, _cf(2)), _t(y2, _cf(2))
    assert torch.equal(trules.compute_delta(spec, w2, x2, y2, 0, True, 2),
                       trules.hpca_t_delta(w2, x2, y2, 2))


def test_compute_delta_raises_only_for_patchwise_false():
    w, x, y, p = _fwd_case(2, 2, 5, 3, 4, 3, 1, seed=0)
    args = (_t(w, _fwd_perm(2)), _t(x, _cf(2)), _t(y, _cf(2)), p)
    for mode in MODES:
        trules.compute_delta(HebbSpec(mode=mode), *args,
                             perm=torch.tensor([1, 0]))
        with pytest.raises(NotImplementedError, match="patchwise"):
            trules.compute_delta(HebbSpec(mode=mode, patchwise=False), *args)
    with pytest.raises(NotImplementedError, match="unavailable"):
        trules.compute_delta(HebbSpec(mode="oja"), *args)


def test_hconv_transpose_routes_every_mode():
    """An HConvTranspose computes a delta under every mode (swta / hpca
    swapped), an HConv with a stride passes it to its rule."""
    torch.manual_seed(1)
    x = torch.randn(2, 4, 3, 3, 3)
    for mode in MODES:
        up = HConvTranspose(4, 3, (2, 2, 2), stride=2)
        up.spec = HebbSpec(mode=mode, k=K)
        up.draw_permutation = lambda n: torch.arange(n).flip(0)
        up.train()
        y = up(x)
        assert y.shape == (2, 3, 6, 6, 6) and up.delta.shape == (4, 3, 2, 2,
                                                                2)
        down = HConv(3, 4, (2, 2, 2), stride=2)
        down.spec = HebbSpec(mode=mode, k=K)
        down.draw_permutation = lambda n: torch.arange(n).flip(0)
        down.train()
        assert down(y).shape == (2, 4, 3, 3, 3)
        assert down.delta.shape == (4, 3, 2, 2, 2)
        assert bool(torch.isfinite(down.delta).all())


def test_contrastive_is_nan_on_a_zeroed_region():
    """hebbax's behaviour, reproduced: where an output voxel's channel
    vector is exactly zero (a neighbourhood of zero input, the converted
    bias frozen at its zero init — what a CCT feature-dropout perturbation
    gives), ``normalize``'s zero-norm guard still differentiates sqrt at
    0, and the contrastive delta is NaN in both packages."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 12, 4)).astype(np.float32)
    x[:, 2:9, 2:9, :] = 0.0
    w = (0.1 * rng.standard_normal((3, 3, 4, 6))).astype(np.float32)
    key, perm = _jax_perm(3, 2)
    ref = jrules.contrastive_delta(
        jnp.asarray(w), jnp.asarray(x), key, (1, 1), False, True, 1.0,
        False, jnp.zeros(6), padding=((1, 1), (1, 1)))
    got = trules.contrastive_delta(
        _t(w, _fwd_perm(2)), _t(x, _cf(2)), torch.from_numpy(perm), 1, 1,
        False, True, bias=torch.zeros(6))
    assert bool(jnp.isnan(ref).any()) and bool(torch.isnan(got).any())
    np.testing.assert_array_equal(
        np.isnan(np.transpose(got.numpy(), np.argsort(_fwd_perm(2)))),
        np.isnan(np.asarray(ref)))
