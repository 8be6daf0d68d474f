"""The port's space-to-depth ops (``hebbax_torch/ops/s2d.py`` and
``s2d3d.py``) held against hebbax's ``hebbax/ops/s2d.py`` / ``s2d3d.py``
on numpy-seeded inputs.

Layouts: hebbax is channels-last with kernels ``(*k, I, O)``, the port
channels-first with ``(O, I, *k)`` (a transpose conv's ``(I, O, *k)``);
each comparison transposes.  Tolerances: the folds, the folded kernels,
the biases, the permutations and the max pools are gathers, so they are
held EXACTLY; the weight-gradient maps sum up to 8 slots per weight in
another order than hebbax's einsum (float32 atol 2e-5, hebbax's own
``tests/test_s2d3d.py`` bound; the port's unfolded ops carry no wider
one); the folded convs against the unfolded ones within 3e-5 of
max(1, max|conv|) (hebbax's ``tests/test_s2d3d.py`` k=5 bound, the
larger, on outputs of unit scale; the normal inputs here reach 30).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from hebbax.ops import s2d as js2d
from hebbax.ops import s2d3d as js3
from hebbax_torch.models.common import resize_linear_align_corners
from hebbax_torch.ops import s2d, s2d3d

torch.set_num_threads(2)

FOLDS = [(2, 2, 2), (2, 1, 1), (2, 2, 1), (1, 2, 2), (1, 1, 1)]


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _conv_w(w):
    """hebbax (*k, I, O) -> torch (O, I, *k)."""
    nd = w.ndim - 2
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(w, (nd + 1, nd) + tuple(range(nd)))))


def _from_conv_w(t):
    nd = t.dim() - 2
    return np.transpose(t.detach().numpy(), tuple(range(2, nd + 2)) + (1, 0))


def _rng(seed):
    return np.random.default_rng(seed)


# -- folds --------------------------------------------------------------------

def test_fold_unfold_2d_match_hebbax():
    x = _rng(0).standard_normal((2, 8, 12, 5)).astype(np.float32)
    got = s2d.fold(_nchw(x))
    np.testing.assert_array_equal(_nhwc(got), np.asarray(js2d.fold(x)))
    np.testing.assert_array_equal(_nhwc(s2d.unfold(got)), x)
    with pytest.raises(ValueError, match="even spatial dims"):
        s2d.fold(torch.zeros(1, 1, 6, 5))


@pytest.mark.parametrize("f", FOLDS)
def test_fold3_unfold3_match_hebbax(f):
    x = _rng(1).standard_normal((2, 4, 6, 8, 3)).astype(np.float32)
    got = s2d3d.fold3(_nchw(x), f)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(js3.fold3(x, f)))
    np.testing.assert_array_equal(_nhwc(s2d3d.unfold3(got, f)), x)
    assert s2d3d.prodf(f) == js3.prodf(f)


@pytest.mark.parametrize("k,f", [(3, 2), (5, 2), (5, 1), (3, 1), (1, 2),
                                 (2, 2)])
def test_folded_k_and_pad(k, f):
    """The trimmed window: k=5 at f=2 folds to 3 taps, pad 1."""
    assert s2d3d.folded_k(k, f) == js3.folded_k(k, f)
    assert s2d3d.folded_pad3(k, (f, f, 1)) == tuple(
        p[0] for p in js3.folded_pad3(k, (f, f, 1)))
    if (k, f) == (5, 2):
        assert s2d3d.folded_k(5, 2) == 3
        assert s2d3d.folded_pad3(5, (2, 2, 2)) == (1, 1, 1)


# -- folded kernels -----------------------------------------------------------

@pytest.mark.parametrize("k,groups", [(3, (5,)), (3, (3, 4)), (1, (6,)),
                                      (1, (2, 4))])
def test_fold_conv_kernel_2d_matches_hebbax(k, groups):
    w = _rng(2).standard_normal((k, k, sum(groups), 6)).astype(np.float32)
    got = s2d.fold_conv_kernel(_conv_w(w), groups)
    ref = np.asarray(js2d.fold_conv_kernel(jnp.asarray(w), groups))
    np.testing.assert_array_equal(_from_conv_w(got), ref)
    assert tuple(got.shape) == s2d.folded_kernel_shape(k, groups, 6)
    assert tuple(ref.shape) == js2d.folded_kernel_shape(k, groups, 6)


@pytest.mark.parametrize("k,f", [(3, (2, 2, 2)), (3, (2, 1, 1)),
                                 (5, (2, 2, 2)), (5, (2, 2, 1)),
                                 (1, (2, 2, 2)), (3, (1, 1, 1))])
def test_fold_conv_kernel3_matches_hebbax(k, f):
    groups = (2, 3)
    w = _rng(3).standard_normal((k, k, k, 5, 4)).astype(np.float32)
    got = s2d3d.fold_conv_kernel3(_conv_w(w), groups, f)
    ref = np.asarray(js3.fold_conv_kernel3(jnp.asarray(w), groups, f))
    np.testing.assert_array_equal(_from_conv_w(got), ref)
    assert tuple(got.shape) == s2d3d.folded_kernel_shape3(k, groups, 4, f)
    # each slot holds one weight or zero: the gather rounds nothing
    vals = set(np.unique(got.numpy()).tolist())
    assert vals <= set(w.ravel().tolist()) | {0.0}


@pytest.mark.parametrize("k,f", [(3, (2, 2, 2)), (5, (2, 2, 2)),
                                 (3, (2, 1, 1)), (5, (2, 2, 1))])
def test_unfold_wgrad3_matches_hebbax_and_autograd(k, f):
    groups = (2, 3)
    pf = s2d3d.prodf(f)
    kf = tuple(s2d3d.folded_k(k, a) for a in f)
    gf = _rng(4).standard_normal(kf + (pf * 5, pf * 4)).astype(np.float32)
    got = s2d3d.unfold_wgrad3(_conv_w(gf), k, groups, 4, f)
    ref = np.asarray(js3.unfold_wgrad3(jnp.asarray(gf), k, groups, 4, f))
    np.testing.assert_allclose(_from_conv_w(got), ref, rtol=0, atol=2e-5)
    # the gather's adjoint is the same map
    w = torch.zeros((4, 5, k, k, k), requires_grad=True)
    (s2d3d.fold_conv_kernel3(w, groups, f) * _conv_w(gf)).sum().backward()
    np.testing.assert_allclose(w.grad.numpy(), got.numpy(), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("k", [1, 3])
def test_unfold_wgrad_2d_matches_hebbax(k):
    groups = (3, 2)
    gf = _rng(5).standard_normal((k, k, 20, 12)).astype(np.float32)
    got = s2d.unfold_wgrad(_conv_w(gf), k, groups, 3)
    ref = np.asarray(js2d.unfold_wgrad(jnp.asarray(gf), k, groups, 3))
    np.testing.assert_allclose(_from_conv_w(got), ref, rtol=0, atol=2e-5)
    assert s2d.unfold_wgrad(_conv_w(gf), k, groups, 3,
                            torch.float64).dtype == torch.float64


def test_fold_bias_matches_hebbax():
    b = _rng(6).standard_normal(5).astype(np.float32)
    np.testing.assert_array_equal(s2d.fold_bias(torch.from_numpy(b)).numpy(),
                                  np.asarray(js2d.fold_bias(b)))
    for f in FOLDS:
        np.testing.assert_array_equal(
            s2d3d.fold_bias3(torch.from_numpy(b), f).numpy(),
            np.asarray(js3.fold_bias3(b, f)))


@pytest.mark.parametrize("groups", [(5,), (2, 3)])
def test_folded_conv_2d_is_the_conv(groups):
    rng = _rng(7)
    x = torch.from_numpy(rng.standard_normal(
        (2, sum(groups), 16, 12)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(
        (6, sum(groups), 3, 3)).astype(np.float32))
    ref = F.conv2d(x, w, padding=1)
    parts, off = [], 0
    for g in groups:
        parts.append(s2d.fold(x[:, off:off + g]))
        off += g
    got = s2d.unfold(F.conv2d(torch.cat(parts, 1),
                              s2d.fold_conv_kernel(w, groups), padding=1))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=3e-5)


@pytest.mark.parametrize("k,f", [(3, (2, 1, 1)), (3, (2, 2, 2)),
                                 (5, (2, 2, 2)), (5, (2, 2, 1))])
def test_folded_conv3_is_the_conv(k, f):
    rng = _rng(8)
    x = torch.from_numpy(rng.standard_normal((1, 3, 8, 8, 8)).astype(
        np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 3, k, k, k)).astype(
        np.float32))
    ref = F.conv3d(x, w, padding=k // 2)
    got = s2d3d.unfold3(F.conv3d(
        s2d3d.fold3(x, f), s2d3d.fold_conv_kernel3(w, (3,), f),
        padding=s2d3d.folded_pad3(k, f)), f)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                               atol=3e-5 * max(1.0, float(ref.abs().max())))


# -- transpose and down kernels -----------------------------------------------

def test_transpose_kernel_matrix_matches_hebbax():
    w = _rng(9).standard_normal((2, 2, 2, 3, 4)).astype(np.float32)
    got = s2d3d.transpose_kernel_matrix(
        torch.from_numpy(np.ascontiguousarray(np.transpose(
            w, (3, 4, 0, 1, 2)))), (2, 2, 2))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(js3.transpose_kernel_matrix(w, (2, 2, 2))))


@pytest.mark.parametrize("f", [(2, 2, 2), (2, 1, 1), (2, 2, 1)])
def test_fold_transpose_kernel3_matches_hebbax(f):
    rng = _rng(10)
    w = rng.standard_normal((2, 2, 2, 3, 4)).astype(np.float32)
    wt = torch.from_numpy(np.ascontiguousarray(np.transpose(
        w, (3, 4, 0, 1, 2))))                             # (I, O, k)
    got, strides = s2d3d.fold_transpose_kernel3(wt, f)
    ref, jstrides = js3.fold_transpose_kernel3(jnp.asarray(w), f)
    assert tuple(strides) == tuple(jstrides)
    np.testing.assert_array_equal(
        np.transpose(got.numpy(), (2, 3, 4, 0, 1)), np.asarray(ref))
    # it emits the fold of the unfolded transpose conv
    x = torch.from_numpy(rng.standard_normal((2, 3, 3, 4, 2)).astype(
        np.float32))
    y = F.conv_transpose3d(x, got, stride=strides)
    ref_y = s2d3d.fold3(F.conv_transpose3d(x, wt, stride=2), f)
    np.testing.assert_allclose(y.numpy(), ref_y.numpy(), rtol=0, atol=2e-5)


@pytest.mark.parametrize("f", [(2, 2, 2), (2, 1, 1), (2, 2, 1)])
def test_fold_down_kernel3_matches_hebbax(f):
    rng = _rng(11)
    w = rng.standard_normal((2, 2, 2, 3, 4)).astype(np.float32)
    got, strides = s2d3d.fold_down_kernel3(_conv_w(w), f)
    ref, jstrides = js3.fold_down_kernel3(jnp.asarray(w), f)
    assert tuple(strides) == tuple(jstrides)
    np.testing.assert_array_equal(_from_conv_w(got), np.asarray(ref))
    x = torch.from_numpy(rng.standard_normal((2, 3, 4, 8, 6)).astype(
        np.float32))
    y = F.conv3d(s2d3d.fold3(x, f), got, stride=strides)
    ref_y = F.conv3d(x, _conv_w(w), stride=2)
    np.testing.assert_allclose(y.numpy(), ref_y.numpy(), rtol=0, atol=2e-5)


# -- groups -------------------------------------------------------------------

@pytest.mark.parametrize("out_groups", [(16, 16), (3, 5), (4,)])
def test_group_out_perm_matches_hebbax(out_groups):
    f = (2, 2, 2)
    got = s2d3d.group_out_perm(sum(out_groups), out_groups, f)
    np.testing.assert_array_equal(
        got, js3.group_out_perm(sum(out_groups), out_groups, f))


@pytest.mark.parametrize("f", [(2, 2, 2), (2, 1, 1)])
def test_regroup3_matches_hebbax_and_inverts(f):
    rng = _rng(12)
    a = rng.standard_normal((2, 4, 4, 4, 3)).astype(np.float32)
    b = rng.standard_normal((2, 4, 4, 4, 5)).astype(np.float32)
    grouped = np.concatenate([js3.fold3(a, f), js3.fold3(b, f)], -1)
    got = s2d3d.regroup3(_nchw(grouped), (3, 5), f)
    ref = np.asarray(js3.regroup3(jnp.asarray(grouped), (3, 5), f))
    np.testing.assert_array_equal(_nhwc(got), ref)
    np.testing.assert_array_equal(
        _nhwc(got), np.asarray(js3.fold3(np.concatenate([a, b], -1), f)))
    np.testing.assert_array_equal(
        _nhwc(s2d3d.ungroup3(got, (3, 5), f)), grouped)


def test_group_out_perm_on_a_kernel_emits_the_grouped_concat():
    """The permuted folded kernel's output is the folded concat of the
    two output groups (what a residual add against a concat needs)."""
    rng = _rng(13)
    f = (2, 2, 2)
    x = torch.from_numpy(rng.standard_normal((1, 4, 4, 4, 4)).astype(
        np.float32))
    w = torch.from_numpy(rng.standard_normal((6, 4, 3, 3, 3)).astype(
        np.float32))
    perm = torch.from_numpy(s2d3d.group_out_perm(6, (2, 4), f))
    y = F.conv3d(s2d3d.fold3(x, f),
                 s2d3d.fold_conv_kernel3(w, (4,), f)[perm], padding=1)
    ref = F.conv3d(x, w, padding=1)
    want = torch.cat([s2d3d.fold3(ref[:, :2], f),
                      s2d3d.fold3(ref[:, 2:], f)], 1)
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=0, atol=3e-5)


# -- pools and per-subpixel maps ----------------------------------------------

def test_subpixel_max_matches_hebbax_with_ties():
    """Values and gradient; the gradient splits evenly among tied maxima,
    as hebbax's ``jnp.max``."""
    rng = _rng(14)
    x = rng.standard_normal((2, 4, 6, 12)).astype(np.float32)
    x[0, :, :, :3] = 0.0                       # whole tied windows
    xf = np.asarray(js2d.fold(x))
    g = rng.standard_normal((2, 2, 3, 12)).astype(np.float32)
    ref, vjp = jax.vjp(js2d.subpixel_max, jnp.asarray(xf))
    (ref_gx,) = vjp(jnp.asarray(g))
    t = _nchw(xf).requires_grad_(True)
    got = s2d.subpixel_max(t)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(ref))
    got.backward(_nchw(g))
    np.testing.assert_allclose(_nhwc(t.grad), np.asarray(ref_gx), rtol=0,
                               atol=1e-7)
    np.testing.assert_array_equal(
        _nhwc(got), _nhwc(F.max_pool2d(_nchw(x), 2)))


@pytest.mark.parametrize("f", [(2, 2, 2), (2, 1, 1), (2, 2, 1)])
def test_subpixel_max3_matches_hebbax_first_max_backward(f):
    """Values and the custom backward: the cotangent goes to the FIRST
    maximum of each window in (z, y, x) order, also on an all-zero
    window (post-ReLU ties)."""
    rng = _rng(15)
    x = np.maximum(rng.standard_normal((2, 4, 4, 6, 3)), 0.0).astype(
        np.float32)
    x[0, :2, :2, :2, :] = 0.0                  # an all-zero window
    x[1, 2:, 2:, 4:, 1] = 0.5                  # a tied non-zero window
    xf = np.asarray(js3.fold3(x, f))
    g = rng.standard_normal((2, 2, 2, 3, 3)).astype(np.float32)
    ref, vjp = jax.vjp(lambda a: js3.subpixel_max3(a, f), jnp.asarray(xf))
    (ref_gx,) = vjp(jnp.asarray(g))
    t = _nchw(xf).requires_grad_(True)
    got = s2d3d.subpixel_max3(t, f)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(ref))
    got.backward(_nchw(g))
    np.testing.assert_array_equal(_nhwc(t.grad), np.asarray(ref_gx))
    # the all-zero window's cotangent sits on its first voxel only
    gx = s2d3d.unfold3(t.grad, f)[0, :, :2, :2, :2]
    assert torch.equal(gx[:, 0, 0, 0], _nchw(g)[0, :, 0, 0, 0])
    assert int((gx != 0).sum()) == 3
    # and it is the unfolded max pool's gradient
    xu = _nchw(x).requires_grad_(True)
    F.max_pool3d(xu, 2).backward(_nchw(g))
    np.testing.assert_array_equal(s2d3d.fold3(xu.grad, f).numpy(),
                                  t.grad.numpy())


def test_per_subpixel_softmax_matches_hebbax():
    y = _rng(16).standard_normal((2, 4, 6, 12)).astype(np.float32)
    got = s2d.per_subpixel(lambda t: torch.softmax(50.0 * t, dim=1),
                           _nchw(y), 3)
    ref = js2d.per_subpixel(lambda t: jax.nn.softmax(50.0 * t, axis=-1),
                            jnp.asarray(y), 3)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=0,
                               atol=1e-6)


def test_fold_resize_linear_align_corners_matches_hebbax():
    x = _rng(17).standard_normal((2, 5, 7, 3)).astype(np.float32)
    got = s2d.fold_resize_linear_align_corners(_nchw(x), (10, 14))
    ref = js2d.fold_resize_linear_align_corners(jnp.asarray(x), (10, 14))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(
        got.numpy(),
        s2d.fold(resize_linear_align_corners(_nchw(x), (10, 14))).numpy())
