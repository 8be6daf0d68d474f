"""The port's 3D Hebbian rules held against ``hebbax.hebb.rules`` on
random tensors from a numpy seed.

hebbax is channels-last with kernels ``(*k, I, O)``; the port is
channels-first with torch's ``(O, I, *k)`` conv and ``(I, O, *k)``
transpose-conv weights.  Cases: swta on a 3x3x3 pad-1 and a 1x1x1 conv,
through the dispatcher (a 5-D weight goes to the composed rule on any
device, and no kernel is launched); swta_t on a k = s = 2 transpose conv
(every site of ``unet3d``) and on a k = 3, s = 2 one; the transpose
weight norm (per input channel).  ``tests/test_torch_hebb_rules.py``
holds the other rules.

Tolerance: max|err| <= 1e-5 * max|hebbax delta| — float32 sums over up to
2*8^3 voxels of products, taken by XLA and oneDNN in other orders.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hebbax.hebb import rules as jrules
from hebbax_torch.hebb import kernels
from hebbax_torch.hebb import rules as trules
from hebbax_torch.hebb.spec import HebbSpec

torch.set_num_threads(2)

K = 50.0


def _t(a, perm):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, perm)))


def _close(got, ref):
    ref = np.asarray(ref)
    err = float(np.abs(got - ref).max())
    assert err <= 1e-5 * float(np.abs(ref).max()), err


@pytest.mark.parametrize("n,s,i,o,k", [(2, 6, 3, 5, 3), (2, 8, 4, 6, 1),
                                       (1, 5, 8, 4, 3)])
def test_swta_conv3d_matches(n, s, i, o, k):
    rng = np.random.default_rng(i * 7 + k)
    x = rng.standard_normal((n, s, s + 1, s - 1, i)).astype(np.float32)
    y = (0.1 * rng.standard_normal((n, s, s + 1, s - 1, o))).astype(
        np.float32)
    w = (0.1 * rng.standard_normal((k, k, k, i, o))).astype(np.float32)
    p = k // 2
    ref = jrules.swta_conv_delta(jnp.asarray(w), jnp.asarray(x),
                                 jnp.asarray(y), K, (1, 1, 1),
                                 padding=((p, p),) * 3)
    wt = _t(w, (4, 3, 0, 1, 2))
    xt, yt = _t(x, (0, 4, 1, 2, 3)), _t(y, (0, 4, 1, 2, 3))
    before = kernels.SWTA_DELTA.launches
    got = kernels.swta_delta(wt, xt, yt, K, (p, p, p))
    assert kernels.SWTA_DELTA.launches == before
    assert torch.equal(got, trules.swta_wgrad_delta(wt, xt, yt, K,
                                                    (p, p, p)))
    _close(np.transpose(got.numpy(), (2, 3, 4, 1, 0)), ref)


@pytest.mark.parametrize("n,q,i,o,k,s", [(2, 4, 6, 3, 2, 2),
                                         (1, 3, 4, 4, 2, 2),
                                         (2, 3, 5, 3, 3, 2)])
def test_swta_t_delta_matches(n, q, i, o, k, s):
    rng = np.random.default_rng(q * 11 + k)
    p = (q - 1) * s + k
    x = rng.standard_normal((n, q, q + 1, q, i)).astype(np.float32)
    y = (0.1 * rng.standard_normal((n, p, p + s, p, o))).astype(np.float32)
    w = (0.1 * rng.standard_normal((k, k, k, i, o))).astype(np.float32)
    ref = jrules.swta_t_delta(jnp.asarray(w), jnp.asarray(x),
                              jnp.asarray(y), K, (s, s, s))
    wt = _t(w, (3, 4, 0, 1, 2))
    got = trules.swta_t_delta(wt, _t(x, (0, 4, 1, 2, 3)),
                              _t(y, (0, 4, 1, 2, 3)), K, s)
    assert got.dtype == torch.float32
    _close(np.transpose(got.numpy(), (2, 3, 4, 0, 1)), ref)


def test_compute_delta_routes_transpose_convs_to_swta_t():
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.standard_normal((4, 3, 2, 2, 2)).astype(
        np.float32))
    x = torch.from_numpy(rng.standard_normal((1, 4, 3, 3, 3)).astype(
        np.float32))
    y = torch.from_numpy(rng.standard_normal((1, 3, 6, 6, 6)).astype(
        np.float32))
    spec = HebbSpec(mode="swta_t", k=K)
    got = trules.compute_delta(spec, w, x, y, (0, 0, 0), True, (2, 2, 2))
    assert torch.equal(got, trules.swta_t_delta(w, x, y, K, (2, 2, 2)))
    # the other modes route to their rules (tests/test_torch_hebb_rules.py
    # holds each against hebbax); only patchwise=False raises
    assert torch.equal(
        trules.compute_delta(HebbSpec(mode="hpca_t"), w, x, y, (0, 0, 0),
                             True, (2, 2, 2)),
        trules.hpca_t_delta(w, x, y, (2, 2, 2), chunk=32))
    assert torch.equal(
        trules.compute_delta(HebbSpec(mode="swta", k=K), w, x, y,
                             (0, 0, 0), True, (2, 2, 2)),
        trules.swta_wgrad_delta(w, y, x, K, 0, (2, 2, 2)))
    with pytest.raises(NotImplementedError, match="patchwise"):
        trules.compute_delta(HebbSpec(mode="swta_t", patchwise=False), w, x,
                             y, (0, 0, 0), True, (2, 2, 2))


def test_transpose_weight_norm_is_per_input_channel():
    rng = np.random.default_rng(6)
    w = rng.standard_normal((2, 2, 2, 6, 3)).astype(np.float32)
    for transpose, perm in ((True, (3, 4, 0, 1, 2)),
                            (False, (4, 3, 0, 1, 2))):
        ref = jrules.normalize(jnp.asarray(w),
                               jrules.weight_norm_axes(3, transpose))
        got = trules.normalize(_t(w, perm),
                               trules.weight_norm_dims(3))
        np.testing.assert_allclose(
            np.transpose(got.numpy(), np.argsort(perm)), np.asarray(ref),
            rtol=1e-6, atol=1e-7)
    # a transpose weight's rows (one per input channel) have unit norm
    got = trules.normalize(_t(w, (3, 4, 0, 1, 2)),
                           trules.weight_norm_dims(3))
    np.testing.assert_allclose(got.pow(2).sum(dim=(1, 2, 3, 4)).numpy(),
                               np.ones(6), rtol=1e-6)
