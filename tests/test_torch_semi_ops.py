"""The port's semi-supervised building blocks held against hebbax on the
same numpy-seeded inputs: the consistency losses, the unsup objectives of
EM / URPC / CCT, the deep-supervision loss, the EMA, the ramps, UAMT's
threshold, the nearest resize, and the CCT perturbations.

The perturbations are split into a draw and a deterministic part; the
deterministic part runs on draws taken from ``jax.random`` with hebbax's
own key splits (:func:`hebbax_draws`) and must reproduce hebbax's output;
the port's own draws (from a ``torch.Generator``) are checked by
distribution.

Tolerances: pure loss functions rtol 1e-5 / atol 1e-6 (float32 reductions
taken in another order); the EMA and the perturbations rtol 1e-6 /
atol 1e-7 (elementwise float32); the resize is exact (a gather); the ramps
rtol 1e-6 (hebbax computes them in float64 numpy, the port in Python
floats); the UAMT threshold is float32 in both and must be equal.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hebbax.config.ramps as jramps
import hebbax.engine.semi as jsemi
import hebbax.models.common as jcommon
import hebbax.ops.ema as jema
import hebbax.ops.losses as jlosses
from hebbax_torch.config import ramps
from hebbax_torch.engine import semi
from hebbax_torch.models import common
from hebbax_torch.ops import ema, losses

torch.set_num_threads(2)

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


def nchw(a):
    """numpy NHWC (or N,H,W,C-last) -> torch NCHW."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(
        np.asarray(a), -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _logits(seed, n=2, c=2, hw=16):
    rng = np.random.default_rng(seed)
    return (3 * rng.standard_normal((n, hw, hw, c))).astype(np.float32)


def jax_draw(kind, key, f):
    """hebbax's draw for one feature map ``f`` (NHWC), as
    ``hebbax/models/common.py`` takes it from ``key``."""
    if kind == "noise":
        return jax.random.uniform(key, f.shape[1:], f.dtype, -0.3, 0.3)
    if kind == "dropout":
        return jax.random.bernoulli(key, 1.0 - 0.3, f.shape)
    return jax.random.uniform(key, (), f.dtype, 0.7, 0.9)


def port_draw(kind, d):
    """A hebbax draw in the port's layout: the (H, W, C) noise as
    (C, H, W), the NHWC keep mask as NCHW, the fraction as a scalar."""
    d = np.array(d)                           # a writable copy
    if kind == "noise":
        return torch.from_numpy(np.ascontiguousarray(np.moveaxis(d, -1, 0)))
    if kind == "dropout":
        return nchw(d)
    return torch.tensor(d)


def hebbax_draws(key, feats_nhwc, kind):
    """The draws hebbax's ``perturb_features(key, feats, kind)`` takes,
    from the same key splits, in the port's layout."""
    keys = jax.random.split(key, len(feats_nhwc))
    return [port_draw(kind, jax_draw(kind, k, jnp.asarray(f)))
            for k, f in zip(keys, feats_nhwc)]


# -- losses -----------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("shape", [(2, 5), (3, 4, 6, 2), (2, 8, 8, 1)])
def test_weighted_mean_matches(shape, weighted):
    rng = np.random.default_rng(len(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    w = np.array([1.0] + [0.0] * (shape[0] - 2) + [1.0], np.float32)
    w = w if weighted else None
    ref = jlosses.weighted_mean(jnp.asarray(x), None if w is None
                                else jnp.asarray(w))
    got = losses.weighted_mean(torch.from_numpy(x), None if w is None
                               else torch.from_numpy(w))
    np.testing.assert_allclose(float(got), float(ref), **LOSS_TOL)


@pytest.mark.parametrize("c", [2, 3])
def test_softmax_mse_loss_matches_and_stops_target_grad(c):
    a, b = _logits(0, c=c), _logits(1, c=c)
    ref = jlosses.softmax_mse_loss(jnp.asarray(a), jnp.asarray(b))
    ta = nchw(a).requires_grad_(True)
    tb = nchw(b).requires_grad_(True)
    got = losses.softmax_mse_loss(ta, tb)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), **LOSS_TOL)
    got.sum().backward()
    assert tb.grad is None and ta.grad is not None


@pytest.mark.parametrize("c", [2, 3])
@pytest.mark.parametrize("weighted", [False, True])
def test_entropy_loss_matches(c, weighted):
    p = np.asarray(jax.nn.softmax(jnp.asarray(_logits(2, c=c)), axis=-1))
    w = np.array([0.0, 1.0], np.float32) if weighted else None
    ref = jlosses.entropy_loss(jnp.asarray(p), c, None if w is None
                               else jnp.asarray(w))
    got = losses.entropy_loss(nchw(p), c, None if w is None
                              else torch.from_numpy(w))
    np.testing.assert_allclose(float(got), float(ref), **LOSS_TOL)


# -- unsup objectives -------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_em_unsup_matches(seed):
    x = _logits(seed)
    ref = jsemi.em_unsup(2)(jnp.asarray(x), {})
    got = semi.em_unsup(2)(nchw(x), {})
    np.testing.assert_allclose(float(got), float(ref), **LOSS_TOL)


@pytest.mark.parametrize("fn", ["urpc_unsup", "cct_unsup"])
@pytest.mark.parametrize("seed", [0, 1])
def test_deep4_unsup_matches(fn, seed):
    outs = [_logits(seed * 4 + i) for i in range(4)]
    ref = getattr(jsemi, fn)(tuple(jnp.asarray(o) for o in outs), {})
    got = getattr(semi, fn)(tuple(nchw(o) for o in outs), {})
    np.testing.assert_allclose(float(got), float(ref), **LOSS_TOL)


def test_deep4_sup_matches():
    from hebbax_torch.ops.losses import dice_loss
    outs = [_logits(10 + i) for i in range(4)]
    mask = (np.random.default_rng(3).random((2, 16, 16)) < 0.5).astype(
        np.int32)
    ref = jsemi.deep4_sup(jlosses.dice_loss)(
        tuple(jnp.asarray(o) for o in outs), {"mask": jnp.asarray(mask)})
    got = semi.deep4_sup(dice_loss)(
        tuple(nchw(o) for o in outs), {"mask": torch.from_numpy(mask).long()})
    np.testing.assert_allclose(float(got), float(ref), **LOSS_TOL)


# -- EMA, ramps, UAMT threshold ---------------------------------------------

@pytest.mark.parametrize("global_step", [0, 1, 5, 1000])
def test_update_ema_matches_and_skips_buffers(global_step):
    rng = np.random.default_rng(global_step)
    torch.manual_seed(0)
    student = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3),
                                  torch.nn.BatchNorm2d(4))
    teacher = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3),
                                  torch.nn.BatchNorm2d(4))
    with torch.no_grad():
        for p in list(student.parameters()) + list(teacher.parameters()):
            p.copy_(torch.from_numpy(rng.standard_normal(
                tuple(p.shape)).astype(np.float32)))
        teacher[1].running_mean.fill_(3.0)
    e0 = [p.detach().numpy().copy() for p in teacher.parameters()]
    p0 = [p.detach().numpy() for p in student.parameters()]
    ema.update_ema(teacher, student, 0.99, global_step)
    ref = jema.update_ema([jnp.asarray(e) for e in e0],
                          [jnp.asarray(p) for p in p0], 0.99, global_step)
    for got, r in zip(teacher.parameters(), ref):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(r),
                                   rtol=1e-6, atol=1e-7)
    assert torch.all(teacher[1].running_mean == 3.0)
    if global_step == 0:        # alpha 0: the teacher copies the student
        for got, p in zip(teacher.parameters(), p0):
            np.testing.assert_array_equal(got.detach().numpy(), p)


@pytest.mark.parametrize("current,length",
                         [(0, 10), (3, 10), (10, 10), (12, 10), (5, 0),
                          (2.5, 7)])
def test_ramps_match(current, length):
    np.testing.assert_allclose(ramps.sigmoid_rampup(current, length),
                               jramps.sigmoid_rampup(current, length),
                               rtol=1e-6)
    if length:
        np.testing.assert_allclose(ramps.linear_rampup(current, length),
                                   jramps.linear_rampup(current, length),
                                   rtol=1e-6)
    if length and current <= length:
        np.testing.assert_allclose(ramps.cosine_rampdown(current, length),
                                   jramps.cosine_rampdown(current, length),
                                   rtol=1e-6)


@pytest.mark.parametrize("epoch,num_epochs", [(0, 2), (1, 2), (7, 200),
                                              (250, 200)])
def test_uamt_threshold_matches(epoch, num_epochs):
    phase = jnp.clip(jnp.float32(epoch) / num_epochs, 0.0, 1.0)
    ref = (0.75 + 0.25 * jnp.exp(-5.0 * (1.0 - phase) ** 2)) * jnp.log(2.0)
    assert semi.uamt_threshold(epoch, num_epochs) == float(ref)


def test_uamt_noise_distribution():
    img = torch.zeros(4, 3, 32, 32)
    a = semi.uamt_noise(img, 9, torch.Generator().manual_seed(0))
    b = semi.uamt_noise(img, 9, torch.Generator().manual_seed(0))
    assert a.shape == (9, 4, 3, 32, 32) and torch.equal(a, b)
    bound = torch.tensor(0.2)                 # 0.2 in float32
    assert bool(a.abs().max() <= bound)
    assert abs(float(a.std()) - 0.1) < 0.01
    assert 0.03 < float((a.abs() == bound).float().mean()) < 0.06  # 2 sd


# -- nearest resize ----------------------------------------------------------

@pytest.mark.parametrize("src,dst", [((4, 4), (32, 32)), ((5, 7), (8, 9)),
                                     ((8, 8), (8, 8)), ((6, 3), (4, 12))])
def test_resize_nearest_matches(src, dst):
    x = np.random.default_rng(0).standard_normal(
        (2,) + src + (3,)).astype(np.float32)
    ref = jcommon.resize_nearest_torch(jnp.asarray(x), dst)
    got = common.resize_nearest_torch(nchw(x), dst)
    np.testing.assert_array_equal(nhwc(got), np.asarray(ref))
    torch_ref = torch.nn.functional.interpolate(nchw(x), size=dst,
                                                mode="nearest")
    np.testing.assert_array_equal(got.numpy(), torch_ref.numpy())


# -- CCT perturbations --------------------------------------------------------

def _levels(seed, n=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, s, s, c)).astype(np.float32)
            for s, c in ((16, 4), (8, 8), (4, 16), (2, 32), (1, 64))]


@pytest.mark.parametrize("kind", common.CCT_PERTURB_KINDS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_perturbation_matches_on_hebbax_draws(kind, seed):
    feats = _levels(seed)
    key = jax.random.PRNGKey(100 + seed)
    ref = jcommon.perturb_features(key, [jnp.asarray(f) for f in feats],
                                   kind)
    got = common.perturb_features([nchw(f) for f in feats], kind,
                                  draws=hebbax_draws(key, feats, kind))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(nhwc(g), np.asarray(r), rtol=1e-6,
                                   atol=1e-7)


def test_cct_aux_outputs_order_and_batched_raises():
    """The serial and the batched decode: perturbations drawn first, in
    CCT_PERTURB_KINDS order; the batched one decodes each level's clean
    and 3 perturbed copies as one batch of 4N (once) and slices it back
    into the serial order.  (The batched decode no longer raises: the
    name is kept.)"""
    feats = [torch.arange(2.0).view(2, 1, 1, 1),
             10 * torch.arange(2.0).view(2, 1, 1, 1)]
    for batched in (False, True):
        seen, decoded = [], []

        def perturb_one(kind):
            seen.append(kind)
            return [f + 100 * len(seen) for f in feats]

        def decode(lv):
            decoded.append(lv[0].shape[0])
            return lv[0] + lv[1]

        out = common.cct_aux_outputs(feats, perturb_one, decode,
                                     batched=batched)
        assert seen == list(common.CCT_PERTURB_KINDS)
        assert decoded == ([8] if batched else [2, 2, 2, 2])
        assert [o[:, 0, 0, 0].tolist() for o in out] == [
            [0.0, 11.0], [200.0, 211.0], [400.0, 411.0], [600.0, 611.0]]


def test_port_draws_distribution():
    x = torch.ones(4, 8, 32, 32)
    g = torch.Generator().manual_seed(0)
    noise = common.draw_perturbation("noise", x, g)
    assert noise.shape == (8, 32, 32)
    assert -0.3 <= float(noise.min()) and float(noise.max()) <= 0.3
    assert abs(float(noise.mean())) < 0.02
    y = common.feature_noise(x, noise)
    assert torch.equal(y[0], y[3])            # one noise for the batch
    keep = common.draw_perturbation("dropout", x, g)
    assert keep.dtype == torch.bool and keep.shape == x.shape
    assert abs(float(keep.float().mean()) - 0.7) < 0.01
    y = common.feature_dropout_elementwise(x, keep)
    torch.testing.assert_close(y, keep.float() / 0.7)
    fracs = torch.stack([common.draw_perturbation("feature_dropout", x, g)
                         for _ in range(200)])
    assert fracs.shape == (200,)
    assert 0.7 <= float(fracs.min()) and float(fracs.max()) <= 0.9
    assert abs(float(fracs.mean()) - 0.8) < 0.02
    again = common.draw_perturbation(
        "noise", x, torch.Generator().manual_seed(0))
    assert torch.equal(again, noise)          # reproducible from the seed


def test_feature_dropout_attention_thresholds_per_sample():
    x = torch.zeros(2, 3, 2, 2)
    x[0, :, 0, 0] = 1.0                       # sample 0: max 1 at (0, 0)
    x[0, :, 1, 1] = 0.75
    x[1, :, 0, 1] = 4.0                       # sample 1: max 4 at (0, 1)
    x[1, :, 1, 0] = 3.5
    y = common.feature_dropout_attention(x, torch.tensor(0.8))
    assert float(y[0, 0, 0, 0]) == 0.0 and float(y[0, 0, 1, 1]) == 0.75
    assert float(y[1, 0, 0, 1]) == 0.0 and float(y[1, 0, 1, 0]) == 0.0
    assert math.isclose(float(y.sum()), 3 * 0.75)
