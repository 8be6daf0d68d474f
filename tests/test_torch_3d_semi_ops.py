"""The model ops, losses and data pieces of the port's 3D semi-supervised
family held against hebbax on the same numpy-seeded inputs.

* ``resize_linear_align_corners`` in 3D (trilinear, ``F.interpolate``)
  against hebbax's separable per-axis matmuls, at non-power-of-two sizes
  and at URPC's 2x and 8x steps; ``instance_norm``; the CCT perturbations
  on 5-D maps with hebbax's own draws; the channel-wise ``Dropout3d``.
* ``mask_to_sdf`` / ``find_boundaries_inner``: the same scipy arithmetic.
* ``dtc_unsup`` / ``dtc_sup``: sigmoid(-1500 * sdf) saturates, so a
  float32 rounding of sdf near 0 moves a term by up to 375x its own size;
  they are compared in float64 (hebbax under ``jax.enable_x64``, with a
  float64 stand-in for the dice, which both packages reduce in float32)
  and in float32 with the dice, as losses, and ``dtc_unsup``'s gradient
  in float64.
* ``VolumeDataset3D(sdf=True)``: the SDF maps ride the patch queue, and
  ``to_device_batch_3d`` carries them as hebbax's ``prep_batch_3d`` does.

Tolerances: the resize rtol 1e-5 / atol 1e-6 (float32 interpolation taken
in another order); instance norm rtol 1e-5 / atol 1e-5; the perturbations
rtol 1e-6 / atol 1e-7 (elementwise float32; the attention threshold is a
reduction, so a position at it could flip, and none does for these
inputs); the DTC losses
rtol 1e-12 in float64 and rtol 1e-5 in float32, the gradient rtol 1e-10 /
atol 1e-14; the SDF maps and the data
pipeline are exact (the same numpy / scipy code).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hebbax.engine.semi as jsemi
import hebbax.models.common as jcommon
from hebbax.cli.common3d import prep_batch_3d as j_prep
from hebbax.data import nrrd_io as jnrrd
from hebbax.data import volumes3d as jvol
from hebbax.ops import distance as jdist
from hebbax.ops.losses import dice_loss as j_dice
from hebbax_torch.cli import common3d
from hebbax_torch.data import volumes3d as tvol
from hebbax_torch.engine import semi
from hebbax_torch.engine.loop import to_device_batch_3d
from hebbax_torch.models import common
from hebbax_torch.ops import distance as tdist
from hebbax_torch.ops.losses import dice_loss

from test_torch_3d_data import _assert_batches_equal, _volume
from test_torch_semi_ops import hebbax_draws, nchw, nhwc

torch.set_num_threads(2)


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("src,dst", [((3, 5, 4), (7, 11, 9)),
                                     ((2, 2, 2), (16, 16, 16)),
                                     ((6, 5, 4), (12, 10, 8)),
                                     ((5, 1, 3), (9, 4, 3))])
def test_trilinear_resize_matches_hebbax(src, dst):
    x = _x(0, (2,) + src + (3,))
    ref = jcommon.resize_linear_align_corners(jnp.asarray(x), dst)
    got = common.resize_linear_align_corners(nchw(x), dst)
    assert tuple(got.shape[2:]) == dst
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_bilinear_resize_is_unchanged():
    x = _x(1, (2, 5, 7, 3))
    ref = jcommon.resize_linear_align_corners(jnp.asarray(x), (10, 13))
    got = common.resize_linear_align_corners(nchw(x), (10, 13))
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 6, 5, 4, 3), (1, 2, 2, 2, 16),
                                   (2, 9, 7, 4)])
def test_instance_norm_matches_hebbax(shape):
    x = 3.0 * _x(2, shape) + 1.5
    ref = jcommon.instance_norm(jnp.asarray(x))
    got = common.instance_norm(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kind", ["noise", "dropout", "feature_dropout"])
def test_perturbations_on_5d_maps_match_hebbax(kind):
    feats = [np.abs(_x(3 + i, (2, 8 >> i, 8 >> i, 6 >> i, 4 << i)))
             for i in range(3)]
    key = jax.random.PRNGKey(5)
    ref = jcommon.perturb_features(key, [jnp.asarray(f) for f in feats],
                                   kind)
    draws = hebbax_draws(key, feats, kind)
    got = common.perturb_features([nchw(f) for f in feats], kind,
                                  draws=draws)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(nhwc(g), np.asarray(r), rtol=1e-6,
                                   atol=1e-7)
    if kind == "feature_dropout":             # zeroes some, not all
        assert 0 < sum(int((g == 0).sum()) for g in got) < sum(
            g.numel() for g in got)


def test_dropout3d_drops_whole_channels():
    gen = torch.Generator().manual_seed(0)
    drop = common.Dropout3d(0.5, gen)
    x = torch.rand(4, 64, 3, 4, 5) + 0.5
    y = drop(x)
    kept = (y != 0)
    # one keep bit per (sample, channel), the kept values scaled by 2
    assert torch.equal(kept, kept[..., :1, :1, :1].expand_as(kept))
    torch.testing.assert_close(y[kept], 2.0 * x[kept])
    assert 0.35 < kept[..., 0, 0, 0].float().mean() < 0.65
    drop.eval()
    assert drop(x) is x
    assert common.Dropout3d(0.0, gen)(x) is x
    with pytest.raises(ValueError):
        common.Dropout3d(1.0)


# -- signed distance maps -----------------------------------------------------

def _masks():
    rng = np.random.default_rng(4)
    ball = _volume(6)[1] > 0
    blobs = rng.random((12, 10, 9)) < 0.2
    return [ball, blobs, np.zeros((5, 6, 7), bool), np.ones((4, 4, 4), bool)
            & (rng.random((4, 4, 4)) < 0.9), rng.random((9, 8)) < 0.3]


@pytest.mark.parametrize("i", range(5))
def test_mask_to_sdf_matches_hebbax(i):
    mask = _masks()[i]
    np.testing.assert_array_equal(tdist.find_boundaries_inner(mask),
                                  jdist.find_boundaries_inner(mask))
    got, ref = tdist.mask_to_sdf(mask), jdist.mask_to_sdf(mask)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    if mask.any() and not mask.all():
        assert got.min() >= -1.0 and got.max() <= 1.0
        assert (got[tdist.find_boundaries_inner(mask) == 1] == 0).all()


# -- DTC losses ---------------------------------------------------------------

def _dtc_inputs(n_cls, seed=8):
    rng = np.random.default_rng(seed)
    shape = (2, 6, 5, 4)
    sdf = np.tanh(rng.standard_normal(shape + (n_cls,)) * 0.01)
    seg = rng.standard_normal(shape + (n_cls,))
    batch = {"mask": (rng.random(shape) * n_cls).astype(np.int32),
             "mask_sdf": rng.uniform(-1, 1, shape),
             "mask_sdf2": rng.uniform(-1, 1, shape)}
    return sdf, seg, batch


def _j_batch(batch, dtype, weight):
    out = {k: jnp.asarray(v if k == "mask" else v.astype(dtype))
           for k, v in batch.items()}
    if weight is not None:
        out["weight"] = jnp.asarray(np.asarray(weight, dtype))
    return out


def _t_batch(batch, dtype, weight):
    out = {"mask": torch.from_numpy(batch["mask"]).long()}
    for k in ("mask_sdf", "mask_sdf2"):
        out[k] = torch.from_numpy(batch[k].astype(dtype))
    if weight is not None:
        out["weight"] = torch.tensor(weight, dtype=torch.float64
                                     if dtype == np.float64 else
                                     torch.float32)
    return out


def _mean_square(seg, mask):
    """A float64 stand-in for the criterion (both packages' dice reduce in
    float32), so the float64 comparison sees only DTC's own terms."""
    return (seg ** 2).mean()


@pytest.mark.parametrize("x64", [True, False])
@pytest.mark.parametrize("n_cls", [2, 3])
@pytest.mark.parametrize("weight", [None, [1.0, 0.0]])
def test_dtc_losses_match_hebbax(x64, n_cls, weight):
    sdf, seg, batch = _dtc_inputs(n_cls)
    dt = np.float64 if x64 else np.float32
    crit_j, crit_t = (_mean_square, _mean_square) if x64 else (j_dice,
                                                               dice_loss)
    with jax.enable_x64(x64):
        jout = (jnp.asarray(sdf.astype(dt)), jnp.asarray(seg.astype(dt)))
        jb = _j_batch(batch, dt, weight)
        ref_u = float(jsemi.dtc_unsup(jout, jb))
        ref_s = float(jsemi.dtc_sup(crit_j, beta=0.3, num_classes=n_cls)(
            jout, jb))
    tout = (nchw(sdf.astype(dt)), nchw(seg.astype(dt)))
    tb = _t_batch(batch, dt, weight)
    got_u = float(semi.dtc_unsup(tout, tb))
    got_s = float(semi.dtc_sup(crit_t, beta=0.3, num_classes=n_cls)(
        tout, tb))
    rtol = 1e-12 if x64 else 1e-5
    np.testing.assert_allclose(got_u, ref_u, rtol=rtol)
    np.testing.assert_allclose(got_s, ref_s, rtol=rtol)
    # the class-2 SDF term counts only at 3 classes
    two = semi.dtc_sup(crit_t, beta=0.3, num_classes=2)(tout, tb)
    assert (float(two) == got_s) == (n_cls == 2)


def test_dtc_unsup_gradient_matches_hebbax_in_float64():
    sdf, seg, batch = _dtc_inputs(2, seed=9)
    with jax.enable_x64(True):
        g_ref = jax.grad(lambda s: jsemi.dtc_unsup(
            (s, jnp.asarray(seg)), {}))(jnp.asarray(sdf))
    t = nchw(sdf).requires_grad_(True)
    semi.dtc_unsup((t, nchw(seg)), {}).backward()
    np.testing.assert_allclose(nhwc(t.grad), np.asarray(g_ref), rtol=1e-10,
                               atol=1e-14)


# -- SDF through the data pipeline ------------------------------------------

@pytest.fixture(scope="module")
def sdf_volumes(tmp_path_factory):
    """A train/val NRRD folder with ``mask_sdf1`` maps, written by
    hebbax's writer."""
    root = tmp_path_factory.mktemp("atrial_sdf")
    for split, n in (("train", 4), ("val", 2)):
        for sub in ("image", "mask", "mask_sdf1"):
            os.makedirs(root / split / sub)
        for i in range(n):
            vol, mask = _volume(i + (10 if split == "val" else 0))
            name = f"v{i}.nrrd"
            jnrrd.write_nrrd(str(root / split / "image" / name), vol)
            jnrrd.write_nrrd(str(root / split / "mask" / name), mask)
            jnrrd.write_nrrd(str(root / split / "mask_sdf1" / name),
                             jdist.mask_to_sdf(mask > 0).astype(np.float32))
    return str(root)


def test_sdf_patch_batches_are_equal_for_two_epochs(sdf_volumes):
    kw = dict(split="train", regime=50, seed=3, sdf=True)
    sub = os.path.join(sdf_volumes, "train")
    qkw = dict(batch_size=2, samples_per_volume=3, max_length=4, seed=3)
    got = tvol.PatchQueue(tvol.VolumeDataset3D(sub, **kw), (16, 8, 8),
                          **qkw)
    ref = jvol.PatchQueue(jvol.VolumeDataset3D(sub, **kw), (16, 8, 8),
                          **qkw)
    for _ in range(2):
        batches = list(got)
        _assert_batches_equal(batches, list(ref))
        assert all(b["mask_sdf"].shape == b["mask"].shape
                   and b["mask_sdf"].dtype == np.float32 for b in batches)
    # a flip moves the SDF with the mask: it is 0 on the mask's boundary
    b = batches[0]
    inner = np.stack([tdist.find_boundaries_inner(m) for m in b["mask"]])
    assert (b["mask_sdf"][inner == 1] == 0).all()

    dev, jb = to_device_batch_3d(b, "cpu"), j_prep(b)
    assert set(dev) == set(jb) == {"image", "mask", "mask_sdf"}
    assert dev["mask_sdf"].dtype == torch.float32
    np.testing.assert_array_equal(dev["mask_sdf"].numpy(),
                                  np.asarray(jb["mask_sdf"]))


def test_queues_read_sdf_on_the_train_split_only(sdf_volumes):
    args = common3d.base_parser_3d().parse_args(
        ["--path_dataset", sdf_volumes, "--patch_size", "16,8,8",
         "--regime", "50", "--samples_per_volume_val", "1"])
    cfg = {"NUM_CLASSES": 2}
    queues = common3d.make_queues_3d(args, cfg, sup=True, sdf=True)
    assert "mask_sdf" in next(iter(queues["train"]))
    assert "mask_sdf" not in next(iter(queues["val"]))
    plain = common3d.make_queues_3d(args, cfg, splits=("train",))
    assert "mask_sdf" not in next(iter(plain["train"]))
