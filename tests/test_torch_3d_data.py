"""The port's 3D data pipeline and 3D evaluation helpers held against
hebbax's on the same numpy inputs.

* NRRD: a file written by either package is byte-equal to the other's, and
  each reads the other's back to the same array and affine.
* ``znormalize`` / ``bias_field`` / ``random_intensity`` and the patch
  queue: the same numpy ``Generator`` draws in the same order, so the
  arrays are equal to the bit.
* The regime split (``random.Random(seed).shuffle`` of the listdir
  order) picks the same volumes per seed.
* ``grid_locations``, ``postprocess_3d_pred`` and
  ``eval_distance_offline``: the same integer and scipy arithmetic, equal.

All tolerances are exact: both packages run the same numpy/scipy code.
"""

import os

import numpy as np
import pytest

from hebbax.data import augment3d as jaug
from hebbax.data import nrrd_io as jnrrd
from hebbax.data import volumes3d as jvol
from hebbax.engine.sliding import grid_locations as j_grid
from hebbax.ops.distance import eval_distance_offline as j_offline
from hebbax.ops.morphology import postprocess_3d_pred as j_post
from hebbax_torch.data import augment3d as taug
from hebbax_torch.data import nrrd_io as tnrrd
from hebbax_torch.data import volumes3d as tvol
from hebbax_torch.engine.sliding import grid_locations as t_grid
from hebbax_torch.ops.distance import eval_distance_offline as t_offline
from hebbax_torch.ops.morphology import postprocess_3d_pred as t_post

AFFINE = np.array([[0.625, 0.0, 0.0, -12.5], [0.0, 0.625, 0.0, 3.25],
                   [0.0, 0.0, 2.5, 40.0], [0.0, 0.0, 0.0, 1.0]])


def _volume(seed, shape=(20, 18, 12)):
    rng = np.random.default_rng(seed)
    vol = rng.normal(100, 20, shape).astype(np.float32)
    xx, yy, zz = np.mgrid[: shape[0], : shape[1], : shape[2]]
    mask = (((xx - 10) ** 2 + (yy - 8) ** 2 + (zz - 6) ** 2) < 25)
    vol[mask] += 60
    return vol, mask.astype(np.uint8) * 255


@pytest.fixture(scope="module")
def volumes(tmp_path_factory):
    """A train/val NRRD folder written by hebbax's writer."""
    root = tmp_path_factory.mktemp("atrial")
    for split, n in (("train", 5), ("val", 2)):
        for sub in ("image", "mask"):
            os.makedirs(root / split / sub)
        for i in range(n):
            vol, mask = _volume(i + (10 if split == "val" else 0))
            jnrrd.write_nrrd(str(root / split / "image" / f"v{i}.nrrd"), vol)
            jnrrd.write_nrrd(str(root / split / "mask" / f"v{i}.nrrd"), mask)
    return str(root)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.int16,
                                   np.float64])
@pytest.mark.parametrize("encoding", ["gzip", "raw"])
def test_nrrd_files_are_byte_equal_both_ways(tmp_path, dtype, encoding):
    vol = (np.random.default_rng(1).random((7, 5, 3)) * 200).astype(dtype)
    pj, pt = str(tmp_path / "j.nrrd"), str(tmp_path / "t.nrrd")
    jnrrd.write_nrrd(pj, vol, affine=AFFINE, encoding=encoding)
    tnrrd.write_nrrd(pt, vol, affine=AFFINE, encoding=encoding)
    with open(pj, "rb") as fj, open(pt, "rb") as ft:
        assert fj.read() == ft.read()
    for reader, path in ((tnrrd.read_nrrd, pj), (jnrrd.read_nrrd, pt)):
        arr, hdr = reader(path)
        assert arr.dtype == vol.dtype and np.array_equal(arr, vol)
        np.testing.assert_array_equal(hdr["affine"], AFFINE)


def test_intensity_transforms_are_bit_equal():
    vol, _ = _volume(3)
    np.testing.assert_array_equal(taug.znormalize(vol),
                                  jaug.znormalize(vol))
    np.testing.assert_array_equal(taug.znormalize(vol, "none"),
                                  jaug.znormalize(vol, "none"))
    np.testing.assert_array_equal(
        taug.bias_field(np.random.default_rng(4), vol.shape),
        jaug.bias_field(np.random.default_rng(4), vol.shape))
    # every branch of random_intensity across seeds: bias, noise, blur
    for seed in range(12):
        got = taug.random_intensity(np.random.default_rng(seed), vol)
        ref = jaug.random_intensity(np.random.default_rng(seed), vol)
        np.testing.assert_array_equal(got, ref, err_msg=str(seed))
    got_v, got_m = taug.train_augment_3d(np.random.default_rng(5), vol)
    ref_v, ref_m = jaug.train_augment_3d(np.random.default_rng(5), vol)
    np.testing.assert_array_equal(got_v, ref_v)
    assert got_m is None and ref_m is None


@pytest.mark.parametrize("regime", [20, 50, 100])
@pytest.mark.parametrize("seed", [0, 3])
def test_regime_split_picks_the_same_volumes(volumes, regime, seed):
    for sup in (True, False):
        kw = dict(split="train", sup=sup, regime=regime, seed=seed)
        got = tvol.VolumeDataset3D(os.path.join(volumes, "train"), **kw)
        ref = jvol.VolumeDataset3D(os.path.join(volumes, "train"), **kw)
        assert got.names == ref.names


def _assert_batches_equal(got, ref):
    assert len(got) == len(ref)
    for bg, br in zip(got, ref):
        assert set(bg) == set(br)
        for k in br:
            if isinstance(br[k], np.ndarray):
                assert bg[k].dtype == br[k].dtype
                np.testing.assert_array_equal(bg[k], br[k], err_msg=k)
            else:
                assert bg[k] == br[k], k


@pytest.mark.parametrize("split,batch_size", [("train", 2), ("val", 3)])
def test_patch_queue_batches_are_equal_for_two_epochs(volumes, split,
                                                      batch_size):
    kw = dict(split=split, regime=100, seed=7)
    sub = os.path.join(volumes, "val" if split == "val" else "train")
    qkw = dict(batch_size=batch_size, samples_per_volume=3, max_length=4,
               seed=7, shuffle_subjects=split == "train",
               shuffle_patches=split == "train")
    got = tvol.PatchQueue(tvol.VolumeDataset3D(sub, **kw), (16, 16, 8),
                          **qkw)
    ref = jvol.PatchQueue(jvol.VolumeDataset3D(sub, **kw), (16, 16, 8),
                          **qkw)
    assert len(got) == len(ref)
    for _ in range(2):
        _assert_batches_equal(list(got), list(ref))


def test_load_raw_relabels_and_keeps_the_affine(tmp_path):
    for sub in ("image", "mask"):
        os.makedirs(tmp_path / sub)
    vol, mask = _volume(2)
    tnrrd.write_nrrd(str(tmp_path / "image" / "a.nrrd"), vol, affine=AFFINE)
    tnrrd.write_nrrd(str(tmp_path / "mask" / "a.nrrd"), mask, affine=AFFINE)
    item = tvol.VolumeDataset3D(str(tmp_path), split="test").load_raw(0)
    assert set(np.unique(item["mask"])) == {0, 1}
    np.testing.assert_array_equal(item["affine"], AFFINE)


@pytest.mark.parametrize("shape,patch,overlap", [
    ((128, 128, 96), (96, 96, 80), (48, 48, 40)),
    ((144, 130, 88), (112, 112, 32), (56, 56, 16)),
    ((16, 16, 16), (16, 16, 16), (8, 8, 8)),
    ((20, 9, 33), (16, 16, 16), (4, 4, 4))])
def test_grid_locations_are_equal(shape, patch, overlap):
    assert t_grid(shape, patch, overlap) == j_grid(shape, patch, overlap)


def _noisy_masks(seed, n=3, shape=(24, 22, 20)):
    rng = np.random.default_rng(seed)
    preds, masks = [], []
    for i in range(n):
        xx, yy, zz = np.mgrid[: shape[0], : shape[1], : shape[2]]
        ball = ((xx - 12) ** 2 + (yy - 11) ** 2 + (zz - 10) ** 2) < 36
        masks.append(ball.astype(np.int64))
        pred = ball ^ (rng.random(shape) < 0.05)     # holes and specks
        pred[:3, :3, :3] = True                      # a second component
        preds.append(pred.astype(np.int64))
    preds[-1][:] = 0                                 # skipped by both
    return preds, masks


def test_postprocess_and_offline_distances_are_equal():
    preds, masks = _noisy_masks(0)
    for thr in (5, 500):
        for p in preds:
            got, ref = t_post(p, thr), j_post(p, thr)
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)
    post = [t_post(p, 500).astype(np.int64) for p in preds]
    for ps in (preds, post):
        assert t_offline(masks, ps) == j_offline(masks, ps)
    three = [np.where(m > 0, 1 + (np.arange(m.size).reshape(m.shape) % 2),
                      0) for m in masks]
    assert t_offline(three, three, 3) == j_offline(three, three, 3)
