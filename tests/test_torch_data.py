"""The port's data pipeline, losses and metrics held against hebbax's.

Same PNG folder, same seed: ``regime_split`` picks the same files, the
threaded ``Loader`` yields the same batches (order and augmentation
draws), so pretraining and fine-tuning see the same data in both
packages.  Losses and the threshold sweep take the same numpy inputs
(channels-last for hebbax, channels-first for the port).

Tolerances: data is exact (same numpy code on the same draws); losses
rtol 1e-6 (float32 softmax and sums over 2*16*16 pixels); the sweep is
exact (counts of the same thresholded probabilities, which both compute
as float32 softmax — the probabilities are built well away from every
threshold so rounding cannot flip a pixel); HD95/ASSD exact (the same
scipy calls on the same masks).
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from hebbax.data import Loader as JLoader
from hebbax.data import SegDataset2D as JDataset
from hebbax.data import regime_split as j_regime_split
from hebbax.ops import losses as jlosses
from hebbax.ops import metrics as jmetrics
from hebbax.ops.distance import evaluate_distance_binary as j_dist
from hebbax_torch.data import Loader, SegDataset2D, regime_split
from hebbax_torch.ops import losses as tlosses
from hebbax_torch.ops import metrics as tmetrics
from hebbax_torch.ops.distance import evaluate_distance_binary as t_dist

torch.set_num_threads(2)

MEAN, STD = [0.787803, 0.512017, 0.784938], [0.428206, 0.507778, 0.426366]


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    rng = np.random.default_rng(11)
    for split, n in (("train", 7), ("val", 3)):
        os.makedirs(root / split / "image")
        os.makedirs(root / split / "mask")
        for i in range(n):
            img = rng.integers(0, 255, (24, 20, 3)).astype(np.uint8)
            mask = (rng.random((24, 20)) < 0.3).astype(np.uint8) * 255
            Image.fromarray(img).save(root / split / "image" / f"im{i}.png")
            Image.fromarray(mask).save(root / split / "mask" / f"im{i}.png")
    return str(root)


@pytest.mark.parametrize("regime", [5, 20, 50, 100])
@pytest.mark.parametrize("sup", [True, False])
def test_regime_split_picks_the_same_files(regime, sup):
    names = [f"img_{i:03d}.png" for i in np.random.default_rng(2).
             permutation(40)]
    for seed in (0, 1, 7):
        assert (regime_split(names, regime, seed, sup)
                == j_regime_split(names, regime, seed, sup))


@pytest.mark.parametrize("split,regime", [("train", 50), ("train", 100),
                                          ("val", 100)])
def test_loader_yields_the_same_batches(folder, split, regime):
    d = os.path.join(folder, "val" if split == "val" else "train")
    kw = dict(split=split, sup=True, regime=regime, seed=3,
              size=(16, 16))
    ours = Loader(SegDataset2D(d, "image", MEAN, STD, **kw), 2,
                  shuffle=split == "train", seed=3, num_workers=2)
    ref = JLoader(JDataset(d, "image", MEAN, STD, **kw), 2,
                  shuffle=split == "train", seed=3, num_workers=2)
    assert len(ours) == len(ref)
    for _ in range(2):                       # two epochs: new draws each
        for a, b in zip(ours, ref):
            assert a["id"] == b["id"]
            np.testing.assert_array_equal(a["image"], b["image"])
            np.testing.assert_array_equal(a["mask"], b["mask"])


def _logits_and_target(seed, n_cls=2):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((2, 16, 16, n_cls)) * 3).astype(
        np.float32)
    target = rng.integers(0, n_cls, (2, 16, 16)).astype(np.int32)
    target[0, :2] = -1                               # ignored pixels
    return logits, target


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


@pytest.mark.parametrize("loss", ["dice", "crossentropy"])
@pytest.mark.parametrize("n_cls", [2, 3])
def test_losses_match(loss, n_cls):
    logits, target = _logits_and_target(n_cls, n_cls)
    ref = jlosses.segmentation_loss(loss)(jnp.asarray(logits),
                                          jnp.asarray(target))
    got = tlosses.segmentation_loss(loss)(_nchw(logits),
                                          torch.from_numpy(target).long())
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_dice_ignores_all_invalid_samples():
    logits, target = _logits_and_target(5)
    target[1] = -1
    ref = jlosses.dice_loss(jnp.asarray(logits), jnp.asarray(target))
    got = tlosses.dice_loss(_nchw(logits), torch.from_numpy(target).long())
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_threshold_sweep_matches():
    rng = np.random.default_rng(9)
    # foreground probabilities on a 0.01 grid offset by 0.005, so no pixel
    # lies within rounding of one of the sweep's 0.02-spaced thresholds
    p = (rng.integers(0, 99, (3, 16, 16)) / 100.0 + 0.005).astype(
        np.float32)
    logits = np.stack([np.zeros_like(p), np.log(p / (1 - p))], -1)
    target = (rng.random((3, 16, 16)) < 0.4).astype(np.int32)
    ref = jmetrics.SweepAccumulator()
    ours = tmetrics.SweepAccumulator()
    for i in range(3):
        ref.update(jnp.asarray(logits[i:i + 1]), jnp.asarray(target[i:i + 1]))
        ours.update(_nchw(logits[i:i + 1]), torch.from_numpy(target[i:i + 1]))
    assert ours.finalize() == ref.finalize()


def test_distance_metrics_match():
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[:32, :32]
    masks = np.stack([((yy - 12) ** 2 + (xx - 15) ** 2 < 60),
                      ((yy - 20) ** 2 + (xx - 9) ** 2 < 30)]).astype(np.int32)
    probs = np.clip(masks * 0.7 + rng.random(masks.shape) * 0.4, 0, 1)
    for thr in ([0.5], [0.2, 0.6, 0.8]):
        assert t_dist(probs, masks, thr) == j_dist(probs, masks, thr)
