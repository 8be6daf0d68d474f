"""The first batches of a training epoch, worked out again from the seed:
a frozen copy of the draws the port's patch queue makes
(``hebbax_torch``'s ``data/volumes3d.py`` and ``data/augment3d.py``,
themselves hebbax's and the reference repository's), so the reference
sees the batches the timed path consumed without reading anything the
program made.

The volumes of the regime (the listing shuffled by
``random.Random(seed)``, kept in that order); per epoch one generator
from ``SeedSequence([seed, epoch])`` draws the volume order, each
volume's flip (axis 0, p 0.5), bias field (p 0.2), noise or blur (p 0.2)
and z-normalisation over the voxels above the mean, then
``samples_per_volume`` uniform patches; patches are buffered to
``queue_length``, shuffled and batched.
"""

import itertools
import math
import random

import numpy as np
import torch
from scipy import ndimage

from .. import inputs


def regime_3d(names, regime, seed, sup):
    names = list(names)
    if regime < 100:
        num = math.ceil(len(names) / 100 * regime)
        random.Random(seed).shuffle(names)
        names = names[:num] if sup else names[num:]
    return names


def znormalize(v):
    v = v.astype(np.float32)
    vals = v[v > v.mean()]
    std = vals.std()
    return (v - vals.mean()) / (std if std != 0 else 1.0)


def bias_field(rng, shape, lo=0.12, hi=0.15, order=2):
    ranges = [np.linspace(-1, 1, s, dtype=np.float32) for s in shape]
    x, y, z = np.meshgrid(*ranges, indexing="ij")
    field = np.zeros(shape, np.float32)
    for a, b, c in itertools.product(range(order + 1), repeat=3):
        if 0 < a + b + c <= order:
            field += rng.uniform(lo, hi) * (x ** a) * (y ** b) * (z ** c)
    return np.exp(field)


def intensity(rng, v):
    if rng.random() < 0.2:
        v = v * bias_field(rng, v.shape)
    if rng.random() < 0.2:
        if rng.random() < 0.5:
            std = rng.uniform(0, 0.25)
            v = v + rng.normal(0.0, max(std, 1e-8), v.shape).astype(
                np.float32)
        else:
            v = ndimage.gaussian_filter(v, sigma=[rng.uniform(0, 1.0)
                                                  for _ in range(v.ndim)])
    return v.astype(np.float32)


def _volume(rng, cfg, seed, name, sup):
    img, mask = inputs.volume_item(seed, inputs.index_of(name),
                                   cfg["data"]["volume_shape"])
    img = img.astype(np.float32)
    mask = mask.astype(np.int32) if sup else None
    if rng.random() < 0.5:
        img = np.ascontiguousarray(np.flip(img, 0))
        if mask is not None:
            mask = np.ascontiguousarray(np.flip(mask, 0))
    img = np.ascontiguousarray(znormalize(intensity(rng, img)))
    return img, mask


def _patch(rng, img, mask, size):
    origin = [int(rng.integers(0, s - p + 1)) if s > p else 0
              for s, p in zip(img.shape, size)]
    sl = tuple(slice(o, o + p) for o, p in zip(origin, size))
    return img[sl].copy(), None if mask is None else mask[sl].copy()


def batches_3d(cfg, flags, seed, names, n_batches, sup, epoch=0):
    """The first ``n_batches`` (image (B, 1, *patch) float32, mask int64
    or None) batches of the patch queue's ``epoch`` over the volumes
    ``names`` (the listing of the split's directory)."""
    names = regime_3d(names, flags["regime"], seed, sup)
    size = tuple(cfg["patch_size"])
    b, spv = flags["batch_size"], flags["samples_per_volume_train"]
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    order = np.arange(len(names))
    rng.shuffle(order)
    out, buffer, pending = [], [], []

    def drain(force):
        while len(out) < n_batches and (len(pending) >= b
                                        or (force and pending)):
            chunk = pending[:b]
            del pending[:b]
            img = torch.from_numpy(np.stack([p[0] for p in chunk]))[:, None]
            mask = (None if chunk[0][1] is None else
                    torch.from_numpy(np.stack([p[1] for p in chunk])).long())
            out.append({"image": img, "mask": mask})

    for v in order:
        img, mask = _volume(rng, cfg, seed, names[v], sup)
        for _ in range(spv):
            buffer.append(_patch(rng, img, mask, size))
        if len(buffer) >= flags["queue_length"]:
            rng.shuffle(buffer)
            pending.extend(buffer)
            buffer.clear()
            drain(False)
        if len(out) >= n_batches:
            return out
    rng.shuffle(buffer)
    pending.extend(buffer)
    drain(True)
    return out


def step_batches(cfg, traffic, seed, names, n_steps):
    """The batches each of the first ``n_steps`` steps of the mix's
    trainer takes in a run of ``seed``: (labelled, unlabelled) for the
    semi trainer, (batch,) for a trainer over one labelled loader."""
    if cfg["data"]["kind"] != "volume3d":
        raise ValueError(f"no batches of {cfg['data']['kind']!r} data")
    flags = traffic["flags"]

    def queue(sup):
        return batches_3d(cfg, flags, seed, names, n_steps, sup)

    if traffic["trainer"] == "semi":
        return list(zip(queue(True), queue(False)))
    return [(b,) for b in queue(True)]
