"""3D augmentations with torchio semantics (numpy/scipy, on the host): a
copy of ``hebbax/data/augment3d.py``.  The same numpy ``Generator`` calls
in the same order give the same arrays to the bit.

The reference pipeline: train = RandomFlip() +
RandomBiasField(coefficients=(0.12,0.15), order=2, p=0.2) +
OneOf{RandomNoise, RandomBlur(std=1)}(p=0.2) +
ZNormalization(masking_method=mean); val/test = ZNormalization only.
Each transform is reimplemented with torchio's sampling distributions:

  RandomFlip      : axis 0 only, p=0.5 (tio defaults)
  RandomBiasField : order-2 polynomial bias field exp(sum c * x^a y^b z^c)
                    with c ~ U(0.12, 0.15) per monomial
  RandomNoise     : additive N(mean~U(0,0), std~U(0, 0.25)) (tio defaults)
  RandomBlur      : per-axis gaussian blur, std ~ U(0, 1)
  ZNormalization(mean): stats over voxels above the volume mean
"""

import itertools

import numpy as np
from scipy import ndimage


def znormalize(volume, masking: str = "mean"):
    """torchio ZNormalization: (v - mean)/std with stats over the mask
    region (masking='mean' -> voxels > volume mean)."""
    v = volume.astype(np.float32)
    if masking == "mean":
        mask = v > v.mean()
    else:
        mask = np.ones_like(v, bool)
    vals = v[mask]
    std = vals.std()
    if std == 0:
        std = 1.0
    return (v - vals.mean()) / std


def random_flip(rng, volume, mask=None, axes=(0,), p=0.5):
    for ax in axes:
        if rng.random() < p:
            volume = np.flip(volume, ax)
            if mask is not None:
                mask = np.flip(mask, ax)
    return volume, mask


def bias_field(rng, shape, coefficients=(0.12, 0.15), order=2):
    """Multiplicative exp-polynomial bias field (tio RandomBiasField)."""
    ranges = [np.linspace(-1, 1, s, dtype=np.float32) for s in shape]
    x, y, z = np.meshgrid(*ranges, indexing="ij")
    field = np.zeros(shape, np.float32)
    lo, hi = coefficients
    for a, b, c in itertools.product(range(order + 1), repeat=3):
        if 0 < a + b + c <= order:
            coef = rng.uniform(lo, hi)
            field += coef * (x ** a) * (y ** b) * (z ** c)
    return np.exp(field)


def random_intensity(rng, volume, p_bias=0.2, p_noise_blur=0.2):
    """BiasField(p=.2) then OneOf{Noise, Blur}(p=.2)."""
    if rng.random() < p_bias:
        volume = volume * bias_field(rng, volume.shape)
    if rng.random() < p_noise_blur:
        if rng.random() < 0.5:
            std = rng.uniform(0, 0.25)
            volume = volume + rng.normal(0.0, max(std, 1e-8), volume.shape
                                         ).astype(np.float32)
        else:
            stds = [rng.uniform(0, 1.0) for _ in range(volume.ndim)]
            volume = ndimage.gaussian_filter(volume, sigma=stds)
    return volume.astype(np.float32)


def train_augment_3d(rng, volume, mask=None, normalize: str = "mean"):
    volume = volume.astype(np.float32)
    volume, mask = random_flip(rng, volume, mask)
    volume = random_intensity(rng, volume)
    volume = znormalize(volume, normalize)
    out_mask = None if mask is None else np.ascontiguousarray(mask)
    return np.ascontiguousarray(volume), out_mask


def eval_augment_3d(volume, mask=None, normalize: str = "mean"):
    return znormalize(volume, normalize), mask
