"""Host-side 2D augmentations (``hebbax/data/augment2d.py``).

A.Resize(128,128) + A.Flip(p=.75) + A.Transpose(p=.5) +
A.RandomRotate90(p=1) for training and Resize only for val/test, then
A.Normalize(mean, std, max=255), with the same draws from the caller's
``np.random.Generator`` as hebbax, so a seed gives the same images.

cv2 is imported only inside a resize that is actually needed: 128x128
inputs never reach it.
"""

from typing import Tuple

import numpy as np


def resize_pair(image, mask, size: Tuple[int, int]):
    """Resize (H,W) to size=(h,w); linear for image, nearest for mask."""
    h, w = size
    if image.shape[:2] != (h, w):
        import cv2
        image = cv2.resize(image, (w, h), interpolation=cv2.INTER_LINEAR)
    if mask is not None and mask.shape[:2] != (h, w):
        import cv2
        mask = cv2.resize(mask, (w, h), interpolation=cv2.INTER_NEAREST)
    return image, mask


def _flip(arr, d):
    if d == 0:        # vertical (around x-axis)
        return arr[::-1]
    if d == 1:        # horizontal
        return arr[:, ::-1]
    return arr[::-1, ::-1]


def train_augment(rng: np.random.Generator, image, mask,
                  size: Tuple[int, int] = (128, 128)):
    """Full training augmentation pipeline."""
    image, mask = resize_pair(image, mask, size)
    if rng.random() < 0.75:
        d = int(rng.integers(-1, 2))
        image = _flip(image, d)
        mask = _flip(mask, d) if mask is not None else None
    if rng.random() < 0.5:
        image = np.swapaxes(image, 0, 1)
        mask = np.swapaxes(mask, 0, 1) if mask is not None else None
    k = int(rng.integers(0, 4))
    if k:
        image = np.rot90(image, k)
        mask = np.rot90(mask, k) if mask is not None else None
    return np.ascontiguousarray(image), (
        np.ascontiguousarray(mask) if mask is not None else None)


def eval_augment(image, mask, size: Tuple[int, int] = (128, 128)):
    """val/test: resize only."""
    return resize_pair(image, mask, size)


def normalize(image, mean, std, max_pixel_value: float = 255.0):
    """A.Normalize parity: (img/max - mean)/std, channels-last float32."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    img = image.astype(np.float32) / max_pixel_value
    if img.ndim == 2:
        img = img[..., None]
    return (img - mean) / std
