"""2D folder dataset with label-regime splitting
(``hebbax/data/dataset2d.py``).

Layout ``<root>/{train,val}/{<input1>,mask}`` with matching filenames;
masks binarized and reduced to one channel.  ``regime_split`` picks the
same labelled files as hebbax: ``os.listdir`` order shuffled by
``random.Random(seed)``, the first ``ceil(N*regime/100)`` labelled, the
chosen list sorted.  Items stay channels-last numpy, exactly as hebbax
builds them; the train step moves a batch to the device as NCHW.

PIL is imported only by the PNG decoder, so a subclass that overrides
:meth:`SegDataset2D._decoded` with in-memory arrays needs no PIL.
"""

import math
import os
import random
from typing import Optional, Sequence, Tuple

import numpy as np

from . import augment2d


def regime_split(filenames: Sequence[str], regime: float, seed: int,
                 sup: bool):
    """The labelled/unlabelled file selection; ``filenames`` must be in
    os.listdir order."""
    names = list(filenames)
    if regime >= 100:
        return names
    num = math.ceil(len(names) / 100 * regime)
    shuffled = names.copy()
    random.Random(seed).shuffle(shuffled)
    chosen = shuffled[:num] if sup else shuffled[num:]
    return sorted(chosen)


def _load_image(path):
    from PIL import Image
    img = Image.open(path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.array(img)


def _load_mask(path):
    from PIL import Image
    mask = np.array(Image.open(path))
    mask = (mask > 0).astype(np.uint8)
    if mask.ndim > 2:
        mask = mask[:, :, 0]
    return mask


class SegDataset2D:
    """Items are dicts with 'image' (H,W,C f32, normalized), 'mask'
    (H,W int32, absent when sup=False) and 'id'.  ``host_augment = False``
    makes a train item resize + normalize only: the train augmentation
    then runs on the device (:mod:`hebbax_torch.ops.augment_device`)."""

    host_augment = True

    def __init__(self, data_dir: str, input1: str, mean, std,
                 split: str = "train", sup: bool = True,
                 regime: float = 100, seed: int = 0,
                 size: Tuple[int, int] = (128, 128),
                 cache_decoded: bool = True):
        image_dir = os.path.join(data_dir, input1)
        names = regime_split(os.listdir(image_dir), regime, seed, sup)
        self.image_paths = [os.path.join(image_dir, n) for n in names]
        self.mask_paths = ([os.path.join(data_dir, "mask", n)
                            for n in names] if sup else None)
        self.sup = sup
        self.train = split == "train"
        self.mean, self.std = mean, std
        self.size = size
        self.seed = seed
        self.cache_decoded = cache_decoded
        self._cache = {}

    def __len__(self):
        return len(self.image_paths)

    def _decoded(self, index: int):
        if self.cache_decoded and index in self._cache:
            return self._cache[index]
        img = _load_image(self.image_paths[index])
        mask = _load_mask(self.mask_paths[index]) if self.sup else None
        if self.cache_decoded:
            self._cache[index] = (img, mask)
        return img, mask

    def get(self, index: int, rng: Optional[np.random.Generator] = None):
        img, mask = self._decoded(index)
        if self.train and self.host_augment:
            rng = rng or np.random.default_rng()
            img, mask = augment2d.train_augment(rng, img, mask, self.size)
        else:
            img, mask = augment2d.eval_augment(img, mask, self.size)
        img = augment2d.normalize(img, self.mean, self.std)
        item = {"image": img,
                "id": os.path.basename(self.image_paths[index])}
        if mask is not None:
            item["mask"] = mask.astype(np.int32)
        return item
