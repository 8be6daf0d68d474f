"""3D volume dataset and patch queue (``hebbax/data/volumes3d.py``).

* Volumes are NRRD files under <root>/{train,val}/{<input1>,mask}; with
  ``sdf=True`` also the signed distance maps ``mask_sdf1`` (and
  ``mask_sdf2`` for 3 classes) that DTC trains against, flipped and
  cropped with the image.
* 255 -> 1 mask relabel for binary tasks.
* Regime split: ``random.Random(seed).shuffle`` of the listdir order, the
  first ceil(N*regime/100) labelled — 3D keeps the shuffled order (unlike
  2D, there is no re-sort).
* PatchQueue mirrors tio.Queue(max_length, samples_per_volume,
  UniformSampler(patch_size), shuffle_subjects, shuffle_patches): per
  epoch, subjects in shuffled order, samples_per_volume uniform patches
  each, buffered to max_length and shuffled before batching.  Every draw
  comes from one ``SeedSequence([seed, epoch])`` generator, in hebbax's
  order, so both packages give the same batches for a seed.
"""

import math
import os
import random
from typing import Optional, Sequence, Tuple

import numpy as np

from . import augment3d
from .loader import collate
from .nrrd_io import read_nrrd


class VolumeDataset3D:
    def __init__(self, data_dir: str, input1: str = "image",
                 split: str = "train", sup: bool = True,
                 regime: float = 100, seed: int = 0,
                 normalize: str = "mean", num_classes: int = 2,
                 sdf: bool = False, fmt: str = ".nrrd"):
        image_dir = os.path.join(data_dir, input1)
        names = [n for n in os.listdir(image_dir) if n.endswith(fmt)]
        if regime < 100:
            num = math.ceil(len(names) / 100 * regime)
            random.Random(seed).shuffle(names)
            names = names[:num] if sup else names[num:]
        self.names = names
        self.data_dir = data_dir
        self.input1 = input1
        self.sup = sup
        self.sdf = sdf
        self.num_classes = num_classes
        self.normalize = normalize
        self.train = split == "train"

    def __len__(self):
        return len(self.names)

    def load_raw(self, index: int):
        """Unnormalized volume, mask (and SDF maps) and affine (for
        sliding-window eval and offline tools)."""
        name = self.names[index]
        img, header = read_nrrd(
            os.path.join(self.data_dir, self.input1, name))
        item = {"image": img.astype(np.float32), "id": name,
                "affine": header["affine"]}
        if self.sup:
            mask, _ = read_nrrd(os.path.join(self.data_dir, "mask", name))
            mask = mask.astype(np.int32)
            if self.num_classes == 2:
                mask[mask == 255] = 1
            item["mask"] = mask
            if self.sdf:
                names = ["mask_sdf1"] + (["mask_sdf2"]
                                         if self.num_classes == 3 else [])
                for sub, key in zip(names, ("mask_sdf", "mask_sdf2")):
                    sdf, _ = read_nrrd(os.path.join(self.data_dir, sub,
                                                    name))
                    item[key] = sdf.astype(np.float32)
        return item

    def get_volume(self, index: int,
                   rng: Optional[np.random.Generator] = None):
        """Augmented (train) or znormalized (eval) full volume."""
        item = self.load_raw(index)
        if self.train:
            rng = rng or np.random.default_rng()
            # joint flip of every spatial array (image, mask, SDF maps)
            shape = item["image"].shape
            if rng.random() < 0.5:
                for k, v in item.items():
                    if isinstance(v, np.ndarray) and v.shape == shape:
                        item[k] = np.ascontiguousarray(np.flip(v, 0))
            vol = augment3d.random_intensity(rng, item["image"])
            item["image"] = np.ascontiguousarray(
                augment3d.znormalize(vol, self.normalize))
        else:
            item["image"] = augment3d.znormalize(item["image"],
                                                 self.normalize)
        return item


def sample_patch(rng, volume_item: dict, patch_size: Sequence[int]):
    """UniformSampler: origin ~ U{0, size-patch} per dim; crops every
    spatial array in the item."""
    img = volume_item["image"]
    shape = img.shape
    origin = [int(rng.integers(0, s - p + 1)) if s > p else 0
              for s, p in zip(shape, patch_size)]
    sl = tuple(slice(o, o + p) for o, p in zip(origin, patch_size))
    out = {"id": volume_item["id"], "location": origin}
    for k, v in volume_item.items():
        if isinstance(v, np.ndarray) and v.shape[:3] == shape:
            out[k] = np.ascontiguousarray(v[sl])
    return out


class PatchQueue:
    """tio.Queue-equivalent iterable of patch batches."""

    def __init__(self, dataset: VolumeDataset3D,
                 patch_size: Tuple[int, int, int], batch_size: int = 1,
                 samples_per_volume: int = 4, max_length: int = 48,
                 seed: int = 0, shuffle_subjects: bool = True,
                 shuffle_patches: bool = True):
        self.dataset = dataset
        self.patch_size = tuple(patch_size)
        self.batch_size = batch_size
        self.samples_per_volume = samples_per_volume
        self.max_length = max_length
        self.seed = seed
        self.shuffle_subjects = shuffle_subjects
        self.shuffle_patches = shuffle_patches
        self._epoch = 0

    def __len__(self):
        total = len(self.dataset) * self.samples_per_volume
        return (total + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        epoch = self._epoch
        self._epoch += 1
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch]))
        order = np.arange(len(self.dataset))
        if self.shuffle_subjects:
            rng.shuffle(order)
        buffer = []
        pending = []

        def flush(force=False):
            while len(pending) >= self.batch_size or (force and pending):
                batch = pending[: self.batch_size]
                del pending[: self.batch_size]
                yield collate(batch)

        for vol_idx in order:
            item = self.dataset.get_volume(int(vol_idx), rng)
            for _ in range(self.samples_per_volume):
                buffer.append(sample_patch(rng, item, self.patch_size))
            if len(buffer) >= self.max_length:
                if self.shuffle_patches:
                    rng.shuffle(buffer)
                pending.extend(buffer)
                buffer.clear()
                yield from flush()
        if self.shuffle_patches:
            rng.shuffle(buffer)
        pending.extend(buffer)
        yield from flush(force=True)
