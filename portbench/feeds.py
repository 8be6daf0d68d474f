"""The port's own datasets and loaders over the benchmark's inputs
(:mod:`portbench.inputs`), as its CLIs build them over files: a
``VolumeDataset3D`` whose items come from the seed instead of NRRD
files, under ``PatchQueue``.

``Feed`` wraps a loader handed to the trainer: it times each ``next()``
and, when it may stop, ends its epoch once a batch cap or a deadline is
reached, so a window ends after that epoch's own end read."""

import os
import time

import numpy as np

from hebbax_torch.data.volumes3d import PatchQueue, VolumeDataset3D

from . import inputs


class Volumes(VolumeDataset3D):
    """A ``VolumeDataset3D`` over a directory of empty placeholder files
    (its listing and regime split are the port's own), whose volumes come
    from the seed, made at every read as the port reads a file at every
    one."""

    def __init__(self, root, seed, shape, regime=100, sup=True):
        super().__init__(root, "image", split="train", sup=sup,
                         regime=regime, seed=seed, normalize="mean",
                         num_classes=2)
        self.item_seed = seed
        self.shape = tuple(shape)

    def load_raw(self, index):
        name = self.names[index]
        img, mask = inputs.volume_item(self.item_seed, inputs.index_of(name),
                                       self.shape)
        item = {"image": img, "id": name, "affine": np.eye(4)}
        if self.sup:
            item["mask"] = mask.astype(np.int32)
        return item


def placeholder_dir(root, names):
    """``<root>/image/<name>`` for each name, empty: the listing a
    ``VolumeDataset3D`` reads."""
    d = os.path.join(root, "image")
    os.makedirs(d, exist_ok=True)
    for n in names:
        open(os.path.join(d, n), "w").close()
    return root


class Feed:
    """A loader handed to the trainer.  ``wait_s`` sums the seconds spent
    in ``next()``; with ``stoppable``, an epoch ends before a batch once
    ``cap`` batches of it were given or ``deadline`` (a
    ``time.perf_counter()`` value) has passed.  ``span`` (a context
    manager factory or None) wraps each ``next()``."""

    def __init__(self, loader, stoppable):
        self.loader = loader
        self.stoppable = stoppable
        self.cap = None
        self.deadline = None
        self.wait_s = 0.0
        self.span = None

    def __len__(self):
        return len(self.loader)

    def _stop(self, given):
        if not self.stoppable:
            return False
        if self.cap is not None and given >= self.cap:
            return True
        return self.deadline is not None and time.perf_counter() >= (
            self.deadline)

    def __iter__(self):
        it = iter(self.loader)
        given = 0
        try:
            while not self._stop(given):
                t0 = time.perf_counter()
                if self.span is None:
                    batch = next(it, None)
                else:
                    with self.span("pb.data_wait"):
                        batch = next(it, None)
                self.wait_s += time.perf_counter() - t0
                if batch is None:
                    return
                given += 1
                yield batch
        finally:
            it.close()


def make_loaders(cfg, traffic, args, work_dir):
    """The loaders the mix's trainer takes, each a :class:`Feed`, and an
    empty 'val': the semi trainer's 'train_sup' and 'train_unsup', or the
    'train' of a trainer over labelled patches alone.  The loader an
    epoch runs over ('train_sup', 'train') is the one that stops."""
    data, flags = cfg["data"], traffic["flags"]
    seed = args.seed
    root = placeholder_dir(os.path.join(work_dir, "volumes"),
                           inputs.item_names(data["kind"],
                                             data["train_volumes"]))

    def loader(sup):
        ds = Volumes(root, seed, data["volume_shape"],
                     regime=flags["regime"], sup=sup)
        return PatchQueue(ds, tuple(cfg["patch_size"]),
                          batch_size=flags["batch_size"],
                          samples_per_volume=flags["samples_per_volume_train"],
                          max_length=flags["queue_length"], seed=seed,
                          shuffle_subjects=True, shuffle_patches=True)

    if traffic["trainer"] != "semi":
        return {"train": Feed(loader(True), True), "val": []}
    return {"train_sup": Feed(loader(True), True),
            "train_unsup": Feed(loader(False), False), "val": []}
