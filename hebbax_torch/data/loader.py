"""Host-side batch loader with threaded prefetch (``hebbax/data/loader.py``).

A thread pool decodes and augments items; batches follow listdir order or
a per-epoch permutation drawn from ``SeedSequence([seed, epoch])``, and
item ``i`` augments with ``SeedSequence([seed, epoch, i])`` — the same
draws as hebbax, so both packages see the same batches for a seed.
"""

import concurrent.futures
import queue
import threading
from typing import Iterator

import numpy as np


def collate(items):
    """Stack item dicts into a batch dict (numpy)."""
    batch = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], np.ndarray):
            batch[key] = np.stack(vals)
        else:
            batch[key] = vals
    return batch


class Loader:
    """Iterable over batches of a SegDataset2D-like dataset (anything with
    __len__ and .get(index, rng))."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, num_workers: int = 8, prefetch: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self._epoch = 0

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def _indices(self, epoch: int):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch])).shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[dict]:
        epoch = self._epoch
        self._epoch += 1
        idx = self._indices(epoch)
        nb = len(self)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        pool = concurrent.futures.ThreadPoolExecutor(self.num_workers)

        def load_item(i):
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch, int(i)]))
            return self.dataset.get(int(i), rng)

        def producer():
            try:
                for b in range(nb):
                    sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
                    items = list(pool.map(load_item, sel))
                    out_q.put(collate(items))
            except Exception as exc:  # surfaced by the consumer
                out_q.put(exc)
            finally:
                out_q.put(None)
                pool.shutdown(wait=False)

        threading.Thread(target=producer, daemon=True).start()
        while True:
            item = out_q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item
