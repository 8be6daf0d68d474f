"""Random-walk superpixel pseudo-masks (``hebbax/ops/superpix.py``),
host-side numpy: seed a random pixel and flood-fill through neighbours
whose channel-summed absolute difference to the current pixel is below
``thr`` (8-neighbourhood in 2D, 26 in 3D).

The fill is a vectorized frontier expansion: per-shift edge maps
|im - shift(im)|_1 < thr, then region <- region OR (shift(region) AND
edge_ok) to a fixpoint.  The same ``np.random.Generator`` draws give the
same uint8 masks as hebbax's.
"""

import itertools

import numpy as np


def _shift(arr, offs, fill=False):
    """Shift with edge fill (no wraparound)."""
    out = np.full_like(arr, fill)
    src = [slice(max(-o, 0), arr.shape[d] - max(o, 0))
           for d, o in enumerate(offs)]
    dst = [slice(max(o, 0), arr.shape[d] + min(o, 0))
           for d, o in enumerate(offs)]
    out[tuple(dst)] = arr[tuple(src)]
    return out


def superpix_region(rng, image, thr: float = 0.01,
                    nd: int = None) -> np.ndarray:
    """image: (spatial..., C) channels-last or bare (spatial...).  ``nd``
    disambiguates rank (default: ndim-1 if a trailing channel axis is
    plausible, i.e. size <= 8, else ndim).  Returns the uint8 flood-fill
    component of a random seed."""
    im = np.asarray(image, np.float32)
    if nd is None:
        nd = im.ndim - 1 if im.shape[-1] <= 8 and im.ndim > 2 else im.ndim
    spatial = im.shape[:nd]
    if im.ndim == nd:
        im = im[..., None]
    seed = tuple(int(rng.integers(0, s)) for s in spatial)

    offsets = [o for o in itertools.product((-1, 0, 1), repeat=nd)
               if any(o)]
    edge_ok = {}
    for o in offsets:
        diff = np.abs(im - _shift(im, o, fill=np.inf)).sum(axis=-1)
        edge_ok[o] = diff < thr  # edge from shifted-source into this cell

    region = np.zeros(spatial, bool)
    region[seed] = True
    frontier = region
    while frontier.any():
        grown = np.zeros(spatial, bool)
        for o in offsets:
            grown |= _shift(frontier, o) & edge_ok[o]
        frontier = grown & ~region
        region |= frontier
    return region.astype(np.uint8)


def superpix_batch(rng, images, thr: float = 0.01,
                   nd: int = None) -> np.ndarray:
    """(N, spatial..., C) channels-last -> (N, spatial...) uint8
    pseudo-masks."""
    return np.stack([superpix_region(rng, im, thr, nd) for im in images])
