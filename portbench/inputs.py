"""The benchmark's raw inputs, made from the run's seed: the items a
dataset on disk would hold (3D volumes with masks) and the names they
would have there.  NumPy only, so the program's
loaders and the plain reference read the same items.

Item ``i`` draws its shape and where its noise starts from
``SeedSequence([seed, ITEM_TAG, i])`` when it is read, so a set-up pays
only for the items its steps touch; its noise is a window of one bank of
noise per seed and item size (twice the item's size on every axis), made
once, so an item costs milliseconds rather than a full draw.  The tag keeps these draws apart from the
loaders' own ``SeedSequence([seed, epoch, i])`` streams.
"""

import threading

import numpy as np

ITEM_TAG = 0x17E3
BANK = 2 ** 20
_banks = {}
_lock = threading.Lock()


def _bank(seed, shape):
    """The seed's noise bank for items of ``shape``: standard normal
    float32."""
    key = (int(seed), tuple(shape))
    with _lock:
        if key not in _banks:
            rng = np.random.default_rng(np.random.SeedSequence(
                [int(seed), ITEM_TAG, BANK]))
            _banks[key] = rng.standard_normal(tuple(2 * s for s in shape),
                                              dtype=np.float32)
        return _banks[key]


def _window(rng, bank, shape):
    origin = [int(rng.integers(0, s + 1)) for s in shape]
    return bank[tuple(slice(o, o + s) for o, s in zip(origin, shape))]


def item_rng(seed, i):
    return np.random.default_rng(np.random.SeedSequence([int(seed), ITEM_TAG,
                                                         int(i)]))


def item_names(kind, n):
    """The file names of ``n`` items, in index order."""
    if kind == "volume3d":
        return [f"vol{i:03d}.nrrd" for i in range(n)]
    raise ValueError(f"unknown data kind {kind!r}")


def index_of(name):
    """The item index a name of :func:`item_names` carries."""
    digits = "".join(c for c in name.split(".")[0] if c.isdigit())
    return int(digits)


def volume_item(seed, i, shape):
    """(X, Y, Z) float32 volume and 0/1 uint8 mask: an ellipsoid on noise,
    with intensities of the order of an MRI's."""
    rng = item_rng(seed, i)
    shape = tuple(int(s) for s in shape)
    centre = [rng.uniform(0.35 * s, 0.65 * s) for s in shape]
    radii = [rng.uniform(0.12 * s, 0.25 * s) for s in shape]
    axes = [((np.arange(s, dtype=np.float32) - c) / r) ** 2
            for s, c, r in zip(shape, centre, radii)]
    dist = (axes[0][:, None, None] + axes[1][None, :, None]
            + axes[2][None, None, :])
    mask = (dist < 1.0).astype(np.uint8)
    img = _window(rng, _bank(seed, shape), shape) * np.float32(
        25.0)
    img += np.float32(60.0) + np.float32(120.0) * mask
    return img, mask
