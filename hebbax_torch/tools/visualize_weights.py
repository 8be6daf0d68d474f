"""A snapshot's first-layer filters as a PNG grid (hebbax's
``tools/visualize_weights.py``): the first kernel with spatial extent in
the snapshot's order (or the one under ``--layer``), each filter min-max
normalized, channels averaged unless 1 or 3, one pixel of white between
filters, scaled up ``--scale`` times (nearest).

    python -m hebbax_torch.tools.visualize_weights --snapshot <ckpt> \
        [--layer encoder.in_conv.conv1] [--out filters.png]

The snapshot's variable tree is flax's (kernels ``(kh, kw, I, O)``); it
is walked here in the order it was stored, as ``flax.traverse_util.
flatten_dict`` walks it.
"""

import argparse

import numpy as np

from ..utils.checkpoint import load_snapshot
from ..utils.images import save_png


def flatten(tree, prefix=()):
    """{path tuple: leaf} of a nested dict, depth first in its order."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def first_conv_kernel(params, path=None):
    flat = flatten(params)
    if path:
        want = tuple(path.split("."))
        for p, v in flat.items():
            if p[: len(want)] == want and p[-1] == "kernel":
                return p, v
        raise KeyError(path)
    for p, v in flat.items():
        if p[-1] == "kernel" and v.ndim == 4 and v.shape[0] > 1:
            return p, v
    raise KeyError("no 2D conv kernel found")


def filter_grid(kernel):
    """uint8 (H, W) or (H, W, 3) grid of the (kh, kw, I, O) kernel's
    filters."""
    k = np.asarray(kernel)
    kh, kw, ci, co = k.shape
    filters = np.transpose(k, (3, 0, 1, 2))   # (O, kh, kw, I)
    lo = filters.min(axis=(1, 2, 3), keepdims=True)
    hi = filters.max(axis=(1, 2, 3), keepdims=True)
    filters = (filters - lo) / np.maximum(hi - lo, 1e-8)
    if ci not in (1, 3):
        filters = filters.mean(axis=-1, keepdims=True)
        ci = 1
    cols = int(np.ceil(np.sqrt(co)))
    rows = int(np.ceil(co / cols))
    grid = np.ones((rows * (kh + 1) + 1, cols * (kw + 1) + 1,
                    3 if ci == 3 else 1), np.float32)
    for idx in range(co):
        r, c = divmod(idx, cols)
        grid[1 + r * (kh + 1): 1 + r * (kh + 1) + kh,
             1 + c * (kw + 1): 1 + c * (kw + 1) + kw] = filters[idx]
    img = (grid * 255).astype(np.uint8)
    return img[..., 0] if img.shape[-1] == 1 else img


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--snapshot", required=True)
    parser.add_argument("--layer", default=None,
                        help="dotted module path (default: first conv)")
    parser.add_argument("--out", default="filters.png")
    parser.add_argument("--scale", default=16, type=int)
    args = parser.parse_args(argv)

    variables, _ = load_snapshot(args.snapshot)
    path, kernel = first_conv_kernel(variables["params"], args.layer)
    print(f"layer {'.'.join(path)}: kernel {np.shape(kernel)}")
    img = filter_grid(kernel)
    s = args.scale
    save_png(np.repeat(np.repeat(img, s, axis=0), s, axis=1), args.out)
    print("saved", args.out)


if __name__ == "__main__":
    main()
