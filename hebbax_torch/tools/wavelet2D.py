"""Wavelet L / H variants of an image folder (hebbax's
``tools/wavelet2D.py``): a single-level 2D DWT per image; the min-max
normalized LL band saved to ``--L_path``, the min-max normalized sum of
the normalized LH, HL and HH bands to ``--H_path``, as 8-bit PNGs.

    python -m hebbax_torch.tools.wavelet2D --image_path I --L_path L \
        --H_path H [--wavelet_type db2] [--if_RGB 1]
"""

import argparse
import os

import numpy as np

from ..ops.wavelets import dwt2
from ..utils.images import save_png


def _norm255(x):
    rng = x.max() - x.min()
    if rng == 0:
        return np.zeros_like(x)
    return (x - x.min()) / rng * 255


def main(argv=None):
    from PIL import Image

    parser = argparse.ArgumentParser()
    parser.add_argument("--image_path", required=True)
    parser.add_argument("--L_path", required=True)
    parser.add_argument("--H_path", required=True)
    parser.add_argument("--wavelet_type", default="db2",
                        help="haar, db2, db4, bior1.5, bior2.4, coif1")
    parser.add_argument("--if_RGB", default=False)
    args = parser.parse_args(argv)

    os.makedirs(args.L_path, exist_ok=True)
    os.makedirs(args.H_path, exist_ok=True)
    for name in os.listdir(args.image_path):
        img = Image.open(os.path.join(args.image_path, name))
        if args.if_RGB:
            img = img.convert("L")
        ll, (lh, hl, hh) = dwt2(np.array(img), args.wavelet_type)
        save_png(_norm255(ll).astype(np.uint8),
                 os.path.join(args.L_path, name))
        merge = _norm255(lh) + _norm255(hl) + _norm255(hh)
        save_png(_norm255(merge).astype(np.uint8),
                 os.path.join(args.H_path, name))


if __name__ == "__main__":
    main()
