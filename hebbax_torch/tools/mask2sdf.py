"""Signed distance fields of NRRD masks (hebbax's ``tools/mask2sdf.py``):
per class, the normalized SDF in [-1, 1], zero on the boundary, written
under ``mask_sdf<class>/`` beside the mask directory (or ``--out_path``):
the DTC trainers' inputs.

    python -m hebbax_torch.tools.mask2sdf --mask_path <ds>/train/mask
"""

import argparse
import os

import numpy as np

from ..data.nrrd_io import read_nrrd, write_nrrd
from ..ops.distance import mask_to_sdf


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--mask_path", required=True)
    parser.add_argument("--out_path", default=None,
                        help="default: sibling mask_sdf1 dir")
    parser.add_argument("--num_classes", default=2, type=int)
    args = parser.parse_args(argv)

    for cls in range(1, args.num_classes):
        out = args.out_path or os.path.join(
            os.path.dirname(args.mask_path.rstrip("/")), f"mask_sdf{cls}")
        os.makedirs(out, exist_ok=True)
        for name in os.listdir(args.mask_path):
            mask, hdr = read_nrrd(os.path.join(args.mask_path, name))
            mask[mask == 255] = 1
            sdf = mask_to_sdf(mask == cls).astype(np.float32)
            write_nrrd(os.path.join(out, name), sdf, affine=hdr["affine"])


if __name__ == "__main__":
    main()
