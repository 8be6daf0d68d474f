"""Atrial (LA) case preprocessing (hebbax's
``tools/Atrial/preprocess.py``): each ``<case>/lgemri.nrrd`` and
``laendo.nrrd`` cropped in-plane to the mask's bounding box plus margins
of 10 to 19 voxels drawn from ``np.random.default_rng(--seed)``, widened
to at least 112, saved as ``<case>.nrrd``.

    python -m hebbax_torch.tools.atrial.preprocess --data_path D \
        --save_image_path I --save_mask_path M
"""

import argparse
import os

import numpy as np

from ...data.nrrd_io import read_nrrd, write_nrrd


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_path", required=True,
                        help="dir of <case>/lgemri.nrrd + laendo.nrrd")
    parser.add_argument("--save_image_path", required=True)
    parser.add_argument("--save_mask_path", required=True)
    parser.add_argument("--seed", default=0, type=int)
    args = parser.parse_args(argv)

    os.makedirs(args.save_image_path, exist_ok=True)
    os.makedirs(args.save_mask_path, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    for case in sorted(os.listdir(args.data_path)):
        case_dir = os.path.join(args.data_path, case)
        if not os.path.isdir(case_dir):
            continue
        image, hdr = read_nrrd(os.path.join(case_dir, "lgemri.nrrd"))
        mask, mhdr = read_nrrd(os.path.join(case_dir, "laendo.nrrd"))
        w, h = mask.shape[0], mask.shape[1]
        nz = np.nonzero(mask)
        minx, maxx = int(nz[0].min()), int(nz[0].max())
        miny, maxy = int(nz[1].min()), int(nz[1].max())
        px = max(112 - (maxx - minx), 0) // 2
        py = max(112 - (maxy - miny), 0) // 2
        minx = max(minx - int(rng.integers(10, 20)) - px, 0)
        maxx = min(maxx + int(rng.integers(10, 20)) + px, w)
        miny = max(miny - int(rng.integers(10, 20)) - py, 0)
        maxy = min(maxy + int(rng.integers(10, 20)) + py, h)
        name = case + ".nrrd"
        crop = image[minx:maxx, miny:maxy, :]
        write_nrrd(os.path.join(args.save_image_path, name), crop,
                   affine=hdr["affine"])
        write_nrrd(os.path.join(args.save_mask_path, name),
                   mask[minx:maxx, miny:maxy, :], affine=mhdr["affine"])
        print(name, crop.shape)


if __name__ == "__main__":
    main()
