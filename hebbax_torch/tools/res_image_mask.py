"""Inter-slice residual volumes (hebbax's ``tools/res_image_mask.py``):
per NRRD volume, ``res[..., z] = v[..., z] - v[..., z - 1]`` with
``res[..., 0] = 0``, in float32.

    python -m hebbax_torch.tools.res_image_mask --image_path I --out_path O
"""

import argparse
import os

import numpy as np

from ..data.nrrd_io import read_nrrd, write_nrrd


def residual(vol):
    res = np.zeros_like(vol, dtype=np.float32)
    res[..., 1:] = (vol[..., 1:].astype(np.float32)
                    - vol[..., :-1].astype(np.float32))
    return res


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--image_path", required=True)
    parser.add_argument("--out_path", required=True)
    args = parser.parse_args(argv)
    os.makedirs(args.out_path, exist_ok=True)
    for name in os.listdir(args.image_path):
        vol, hdr = read_nrrd(os.path.join(args.image_path, name))
        write_nrrd(os.path.join(args.out_path, name), residual(vol),
                   affine=hdr["affine"])


if __name__ == "__main__":
    main()
