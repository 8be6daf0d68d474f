"""Wavelet L / H variants of NRRD volumes (hebbax's
``tools/wavelet3D.py``): a single-level 3D DWT per volume; the LLL band
as L and the sum of the 7 detail bands as H, each resized back to the
volume's shape (trilinear, align_corners) and saved as float32 NRRD.
The resize runs on the card when there is one.

    python -m hebbax_torch.tools.wavelet3D --image_path I --L_path L \
        --H_path H [--wavelet_type haar]
"""

import argparse
import os

import numpy as np
import torch

from ..data.nrrd_io import read_nrrd, write_nrrd
from ..models.common import resize_linear_align_corners
from ..ops.wavelets import dwtn3


def _resize_to(arr, shape, device):
    x = torch.from_numpy(np.asarray(arr, np.float32)).to(device)
    out = resize_linear_align_corners(x[None, None], shape)
    return out[0, 0].cpu().numpy()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--image_path", required=True)
    parser.add_argument("--L_path", required=True)
    parser.add_argument("--H_path", required=True)
    parser.add_argument("--wavelet_type", default="haar")
    args = parser.parse_args(argv)

    device = "cuda" if torch.cuda.is_available() else "cpu"
    os.makedirs(args.L_path, exist_ok=True)
    os.makedirs(args.H_path, exist_ok=True)
    for name in os.listdir(args.image_path):
        vol, hdr = read_nrrd(os.path.join(args.image_path, name))
        bands = dwtn3(vol, args.wavelet_type)
        low = bands["aaa"]
        high = sum(v for k, v in bands.items() if k != "aaa")
        write_nrrd(os.path.join(args.L_path, name),
                   _resize_to(low, vol.shape, device),
                   affine=hdr["affine"])
        write_nrrd(os.path.join(args.H_path, name),
                   _resize_to(high, vol.shape, device),
                   affine=hdr["affine"])


if __name__ == "__main__":
    main()
