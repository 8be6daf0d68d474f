"""Post-processing of predicted NRRD volumes (hebbax's
``tools/Atrial/postprocess.py``): holes below ``--fill_hole_thr`` voxels
filled, then the largest connected component kept.

    python -m hebbax_torch.tools.atrial.postprocess --pred_path P \
        --save_path S
"""

import argparse
import os

from ...data.nrrd_io import read_nrrd, write_nrrd
from ...ops.morphology import postprocess_3d_pred


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--pred_path", required=True)
    parser.add_argument("--save_path", required=True)
    parser.add_argument("--fill_hole_thr", default=500, type=int)
    args = parser.parse_args(argv)

    os.makedirs(args.save_path, exist_ok=True)
    for name in os.listdir(args.pred_path):
        pred, hdr = read_nrrd(os.path.join(args.pred_path, name))
        out = postprocess_3d_pred(pred, args.fill_hole_thr)
        write_nrrd(os.path.join(args.save_path, name), out,
                   affine=hdr["affine"])


if __name__ == "__main__":
    main()
