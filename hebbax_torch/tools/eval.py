"""Offline evaluation of saved predictions against masks (hebbax's
``tools/eval.py``): pixel Jaccard / Dice over every file the two
directories share, and HD95 / ASSD; PNG directories for 2D, NRRD for
3D (``--if_3D``).

    python -m hebbax_torch.tools.eval --pred_path P --mask_path M [--if_3D 1]
"""

import argparse
import os

import numpy as np

from ..data.nrrd_io import read_nrrd
from ..ops.distance import eval_distance_offline


def load_dir(path, is_3d):
    out = {}
    for name in sorted(os.listdir(path)):
        p = os.path.join(path, name)
        if is_3d:
            arr, _ = read_nrrd(p)
        else:
            from PIL import Image
            arr = np.array(Image.open(p))
        arr = np.asarray(arr, np.int64)
        arr[arr == 255] = 1
        out[name] = arr
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--pred_path", required=True)
    parser.add_argument("--mask_path", required=True)
    parser.add_argument("--num_classes", default=2, type=int)
    parser.add_argument("--if_3D", default=False)
    args = parser.parse_args(argv)

    is_3d = bool(args.if_3D) and str(args.if_3D) not in ("False", "0", "")
    preds = load_dir(args.pred_path, is_3d)
    masks = load_dir(args.mask_path, is_3d)
    names = sorted(set(preds) & set(masks))
    p = np.concatenate([preds[n].ravel() for n in names])
    m = np.concatenate([masks[n].ravel() for n in names])
    nc = args.num_classes
    hist = np.bincount(m * nc + p, minlength=nc * nc).reshape(nc, nc)
    diag = np.diag(hist).astype(float)
    s0, s1 = hist.sum(axis=0), hist.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        jaccard = diag / (s1 + s0 - diag)
        dice = 2 * diag / (s1 + s0)
    if nc == 2:
        ji, dc = float(jaccard[1]), float(dice[1])
    else:
        ji, dc = float(np.nanmean(jaccard)), float(np.nanmean(dice))
    hd, sd = eval_distance_offline([masks[n] for n in names],
                                   [preds[n] for n in names], nc)
    out = {"jaccard": ji, "dice": dc, "95hd": hd, "asd": sd}
    print(out)
    return out


if __name__ == "__main__":
    main()
