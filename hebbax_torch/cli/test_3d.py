"""3D test-set evaluation with sliding-window inference
(``hebbax/cli/test_3d.py``).

Per val volume: the patch grid runs through the network in batches on the
device, the logits are overlap-averaged there and thresholded at the
snapshot's stored threshold (class-1 softmax > threshold, or argmax for a
multi-class task) into a uint8 volume written as NRRD with the affine
kept; ``--postprocessing`` adds hole filling + the largest component in
``test_seg_preds_postprocessed/``; then the pooled-voxel confusion and the
per-volume HD95/ASSD of the evaluated folder go to ``test.csv``.

    python -m hebbax_torch.cli.test_3d --path_exp <run> -n unet3d \\
        --hebbian_pretrain 1 --postprocessing True
"""

import argparse
import os
import time

import numpy as np

from ..config.datasets import dataset_cfg
from ..data.augment3d import znormalize
from ..data.nrrd_io import read_nrrd, write_nrrd
from ..data.volumes3d import VolumeDataset3D
from ..engine.sliding import slide_window_inference_device
from ..hebb.spec import HebbSpec
from ..models import get_network, primary_logits
from ..ops.distance import eval_distance_offline
from ..ops.morphology import postprocess_3d_pred
from ..utils.checkpoint import load_snapshot
from ..utils.logging import BoxPrinter, write_csv
from ..utils.seeding import init_seeds, make_generator
from .common import resolve_device
from .common3d import load_variables_into, parse_tuple


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="0", type=str,
                   help="card index (cuda:<n>) or 'cpu'")
    p.add_argument("--path_exp", required=True)
    p.add_argument("--best", default="JI", type=str)
    p.add_argument("--path_dataset", default="data/Atrial")
    p.add_argument("--dataset_name", default="Atrial")
    p.add_argument("--input1", default="image")
    p.add_argument("--threshold", default=None, type=float)
    p.add_argument("--thr_interval", default=0.02, type=float)
    p.add_argument("--patch_size", default=(112, 112, 32))
    p.add_argument("--patch_overlap", default=(56, 56, 16))
    p.add_argument("-b", "--batch_size", default=8, type=int,
                   help="patches per slider batch")
    p.add_argument("-n", "--network", default="unet3d_s2d")
    p.add_argument("--hebbian_pretrain", default=False)
    p.add_argument("--fill_hole_thr", default=500, type=int)
    p.add_argument("--postprocessing", default=False)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--dp_devices", default=1, type=int,
                   help="devices the patch batches shard over (only 1 is "
                        "ported)")
    return p


def offline_eval(pred_path, mask_path, num_classes=2):
    """Pooled voxel confusion over every volume of ``pred_path`` and the
    per-volume distance metrics (NaN where no volume has both a non-empty
    prediction and mask)."""
    preds, masks = [], []
    for name in sorted(os.listdir(pred_path)):
        pred, _ = read_nrrd(os.path.join(pred_path, name))
        mask, _ = read_nrrd(os.path.join(mask_path, name))
        mask = mask.astype(np.int64)
        mask[mask == 255] = 1
        preds.append(pred.astype(np.int64))
        masks.append(mask)
    p = np.concatenate([x.ravel() for x in preds])
    m = np.concatenate([x.ravel() for x in masks])
    hist = np.zeros((num_classes, num_classes), np.float64)
    idx = m * num_classes + p
    hist += np.bincount(idx, minlength=num_classes ** 2).reshape(
        num_classes, num_classes)
    diag = np.diag(hist)
    s0, s1 = hist.sum(axis=0), hist.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        jaccard = diag / (s1 + s0 - diag)
        dice = 2 * diag / (s1 + s0)
    if num_classes == 2:
        ji, dc = float(jaccard[1]), float(dice[1])
    else:
        ji, dc = float(np.nanmean(jaccard)), float(np.nanmean(dice))
    hd, sd = eval_distance_offline(masks, preds, num_classes)
    return {"jaccard": ji, "dice": dc, "hd": hd, "sd": sd}


def run_test(args):
    """Evaluate the snapshot; returns offline_eval's metrics plus
    ``seconds``: the slider's and the post-processing + evaluation's wall
    time per volume (``postprocess_eval``)."""
    if args.dp_devices != 1:
        raise NotImplementedError("--dp_devices != 1 is not ported yet")
    device = resolve_device(args.device)
    cfg = dataset_cfg(args.dataset_name)
    init_seeds(args.seed)
    printer = BoxPrinter(cfg["NUM_CLASSES"])
    patch_size = parse_tuple(args.patch_size)
    overlap = parse_tuple(args.patch_overlap)

    name = "last" if args.best == "last" else f"best_{args.best}"
    variables, meta = load_snapshot(
        os.path.join(args.path_exp, "checkpoints", f"{name}.ckpt"))
    threshold = (meta.get("threshold")
                 if args.threshold is None else args.threshold)

    hebb = None
    if args.hebbian_pretrain and meta.get("hebb_params"):
        hebb = HebbSpec.from_dict(meta["hebb_params"],
                                  exclude=meta.get("excluded_layers") or ())
    elif meta.get("hebb_params") and not args.hebbian_pretrain:
        print("WARNING: snapshot carries hebb_params but "
              "--hebbian_pretrain is not set; the weight-normalized "
              "forward will NOT be applied and metrics will be wrong")
    n_cls = cfg["NUM_CLASSES"]
    model = get_network(args.network, cfg["IN_CHANNELS"], n_cls, hebb=hebb,
                        device=device, generator=make_generator(args.seed))
    load_variables_into(model, variables)
    model.eval()

    def forward(patches):
        return primary_logits(args.network, model(patches))

    normalize = cfg.get("NORMALIZE", "mean")
    ds = VolumeDataset3D(
        os.path.join(args.path_dataset, "val"), args.input1, split="test",
        sup=False, normalize=normalize, num_classes=n_cls,
        fmt=cfg.get("FORMAT", ".nrrd"))
    path_seg = os.path.join(args.path_exp, "test_seg_preds")
    os.makedirs(path_seg, exist_ok=True)

    printer.rule("-")
    printer.line("Starting Testing")
    printer.rule("=")
    finalize = "binary" if n_cls == 2 else "argmax"
    thr = 0.5 if threshold is None else float(threshold)
    since = time.time()
    for i in range(len(ds)):
        item = ds.load_raw(i)
        pred = slide_window_inference_device(
            forward, znormalize(item["image"], normalize), patch_size,
            overlap, n_cls, batch_size=args.batch_size, device=device,
            finalize=finalize, threshold=thr)
        write_nrrd(os.path.join(path_seg, item["id"]), pred.cpu().numpy(),
                   affine=item["affine"])
    slider_s = time.time() - since
    printer.line(f"Testing completed in {slider_s:.1f}s "
                 f"({len(ds) / max(slider_s, 1e-9):.3f} volumes/s)")

    since = time.time()
    path_eval = path_seg
    if args.postprocessing:
        path_eval = os.path.join(args.path_exp,
                                 "test_seg_preds_postprocessed")
        os.makedirs(path_eval, exist_ok=True)
        for fname in os.listdir(path_seg):
            pred, hdr = read_nrrd(os.path.join(path_seg, fname))
            pred = postprocess_3d_pred(pred, args.fill_hole_thr)
            write_nrrd(os.path.join(path_eval, fname), pred,
                       affine=hdr["affine"])

    results = offline_eval(path_eval,
                           os.path.join(args.path_dataset, "val", "mask"),
                           num_classes=n_cls)
    write_csv(os.path.join(args.path_exp, "test.csv"), [{
        "segm/dice": results["dice"],
        "segm/jaccard": results["jaccard"],
        "segm/asd": results["sd"],
        "segm/95hd": results["hd"],
    }])
    n = max(len(ds), 1)
    results["seconds"] = {"slider": slider_s / n,
                          "postprocess_eval": (time.time() - since) / n}
    printer.line(f"Test  Dc: {results['dice']:.4f}  "
                 f"Jc: {results['jaccard']:.4f}  HD95: {results['hd']:.2f}"
                 f"  ASSD: {results['sd']:.2f}")
    printer.rule("=")
    return results


def main(argv=None):
    args = build_parser().parse_args(argv)
    return run_test(args)


if __name__ == "__main__":
    main()
