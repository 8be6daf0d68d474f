"""2D test-set evaluation (``hebbax/cli/test_2d.py``).

Loads best_JI/last snapshot from <path_exp>/checkpoints into the network
named by ``-n`` (a deep4 network is tested on its primary output), reuses
the stored threshold, computes Dice/Jaccard at that threshold plus HD95/ASSD,
saves paletted PNG predictions, and writes test.csv with the reference's
column names.  A dataset of N != 2 classes takes hebbax's confusion branch
(:func:`evaluate_test`) and needs ``--threshold`` for HD95/ASSD.

    python -m hebbax_torch.cli.test_2d --path_exp <run> --hebbian_pretrain 1
"""

import argparse
import os
import time

import numpy as np
import torch

from ..config.datasets import dataset_cfg, input_stats
from ..data import Loader, SegDataset2D
from ..engine.loop import to_device_batch
from ..engine.steps import make_eval_step
from ..hebb.spec import HebbSpec
from ..models import get_network
from ..ops.distance import evaluate_distance_binary
from ..ops.metrics import THR_INTERVAL
from ..utils.checkpoint import load_state_dict
from ..utils.images import save_preds
from ..utils.logging import BoxPrinter, write_csv
from ..utils.seeding import init_seeds, make_generator
from .common import (load_snapshot_into, resolve_device,
                     stream_generators)


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="0", type=str,
                   help="card index (cuda:<n>) or 'cpu'")
    p.add_argument("--path_dataset", default="data/GlaS")
    p.add_argument("--dataset_name", default="GlaS")
    p.add_argument("--input1", default="image")
    p.add_argument("--path_exp", required=True)
    p.add_argument("--best", default="JI", help="JI | last")
    p.add_argument("--threshold", default=None, type=float)
    p.add_argument("--thr_interval", default=THR_INTERVAL, type=float)
    p.add_argument("-b", "--batch_size", default=2, type=int)
    p.add_argument("--if_mask", default=True)
    p.add_argument("-n", "--network", default="unet_s2d", type=str)
    p.add_argument("--hebbian_pretrain", default=None)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--num_workers", default=8, type=int)
    return p


def evaluate_test(probs_fg, masks, threshold, num_classes=2):
    """Pixel metrics at the stored threshold (binary) or from a confusion
    histogram (``num_classes`` != 2, no threshold).

    The multi-class branch is hebbax's (``hebbax/cli/test_2d.py:58-66``):
    it reads its input as a class map and casts it to int64, but
    :func:`run_test` passes the class-1 probabilities, as hebbax's caller
    does, so the predicted class is 1 only where p1 == 1 and 0 elsewhere.
    The port reproduces those numbers."""
    if num_classes == 2:
        pred = (probs_fg > threshold).astype(np.uint8)
        t = masks.astype(np.uint8)
        tp = float(np.sum(pred * t))
        union = float(np.sum(np.abs(pred.astype(np.int64)
                                    - t.astype(np.int64))))
        ji = tp / (union + tp) if union + tp else 0.0
        dc = 2 * tp / (union + 2 * tp) if union + 2 * tp else 0.0
        return threshold, ji, dc
    pred = probs_fg.astype(np.int64).ravel()
    t = masks.astype(np.int64).ravel()
    hist = np.bincount(t * num_classes + pred,
                       minlength=num_classes ** 2).reshape(num_classes,
                                                           num_classes)
    diag = np.diag(hist).astype(float)
    s0, s1 = hist.sum(axis=0), hist.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        ji = float(np.nanmean(diag / (s1 + s0 - diag)))
        dc = float(np.nanmean(2 * diag / (s1 + s0)))
    return None, ji, dc


def check_distance_threshold(threshold, if_mask):
    """HD95 / ASSD threshold the class-1 probabilities at ``threshold``.
    A multi-class run's snapshot stores none, and hebbax's tester then
    fails comparing the probabilities with None (a TypeError after the
    forward passes); the port refuses before them, asking for
    ``--threshold``."""
    if if_mask and threshold is None:
        raise ValueError(
            "the snapshot stores no threshold (a multi-class run's has "
            "none): pass --threshold for HD95 / ASSD of the class-1 "
            "probabilities")


def run_test(args, loader=None):
    """Evaluate the snapshot; ``loader`` replaces the folder dataset of
    ``<path_dataset>/val`` when given.  Returns the metrics dict."""
    device = resolve_device(args.device)
    cfg = dataset_cfg(args.dataset_name)
    init_seeds(args.seed)
    printer = BoxPrinter(cfg["NUM_CLASSES"])

    name = "last" if args.best == "last" else f"best_{args.best}"
    state, meta = load_state_dict(
        os.path.join(args.path_exp, "checkpoints", f"{name}.ckpt"))
    threshold = (meta.get("threshold")
                 if args.threshold is None else args.threshold)
    check_distance_threshold(threshold, args.if_mask)

    hebb = None
    if args.hebbian_pretrain and meta.get("hebb_params"):
        hebb = HebbSpec.from_dict(
            meta["hebb_params"], exclude=meta.get("excluded_layers") or ())
    elif meta.get("hebb_params") and not args.hebbian_pretrain:
        print("WARNING: snapshot carries hebb_params but "
              "--hebbian_pretrain is not set; the weight-normalized "
              "forward will NOT be applied and metrics will be wrong "
              "(same footgun as the reference's test_2d.py)")
    # a network with its own random streams (the SNN's Poisson input)
    # draws them in eval too, as hebbax's eval step gets a key for it
    model = get_network(args.network, cfg["IN_CHANNELS"],
                        cfg["NUM_CLASSES"], hebb=hebb, device=device,
                        generator=make_generator(args.seed),
                        **stream_generators(args.seed, device))
    # entries of modules the network lacks (an EM run from a baseline
    # snapshot keeps mu / var / reconstr in hebbax) are ignored
    load_snapshot_into(model, state)
    eval_step = make_eval_step(model, args.network)

    if loader is None:
        mean, std = input_stats(cfg, args.input1)
        ds = SegDataset2D(os.path.join(args.path_dataset, "val"),
                          args.input1, mean, std, split="test",
                          sup=bool(args.if_mask))
        loader = Loader(ds, args.batch_size, shuffle=False,
                        num_workers=args.num_workers)

    path_seg_results = os.path.join(args.path_exp, "test_seg_preds")
    os.makedirs(path_seg_results, exist_ok=True)

    since = time.time()
    probs_all, masks_all, names_all = [], [], []
    for batch in loader:
        out = eval_step(to_device_batch({"image": batch["image"]}, device))
        probs = torch.softmax(out["logits"], dim=1)[:, 1].cpu().numpy()
        probs_all.append(probs)
        names_all.extend(batch["id"])
        if args.if_mask:
            masks_all.append(batch["mask"])
        else:
            save_preds(probs, threshold, batch["id"], path_seg_results,
                       cfg["PALETTE"])

    metrics = None
    if args.if_mask:
        probs = np.concatenate(probs_all)
        masks = np.concatenate(masks_all)
        pixel = evaluate_test(probs, masks, threshold, cfg["NUM_CLASSES"])
        dist = evaluate_distance_binary(probs, masks, [threshold])
        save_preds(probs, threshold, names_all, path_seg_results,
                   cfg["PALETTE"])
        metrics = {
            "segm/dice": pixel[2],
            "segm/jaccard": pixel[1],
            "segm/asd": dist[1],
            "segm/95hd": dist[0],
            "thresh": pixel[0],
        }
        write_csv(os.path.join(args.path_exp, "test.csv"), [metrics])
        printer.rule("=")
        printer.line(f"Test  Dc: {pixel[2]:.4f}  Jc: {pixel[1]:.4f} "
                     f"HD95: {dist[0]:.2f} ASSD: {dist[1]:.2f}")
    elapsed = time.time() - since
    printer.line(f"Testing completed in {elapsed:.1f}s")
    printer.rule("=")
    return metrics


def main(argv=None, loader=None):
    args = build_parser().parse_args(argv)
    return run_test(args, loader)


if __name__ == "__main__":
    main()
