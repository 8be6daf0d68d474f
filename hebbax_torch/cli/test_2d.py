"""2D test-set evaluation (``hebbax/cli/test_2d.py``).

Loads best_JI/last snapshot from <path_exp>/checkpoints into the network
named by ``-n`` (a deep4 network is tested on its primary output), reuses
the stored threshold, computes Dice/Jaccard at that threshold plus HD95/ASSD,
saves paletted PNG predictions, and writes test.csv with the reference's
column names.

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


def evaluate_test(probs_fg, masks, threshold):
    """Binary pixel metrics at the stored threshold."""
    pred = (probs_fg > threshold).astype(np.uint8)
    t = masks.astype(np.uint8)
    tp = float(np.sum(pred * t))
    union = float(np.sum(np.abs(pred.astype(np.int64) - t.astype(np.int64))))
    ji = tp / (union + tp) if union + tp else 0.0
    dc = 2 * tp / (union + 2 * tp) if union + 2 * tp else 0.0
    return threshold, ji, dc


def run_test(args, loader=None):
    """Evaluate the snapshot; ``loader`` replaces the folder dataset of
    ``<path_dataset>/val`` when given.  Returns the metrics dict."""
    device = resolve_device(args.device)
    cfg = dataset_cfg(args.dataset_name)
    if cfg["NUM_CLASSES"] != 2:
        raise NotImplementedError(
            "multi-class test metrics are not ported yet")
    init_seeds(args.seed)
    printer = BoxPrinter(cfg["NUM_CLASSES"])

    name = "last" if args.best == "last" else f"best_{args.best}"
    state, meta = load_state_dict(
        os.path.join(args.path_exp, "checkpoints", f"{name}.ckpt"))
    threshold = (meta.get("threshold")
                 if args.threshold is None else args.threshold)

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
        pixel = evaluate_test(probs, masks, threshold)
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
