"""Test-set evaluation of a RAD-DINO decoder run (the root script
``test_raddino_decoder_2d.py``): the decoder snapshot over the frozen
encoder, Dice / Jaccard at the snapshot's threshold plus HD95 / ASSD, into
``<path_exp>/test.csv``.  Arguments are :mod:`hebbax_torch.cli.test_2d`'s.

    python -m hebbax_torch.cli.test_raddino_decoder_2d --path_exp <run>

The encoder initialises from seed 0 whatever ``--seed`` the run trained
with, as hebbax's tester does (``PRNGKey(0)``), while the trainer
initialises it from ``--seed``: without the ``microsoft/rad-dino``
weights, a run of another seed is tested through another random encoder
than the one it was trained on.
"""

import os

import numpy as np
import torch

from ..bridge import kernel_layout
from ..config.datasets import dataset_cfg, input_stats
from ..data import Loader, SegDataset2D
from ..engine.loop import to_device_batch
from ..models.raddino import RadDinoDecoder, load_hf_rad_dino_params
from ..ops.distance import evaluate_distance_binary
from ..utils.checkpoint import load_state_dict
from ..utils.logging import write_csv
from ..utils.seeding import make_generator
from .common import resolve_device
from .test_2d import (build_parser, check_distance_threshold,
                      evaluate_test)
from .train_semi_raddino_decoder_2d import (IMAGE_SIZE, frozen_encoder,
                                            make_decoder_eval_step,
                                            make_embed)

TESTER_ENCODER_SEED = 0


def run_test(args, loader=None, image_size=IMAGE_SIZE, encoder_kw=None):
    """Evaluate the snapshot; ``loader`` replaces the folder dataset of
    ``<path_dataset>/val`` when given; ``image_size`` / ``encoder_kw`` as
    the trainer's.  Returns the metrics dict."""
    device = resolve_device(args.device)
    cfg = dataset_cfg(args.dataset_name)
    n_cls = cfg["NUM_CLASSES"]
    encoder, _ = load_hf_rad_dino_params(frozen_encoder(
        TESTER_ENCODER_SEED, device, image_size=image_size,
        **(encoder_kw or {})))
    decoder = RadDinoDecoder(n_cls, out_size=image_size, dim=encoder.dim,
                             device=device, generator=make_generator(0))
    name = "last" if args.best == "last" else f"best_{args.best}"
    state, meta = load_state_dict(
        os.path.join(args.path_exp, "checkpoints", f"{name}.ckpt"),
        **kernel_layout(decoder))
    decoder.load_state_dict(state)
    threshold = (meta.get("threshold")
                 if args.threshold is None else args.threshold)
    check_distance_threshold(threshold, True)
    forward = make_decoder_eval_step(decoder, make_embed(encoder,
                                                         image_size))

    if loader is None:
        mean, std = input_stats(cfg, args.input1)
        ds = SegDataset2D(os.path.join(args.path_dataset, "val"),
                          args.input1, mean, std, split="test", sup=True,
                          size=(image_size, image_size))
        loader = Loader(ds, args.batch_size, shuffle=False,
                        num_workers=args.num_workers)
    probs_all, masks_all = [], []
    for batch in loader:
        logits = forward(to_device_batch({"image": batch["image"]},
                                         device))["logits"]
        probs_all.append(torch.softmax(logits, dim=1)[:, 1].cpu().numpy())
        masks_all.append(batch["mask"])
    probs = np.concatenate(probs_all)
    masks = np.concatenate(masks_all)
    pixel = evaluate_test(probs, masks, threshold, n_cls)
    dist = evaluate_distance_binary(probs, masks, [threshold])
    metrics = {"segm/dice": pixel[2], "segm/jaccard": pixel[1],
               "segm/asd": dist[1], "segm/95hd": dist[0],
               "thresh": pixel[0]}
    write_csv(os.path.join(args.path_exp, "test.csv"), [metrics])
    print({"dice": pixel[2], "jaccard": pixel[1]})
    return metrics


def main(argv=None, loader=None):
    return run_test(build_parser().parse_args(argv), loader)


if __name__ == "__main__":
    main()
