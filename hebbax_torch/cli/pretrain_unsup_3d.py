"""Unsupervised pretrainers with a supervised probe head, 3D
(``hebbax/cli/pretrain_unsup_3d.py``): VAE ELBO and superpixel prediction
on ``unet3d_vae`` / ``unet3d_superpix``, and conditional diffusion
("superdiff") of the 2D ``unet_ddpm`` on the central z-slice of each
patch.

    python -m hebbax_torch.cli.pretrain_unsup_3d <vae|superpix|superdiff> \\
        --path_dataset data/Atrial -b 2 --lr 1e-4 ...

The first argument plays the role of hebbax's three root shims.  Run dirs
are ``<root>/<dataset>/<kind>_unsup/<network>/inv_temp-1/regime-100/
run-<seed>``.  The gradient protocol, the losses and the random streams
are the 2D pretrainer's (:mod:`hebbax_torch.cli.pretrain_unsup_2d`), with
the 3D probe head ``conv`` (``final_conv`` for superdiff).  A superpixel
pseudo-mask batch comes from a generator seeded from the seed and the
CRC-32 of the first volume's 2x2x2 corner (:func:`superpix_masks_3d`),
the 26-neighbourhood flood fill of each patch.
"""

import functools
import sys
import zlib

import numpy as np
import torch

from ..config.datasets import dataset_cfg
from ..engine.loop import SupTrainer, to_device_batch_3d
from ..engine.state import TrainState
from ..engine.steps import make_eval_step, make_probe_pretrain_step
from ..ops.losses import elbo_metric, segmentation_loss
from ..ops.superpix import superpix_batch
from ..utils.rundir import dump_config, make_run_dir
from ..utils.seeding import init_seeds, make_generator
from . import common, common3d
from .pretrain_unsup_2d import (DIFFUSION_SEED_OFFSET, KINDS, PHASES,
                                make_superdiff_eval_step,
                                make_superdiff_step)

NETWORK_DEFAULT = {"vae": "unet3d_vae", "superpix": "unet3d_superpix",
                   "superdiff": "unet_ddpm"}
HEADS_3D = {"vae": ("conv",), "superpix": ("conv",),
            "superdiff": ("final_conv",)}


def add_args(parser, kind):
    parser.add_argument("--threshold", default=None, type=float)
    parser.add_argument("--thr_interval", default=0.02, type=float)
    if kind == "superdiff":
        parser.add_argument("--timestamp_diffusion", default=1000,
                            type=int)
    parser.set_defaults(optimizer="adam", regime=100,
                        network=NETWORK_DEFAULT[kind])
    return parser


def superpix_masks_3d(images, seed):
    """The pseudo-masks of one host patch batch ((B, X, Y, Z) float32,
    before it goes to the device): the generator is seeded from ``seed``
    and the CRC-32 of the first volume's [:2, :2, :2] corner, so a batch
    gets the masks hebbax gives it."""
    images = np.asarray(images, np.float32)
    digest = zlib.crc32(images[0, :2, :2, :2].tobytes())
    rng = np.random.default_rng(np.random.SeedSequence([seed, digest]))
    return superpix_batch(rng, images, nd=3)


def central_slice(batch):
    """A device patch batch -> its central z-slice as a 2D batch: images
    (B, 1, X, Y), masks (B, X, Y)."""
    z = batch["image"].shape[-1] // 2
    out = {"image": batch["image"][..., z].contiguous()}
    if "mask" in batch:
        out["mask"] = batch["mask"][..., z].contiguous()
    return out


def build(args, kind, loaders=None):
    """The trainer of ``kind`` for ``args``; ``loaders`` ({'train',
    'val'}) replaces the patch queues over ``--path_dataset`` when
    given."""
    if kind not in KINDS:
        raise ValueError(f"unknown pretrainer {kind!r}; one of {KINDS}")
    common.check_ported(args)
    device = common.resolve_device(args.device)
    cfg = dataset_cfg(args.dataset_name)
    n_cls = cfg["NUM_CLASSES"]
    paths = make_run_dir(args.path_root_exp, args.path_dataset, PHASES[kind],
                         args.network, 1, 100, args.seed,
                         debug=bool(args.debug))
    dump_config(paths, args)
    if loaders is None:
        loaders = common3d.make_queues_3d(args, cfg)
    common3d.parse_patch_size(args)
    init_seeds(args.seed)
    model = common.new_model(args, cfg, device)
    optimizer, schedule = common.build_optimizer(
        args, model.parameters(), steps_per_epoch=len(loaders["train"]))
    state = TrainState(model=model, optimizer=optimizer, schedule=schedule)
    criterion = segmentation_loss(args.loss)

    if kind == "superdiff":
        gen = make_generator(args.seed + DIFFUSION_SEED_OFFSET, device)
        train_step = make_superdiff_step(model, criterion, n_cls,
                                         args.timestamp_diffusion, gen)
        eval_step = make_superdiff_eval_step(model, criterion, n_cls,
                                             args.timestamp_diffusion, gen)
    else:
        if kind == "vae":
            def unsup(outputs, batch):
                return elbo_metric(outputs, batch["image"],
                                   weight=batch.get("weight"))
        else:
            def unsup(outputs, batch):
                return criterion(outputs[1], batch["mask_superpix"])
        train_step = make_probe_pretrain_step(model, args.network, criterion,
                                              unsup,
                                              head_names=HEADS_3D[kind])
        eval_step = make_eval_step(model, args.network, criterion)

    trainer = SupTrainer(
        state=state, train_step=train_step, eval_step=eval_step,
        loaders=loaders, num_classes=n_cls, paths=paths, args=args,
        device=device, palette=cfg["PALETTE"])
    to_device = functools.partial(to_device_batch_3d, device=device)
    if kind == "superdiff":
        trainer.to_device = lambda batch: central_slice(to_device(batch))
    elif kind == "superpix":
        # the pseudo-masks of the whole host batch, before any sharding
        # (int32, as hebbax's: a padded sample's mask pads with -1)
        trainer.host_prep = lambda batch: dict(
            batch, mask_superpix=superpix_masks_3d(
                batch["image"], args.seed).astype(np.int32))

        def to_device_superpix(batch):
            out = to_device(batch)
            out["mask_superpix"] = torch.from_numpy(
                batch["mask_superpix"]).to(device=device, dtype=torch.int64)
            return out

        trainer.to_device = to_device_superpix
    else:
        trainer.to_device = to_device
    return trainer


def main(kind, argv=None, loaders=None):
    parser = add_args(common3d.base_parser_3d(), kind)
    args = parser.parse_args(argv)
    return common.train(build, args, kind, loaders)


if __name__ == "__main__":
    if len(sys.argv) < 2 or sys.argv[1] not in KINDS:
        sys.exit(f"usage: python -m hebbax_torch.cli.pretrain_unsup_3d "
                 f"<{'|'.join(KINDS)}> [flags]")
    main(sys.argv[1], sys.argv[2:])
