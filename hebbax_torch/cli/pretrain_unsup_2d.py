"""Unsupervised pretrainers with a supervised probe head, 2D
(``hebbax/cli/pretrain_unsup_2d.py``): VAE ELBO, superpixel prediction and
conditional diffusion ("superdiff").

    python -m hebbax_torch.cli.pretrain_unsup_2d <vae|superpix|superdiff> \\
        --dataset_name GlaS --path_dataset data/GlaS -b 32 --lr 1e-4 ...

The first argument plays the role of hebbax's three root shims.  Run dirs
are ``<root>/<dataset>/<kind>_unsup/<network>/inv_temp-1/regime-100/
run-<seed>``.  Gradient protocol (the reference's reset_internal_grads):
the probe's segmentation loss trains only the head (``out_conv``, or
``final_conv`` for superdiff); the unsupervised objective trains
everything.  ``loss`` is the probe's loss, ``loss_unsup`` (and, for
superdiff, ``loss_superdiff``) land in ``train_log.csv`` beside it.

Random streams: the model's init from the seed, dropout seed+1, the VAE
latent seed+3, the diffusion draws (t and noise) seed+5; a superpixel
pseudo-mask from the seed and a CRC of the batch's first pixels.
"""

import sys
import zlib

import numpy as np
import torch

from ..config.datasets import dataset_cfg
from ..engine.loop import SupTrainer, to_device_batch
from ..engine.state import TrainState
from ..engine.steps import (make_eval_step, make_probe_pretrain_step,
                            probe_pretrain_update)
from ..ops import diffusion as diff
from ..ops.losses import elbo_metric, segmentation_loss
from ..ops.superpix import superpix_batch
from ..utils.rundir import dump_config, make_run_dir
from ..utils.seeding import init_seeds, make_generator
from . import common

KINDS = ("vae", "superpix", "superdiff")
PHASES = {"vae": "vae_unsup", "superpix": "superpix_unsup",
          "superdiff": "superdiff_unsup"}
NETWORK_DEFAULT = {"vae": "unet_vae", "superpix": "unet_superpix",
                   "superdiff": "unet_ddpm"}
HEADS = {"vae": ("out_conv",), "superpix": ("out_conv",),
         "superdiff": ("final_conv",)}
DIFFUSION_SEED_OFFSET = 5


def add_args(parser, kind):
    parser.add_argument("--threshold", default=None, type=float)
    parser.add_argument("--thr_interval", default=0.02, type=float)
    if kind == "superdiff":
        parser.add_argument("--timestamp_diffusion", default=1000,
                            type=int)
    parser.set_defaults(optimizer="adam", regime=100,
                        network=NETWORK_DEFAULT[kind])
    return parser


def make_superdiff_step(model, criterion, n_cls, timesteps=1000,
                        generator=None):
    """``(state, batch, draws=None) -> (state, {'loss', 'loss_unsup',
    'loss_superdiff', 'logits'})``:

    * ``net_seg``'s pred_x0 diffusion of the all-background mask
      conditioned on the image gives the pseudo-mask and
      ``loss_superdiff`` (the criterion on it; logged, not trained);
    * ``net``'s pred_noise diffusion of the image conditioned on the
      pseudo-mask gives ``loss_unsup``, which trains ``net`` and, through
      the pseudo-mask, ``net_seg``;
    * the probe ``final_conv(pseudo)`` gives ``loss`` (the criterion on
      the labels), which trains ``final_conv`` only.

    Each diffusion net runs one training forward, so its BN statistics
    move once per step.  ``draws`` ({'t_seg', 'noise_seg', 't_img',
    'noise_img'}) replaces the draws from ``generator``.
    """
    params = dict(model.named_parameters())
    device = next(model.parameters()).device
    sched_seg = diff.make_schedule(timesteps, "pred_x0", device=device)
    sched_img = diff.make_schedule(timesteps, "pred_noise", device=device)

    def step(state, batch, draws=None):
        img, mask = batch["image"], batch["mask"]
        d = draws or {}
        model.train()
        # the reference's garbled conditioner 'img) #' behaves as 'img'
        loss_sdiff, pseudo = diff.super_forward(
            sched_seg, lambda x, t: model(x, t, mode="net_seg"), img,
            torch.zeros_like(mask), n_cls, conditioner="img",
            loss_fn=criterion, t=d.get("t_seg"), noise=d.get("noise_seg"),
            generator=generator)
        loss_rec, _ = diff.super_forward(
            sched_img, lambda x, t: model(x, t, mode="net"), img, pseudo,
            n_cls, conditioner="target", t=d.get("t_img"),
            noise=d.get("noise_img"), generator=generator)
        probe = model(pseudo, mode="probe")
        loss_probe = criterion(probe, mask)
        state = probe_pretrain_update(state, params, (loss_probe, loss_rec),
                                      HEADS["superdiff"])
        return state, {"loss": loss_probe.detach(),
                       "loss_unsup": loss_rec.detach(),
                       "loss_superdiff": loss_sdiff.detach(),
                       "logits": probe.detach()}

    return step


def make_superdiff_eval_step(model, criterion, n_cls, timesteps=1000,
                             generator=None):
    """``batch -> {'logits'[, 'loss']}``: the pseudo-mask of one eval-mode
    ``net_seg`` diffusion at a random t, then the probe on it."""
    sched_seg = diff.make_schedule(timesteps, "pred_x0",
                                   device=next(model.parameters()).device)

    def step(batch, draws=None):
        img = batch["image"]
        d = draws or {}
        model.eval()
        with torch.no_grad():
            _, pseudo = diff.super_forward(
                sched_seg, lambda x, t: model(x, t, mode="net_seg"), img,
                torch.zeros((img.shape[0],) + tuple(img.shape[2:]),
                            dtype=torch.int64, device=img.device),
                n_cls, conditioner="img", t=d.get("t_seg"),
                noise=d.get("noise_seg"), generator=generator)
            logits = model(pseudo, mode="probe")
            out = {"logits": logits}
            if "mask" in batch:
                out["loss"] = criterion(logits, batch["mask"])
        return out

    return step


def superpix_masks(images, seed):
    """The pseudo-masks of one host batch ((N, H, W, C) float32, before it
    goes to the device): the generator is seeded from ``seed`` and the
    CRC-32 of the first image's top-left 4x4 pixels, so a batch gets the
    masks hebbax gives it."""
    images = np.asarray(images, np.float32)
    digest = zlib.crc32(images[0, :4, :4].tobytes())
    rng = np.random.default_rng(np.random.SeedSequence([seed, digest]))
    return superpix_batch(rng, images)


def build(args, kind, loaders=None):
    """The trainer of ``kind`` for ``args``; ``loaders`` ({'train',
    'val'}) replaces the folder datasets when given."""
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
        loaders = common.make_loaders_2d(args, cfg, regime=100)
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
                                              unsup, head_names=HEADS[kind])
        eval_step = make_eval_step(model, args.network, criterion)

    trainer = SupTrainer(
        state=state, train_step=train_step, eval_step=eval_step,
        loaders=loaders, num_classes=n_cls, paths=paths, args=args,
        device=device, palette=cfg["PALETTE"])
    if kind == "superpix":
        # the pseudo-masks of the whole host batch, before any sharding
        # (int32, as hebbax's: a padded sample's mask pads with -1)
        trainer.host_prep = lambda batch: dict(
            batch, mask_superpix=superpix_masks(
                batch["image"], args.seed).astype(np.int32))

        def to_device(batch):
            out = to_device_batch(batch, device)
            out["mask_superpix"] = torch.from_numpy(
                batch["mask_superpix"]).to(device=device, dtype=torch.int64)
            return out

        trainer.to_device = to_device
    return trainer


def main(kind, argv=None, loaders=None):
    parser = add_args(common.base_parser_2d(), kind)
    args = parser.parse_args(argv)
    return common.train(build, args, kind, loaders)


if __name__ == "__main__":
    if len(sys.argv) < 2 or sys.argv[1] not in KINDS:
        sys.exit(f"usage: python -m hebbax_torch.cli.pretrain_unsup_2d "
                 f"<{'|'.join(KINDS)}> [flags]")
    main(sys.argv[1], sys.argv[2:])
