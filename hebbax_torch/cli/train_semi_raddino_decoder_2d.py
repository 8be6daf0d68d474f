"""Semi-supervised EM over a frozen RAD-DINO ViT encoder with a trainable
transpose-conv decoder (``hebbax/cli/train_semi_raddino_decoder_2d.py``).

    python -m hebbax_torch.cli.train_semi_raddino_decoder_2d --regime 10 ...

Images are resized to 224^2.  The encoder's parameters take no grad and
it runs under ``torch.no_grad()``; only the decoder trains, on the sup
criterion plus ``unsup_weight`` x the entropy of the unlabelled softmax.
Each step runs the decoder twice in training mode, the unlabelled batch
first, then the labelled one, so its batch norms take two momentum
updates per step in hebbax's order.

The ``microsoft/rad-dino`` weights are not in the repository, so the
encoder keeps its random init from ``--seed`` (a warning says so); the
decoder initialises from seed+1.  Run dirs: ``<root>/<dataset>/semi_sup/
raddino_decoder_<network>/inv_temp-1/regime-R/run-S`` (``fully_sup/...``
at regime 100).  Snapshots hold the decoder only.
"""

import torch

from ..config.datasets import dataset_cfg
from ..engine.semi import SemiTrainer
from ..engine.state import TrainState
from ..engine.steps import apply_grads
from ..models.raddino import (OFFLINE_WARNING, RadDinoDecoder, ViTEncoder,
                              load_hf_rad_dino_params,
                              reshape_patch_embeddings)
from ..ops.losses import entropy_loss, segmentation_loss
from ..parallel import average_grads
from ..utils.rundir import dump_config, make_run_dir
from ..utils.seeding import init_seeds, make_generator
from . import common

IMAGE_SIZE = 224


def add_args(parser):
    parser.add_argument("-u", "--unsup_weight", default=1.0, type=float)
    parser.add_argument("--load_weights", default=None, type=str)
    parser.add_argument("--load_hebbian_weights", default=None, type=str)
    parser.add_argument("--hebbian_rule", default="swta_t", type=str)
    parser.add_argument("--hebb_inv_temp", default=1, type=int)
    parser.set_defaults(network="raddino_decoder")
    return parser


def run_tag(args):
    """(phase, tag) of the run dir."""
    phase = "semi_sup" if args.regime < 100 else "fully_sup"
    return phase, f"raddino_decoder_{args.network}"


def frozen_encoder(seed, device, **kw):
    """The random-init ViT encoder from ``seed``, frozen, in eval mode."""
    encoder = ViTEncoder(device=device, generator=make_generator(seed),
                         **kw)
    encoder.requires_grad_(False)
    return encoder.eval()


def make_embed(encoder, image_size):
    """images (B, 3, S, S) -> the (B, dim, g, g) patch grid, no grad."""
    def embed(images):
        with torch.no_grad():
            return reshape_patch_embeddings(encoder(images), image_size,
                                            encoder.patch)
    return embed


def make_decoder_step(decoder, embed, criterion):
    """``(state, sup_batch, unsup_batch, unsup_weight) -> (state, {'loss',
    'loss_sup', 'loss_unsup', 'logits'})``: the unsup forward, then the
    sup forward, one backward of their sum over the decoder."""
    params = [p for p in decoder.parameters() if p.requires_grad]

    def step(state, sup_batch, unsup_batch, unsup_weight):
        emb_u = embed(unsup_batch["image"])
        emb_s = embed(sup_batch["image"])
        decoder.train()
        pred_u = decoder(emb_u)
        loss_u = entropy_loss(torch.softmax(pred_u, dim=1), 2) * unsup_weight
        pred_s = decoder(emb_s)
        loss_s = criterion(pred_s, sup_batch["mask"])
        loss = loss_s + loss_u
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        apply_grads(state.optimizer, state.schedule, state.step,
                    average_grads(dict(zip(params, grads))))
        state.step += 1
        return state, {"loss": loss.detach(), "loss_sup": loss_s.detach(),
                       "loss_unsup": loss_u.detach(),
                       "logits": pred_s.detach()}

    return step


def make_decoder_eval_step(decoder, embed, criterion=None):
    """``batch -> {'logits'[, 'loss']}`` through the eval-mode decoder."""
    def step(batch):
        decoder.eval()
        with torch.no_grad():
            logits = decoder(embed(batch["image"]))
            out = {"logits": logits}
            if criterion is not None and "mask" in batch:
                out["loss"] = criterion(logits, batch["mask"])
        return out

    return step


def build(args, loaders=None, image_size=IMAGE_SIZE, encoder_kw=None):
    """The trainer for ``args``; ``loaders`` ({'train_sup', 'train_unsup',
    'val'}) replaces the folder datasets when given.  ``image_size`` and
    ``encoder_kw`` (ViTEncoder's ``dim`` / ``depth``) scale the run down
    for tests; the sweep's are 224 and ViT-B."""
    common.check_ported(args)
    for flag in ("load_weights", "load_hebbian_weights"):
        if getattr(args, flag):
            raise ValueError(f"--{flag}: the RAD-DINO decoder trains from "
                             f"its own init (hebbax accepts the flag and "
                             f"never reads it)")
    device = common.resolve_device(args.device)
    cfg = dataset_cfg(args.dataset_name)
    n_cls = cfg["NUM_CLASSES"]
    phase, tag = run_tag(args)
    paths = make_run_dir(args.path_root_exp, args.path_dataset, phase, tag,
                         1, args.regime, args.seed, debug=False)
    dump_config(paths, args)
    init_seeds(args.seed)
    if loaders is None:
        sup = common.make_loaders_2d(args, cfg, sup=True)
        loaders = {"train_sup": sup["train"], "val": sup["val"],
                   "train_unsup": common.make_loaders_2d(
                       args, cfg, sup=False, splits=("train",))["train"]}
    for ld in loaders.values():
        ld.dataset.size = (image_size, image_size)

    encoder_kw = dict(encoder_kw or {})
    encoder, pretrained = load_hf_rad_dino_params(frozen_encoder(
        args.seed, device, image_size=image_size, **encoder_kw))
    if not pretrained:
        print(OFFLINE_WARNING)
    decoder = RadDinoDecoder(n_cls, out_size=image_size, dim=encoder.dim,
                             device=device,
                             generator=make_generator(args.seed + 1))
    optimizer, schedule = common.build_optimizer(
        args, decoder.parameters(),
        steps_per_epoch=len(loaders["train_sup"]))
    state = TrainState(model=decoder, optimizer=optimizer, schedule=schedule)
    criterion = segmentation_loss(args.loss)
    embed = make_embed(encoder, image_size)
    trainer = SemiTrainer(
        state=state, train_step=make_decoder_step(decoder, embed, criterion),
        eval_step=make_decoder_eval_step(decoder, embed, criterion),
        loaders=loaders, num_classes=n_cls, paths=paths, args=args,
        device=device, palette=cfg["PALETTE"],
        unsup_weight=args.unsup_weight)
    trainer.encoder = encoder
    trainer.encoder_pretrained = pretrained
    return trainer


def main(argv=None, loaders=None):
    parser = add_args(common.base_parser_2d())
    args = parser.parse_args(argv)
    return common.train(build, args, loaders)


if __name__ == "__main__":
    main()
