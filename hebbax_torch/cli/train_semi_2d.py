"""Semi-supervised 2D trainers: EM, UAMT, CPS, URPC, CCT
(``hebbax/cli/train_semi_2d.py``), one build function parameterized by the
algorithm; :func:`make_trainer`, the part after the data and the model,
also serves the 3D CLI (``train_semi_3d``, which adds DTC).

    python -m hebbax_torch.cli.train_semi_2d <em|uamt|cps|urpc|cct> \\
        --load_hebbian_weights <run>/checkpoints/last.ckpt --regime 10 ...

The first argument plays the role of hebbax's five root shims.  Run dirs
follow the reference's tag scheme, e.g.
``semi_sup/h_cps_unet_s2d_swta_t/inv_temp-K/regime-R/run-S``.

The dual-model hand-off is hebbax's:
* UAMT's teacher is a network with model 1's Hebbian spec (weight-
  normalized forward) carrying model 2's parameters; CPS's model 2 is a
  plain network (no Hebbian spec);
* model 2 is initialised from seed + 7919; with ``--load_hebbian_weights``
  its parameters are that fresh init PLUS model 1's loaded parameters,
  while its BN statistics stay fresh.
"""

import argparse
import sys

import torch

from ..config.datasets import dataset_cfg
from ..engine.semi import (CPSTrainer, DualState, SemiTrainer,
                           UAMTDualTrainer, cct_unsup, deep4_sup, dtc_sup,
                           dtc_unsup, em_unsup, make_cps_step,
                           make_semi_step, make_uamt_step, urpc_unsup)
from ..engine.state import TrainState
from ..engine.steps import make_eval_step
from ..ops.losses import segmentation_loss
from ..utils.rundir import dump_config, make_run_dir
from ..utils.seeding import make_generator
from . import common

ALGOS = ("em", "uamt", "cps", "urpc", "cct")
# hebbax's defaults (the s2d names run the unfolded networks here)
ALGO_NETWORK_DEFAULT = {"em": "unet_s2d", "uamt": "unet_s2d",
                        "cps": "unet_s2d", "urpc": "unet_urpc_s2d",
                        "cct": "unet_cct_s2d"}
MODEL2_SEED_OFFSET = 7919


def add_args(parser, algo):
    parser.add_argument("-u", "--unsup_weight", default=1.0, type=float)
    parser.add_argument("--load_weights", default=None, type=str)
    parser.add_argument("--load_hebbian_weights", default=None, type=str)
    parser.add_argument("--hebbian_rule", default="swta_t", type=str)
    parser.add_argument("--hebb_inv_temp", default=1, type=int)
    if algo == "uamt":
        parser.add_argument("--ema_decay", default=0.99, type=float)
    parser.set_defaults(network=ALGO_NETWORK_DEFAULT[algo])
    return parser


def semi_run_tag(args, algo):
    """(phase, tag, inv_temp) of the run dir."""
    if args.regime >= 100:
        return "fully_sup", f"{algo}_{args.network}", 1
    if args.load_hebbian_weights:
        return ("semi_sup", f"h_{algo}_{args.network}_{args.hebbian_rule}",
                args.hebb_inv_temp)
    if args.load_weights:
        return "semi_sup", f"{algo}_{args.network}", 1
    return "semi_sup", f"{args.init_weights}_{algo}_{args.network}", 1


def _model2(args, cfg, device, hebb, model1, add_loaded):
    """Model 2 from seed + 7919; ``add_loaded`` adds model 1's parameters
    to its fresh ones (BN statistics stay fresh)."""
    args2 = argparse.Namespace(**dict(vars(args),
                                      seed=args.seed + MODEL2_SEED_OFFSET))
    model2 = common.new_model(args2, cfg, device, hebb)
    if add_loaded:
        with torch.no_grad():
            for p2, p1 in zip(model2.parameters(), model1.parameters()):
                p2.add_(p1)
    return model2


def single_model_losses(algo, criterion, num_classes, args):
    """(unsup_fn, sup_fn) of a single-model algorithm; sup_fn None means
    the criterion on the primary output."""
    if algo == "em":
        return em_unsup(num_classes), None
    if algo in ("urpc", "cct"):
        return (urpc_unsup if algo == "urpc" else cct_unsup,
                deep4_sup(criterion))
    return dtc_unsup, dtc_sup(criterion, beta=args.beta,
                              num_classes=num_classes)


def make_trainer(args, algo, cfg, device, model, hebb, loaders, paths):
    """The trainer of ``algo`` around ``model`` (with ``hebb``, the
    fine-tune spec of a Hebbian snapshot, or None) over ``loaders``
    ({'train_sup', 'train_unsup', 'val'}); shared by the 2D and 3D
    CLIs."""
    n_cls = cfg["NUM_CLASSES"]
    steps_per_epoch = len(loaders["train_sup"])
    optimizer, schedule = common.build_optimizer(
        args, model.parameters(), steps_per_epoch)
    criterion = segmentation_loss(args.loss)
    eval_step = make_eval_step(model, args.network, criterion)
    hebb_meta = {}
    if hebb is not None:
        hebb_meta = {"hebb_params": hebb.to_dict(),
                     "layers_excluded": list(hebb.exclude)}
    kw = dict(eval_step=eval_step, loaders=loaders, num_classes=n_cls,
              paths=paths, args=args, device=device, hebb_meta=hebb_meta,
              palette=cfg["PALETTE"], unsup_weight=args.unsup_weight)

    if algo not in ("uamt", "cps"):
        state = TrainState(model=model, optimizer=optimizer,
                           schedule=schedule)
        step = make_semi_step(model, args.network, criterion,
                              *single_model_losses(algo, criterion, n_cls,
                                                   args))
        return SemiTrainer(state=state, train_step=step, **kw)

    add_loaded = bool(args.load_hebbian_weights)
    if algo == "uamt":
        teacher = _model2(args, cfg, device, hebb, model, add_loaded)
        state = DualState(model1=model, optimizer1=optimizer,
                          schedule1=schedule, model2=teacher)
        step = make_uamt_step(
            model, teacher, args.network, criterion, args.num_epochs,
            ema_decay=args.ema_decay,
            generator=make_generator(args.seed + 4, device))
        return UAMTDualTrainer(state=state, train_step=step,
                               eval_model2=teacher, eval_step2=make_eval_step(
                                   teacher, args.network, criterion), **kw)

    model2 = _model2(args, cfg, device, None, model, add_loaded)
    optimizer2, schedule2 = common.build_optimizer(
        args, model2.parameters(), steps_per_epoch)
    state = DualState(model1=model, optimizer1=optimizer, schedule1=schedule,
                      model2=model2, optimizer2=optimizer2,
                      schedule2=schedule2)
    step = make_cps_step(model, model2, args.network, criterion)
    twin = common.new_model(args, cfg, device, hebb)
    return CPSTrainer(state=state, train_step=step, eval_model2=twin,
                      eval_step2=make_eval_step(twin, args.network,
                                                criterion), **kw)


def build(args, algo, loaders=None):
    """The trainer of ``algo`` for ``args``; ``loaders`` ({'train_sup',
    'train_unsup', 'val'}) replaces the folder datasets when given."""
    if algo not in ALGOS:
        raise ValueError(f"unknown algorithm {algo!r}; one of {ALGOS}")
    common.check_ported(args)
    device = common.resolve_device(args.device)
    cfg = dataset_cfg(args.dataset_name)
    phase, tag, inv_temp = semi_run_tag(args, algo)
    paths = make_run_dir(args.path_root_exp, args.path_dataset, phase, tag,
                         inv_temp, args.regime, args.seed,
                         debug=bool(args.debug))
    dump_config(paths, args)

    if loaders is None:
        sup = common.make_loaders_2d(args, cfg, sup=True)
        loaders = {"train_sup": sup["train"], "val": sup["val"],
                   "train_unsup": common.make_loaders_2d(
                       args, cfg, sup=False, splits=("train",))["train"]}
    model, hebb = common.build_model_2d(
        args, cfg, device, load_hebbian=args.load_hebbian_weights,
        load_weights=args.load_weights)
    return common.enable_device_augment(
        make_trainer(args, algo, cfg, device, model, hebb, loaders, paths),
        args)


def build_parser(algo):
    return add_args(common.base_parser_2d(), algo)


def main(algo, argv=None, loaders=None):
    args = build_parser(algo).parse_args(argv)
    return common.train(build, args, algo, loaders)


if __name__ == "__main__":
    if len(sys.argv) < 2 or sys.argv[1] not in ALGOS:
        sys.exit(f"usage: python -m hebbax_torch.cli.train_semi_2d "
                 f"<{'|'.join(ALGOS)}> [flags]")
    main(sys.argv[1], sys.argv[2:])
