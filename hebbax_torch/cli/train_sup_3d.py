"""Fully/semi-supervised 3D baseline, labels only, on patch queues
(``hebbax/cli/train_sup_3d.py``); with ``--load_hebbian_weights`` it is the
fine-tune step of the 3D Hebbian bootstrap.

    python -m hebbax_torch.cli.train_sup_3d -n unet3d --regime 20 \\
        --load_hebbian_weights <run>/checkpoints/last.ckpt ...
"""

import functools

from ..config.datasets import dataset_cfg
from ..engine.loop import SupTrainer, to_device_batch_3d
from ..engine.state import TrainState
from ..engine.steps import make_eval_step, make_sup_train_step
from ..ops.losses import segmentation_loss
from ..utils.rundir import dump_config, make_run_dir
from . import common, common3d


def add_args(parser):
    parser.add_argument("--load_weights", default=None, type=str)
    parser.add_argument("--load_hebbian_weights", default=None, type=str)
    parser.add_argument("--hebbian_rule", default="swta_t", type=str)
    parser.add_argument("--hebb_inv_temp", default=1, type=int)
    return parser


def run_dir_3d(args, algo=None):
    """The reference's 3D tag scheme (algo-prefixed for the semi
    trainers): ``semi_sup/h_<net>_<rule>`` from a Hebbian snapshot,
    ``semi_sup/<net>`` from other weights, ``semi_sup/<init>_<net>`` from
    scratch, ``fully_sup/<net>`` at regime 100."""
    net = args.network if algo is None else f"{algo}_{args.network}"
    if args.regime < 100:
        phase = "semi_sup"
        if getattr(args, "load_hebbian_weights", None):
            tag, inv = f"h_{net}_{args.hebbian_rule}", args.hebb_inv_temp
        elif getattr(args, "load_weights", None):
            tag, inv = net, 1
        else:
            tag, inv = f"{args.init_weights}_{net}", 1
    else:
        phase, tag, inv = "fully_sup", net, 1
    return make_run_dir(args.path_root_exp, args.path_dataset, phase, tag,
                        inv, args.regime, args.seed, debug=bool(args.debug))


def build(args, loaders=None):
    """The trainer for ``args``; ``loaders`` ({'train', 'val'}) replaces
    the patch queues over ``--path_dataset`` when given."""
    common.check_ported(args)
    device = common.resolve_device(args.device)
    cfg = dataset_cfg(args.dataset_name)
    paths = run_dir_3d(args)
    dump_config(paths, args)
    if loaders is None:
        loaders = common3d.make_queues_3d(args, cfg)
    common3d.parse_patch_size(args)
    model, hebb = common3d.build_model_3d(
        args, cfg, device, load_hebbian=args.load_hebbian_weights,
        load_weights=args.load_weights)
    optimizer, schedule = common.build_optimizer(
        args, model.parameters(), steps_per_epoch=len(loaders["train"]))
    state = TrainState(model=model, optimizer=optimizer, schedule=schedule)

    criterion = segmentation_loss(args.loss)
    train_step = make_sup_train_step(model, args.network, criterion)
    eval_step = make_eval_step(model, args.network, criterion)

    hebb_meta = {}
    if hebb is not None:
        hebb_meta = {"hebb_params": hebb.to_dict(),
                     "layers_excluded": list(hebb.exclude)}
    trainer = SupTrainer(
        state=state, train_step=train_step, eval_step=eval_step,
        loaders=loaders, num_classes=cfg["NUM_CLASSES"], paths=paths,
        args=args, device=device, hebb_meta=hebb_meta,
        palette=cfg["PALETTE"])
    trainer.to_device = functools.partial(to_device_batch_3d, device=device)
    return trainer


def build_parser():
    return add_args(common3d.base_parser_3d())


def main(argv=None, loaders=None):
    args = build_parser().parse_args(argv)
    return common.train(build, args, loaders)


if __name__ == "__main__":
    main()
