"""Fully/semi-supervised 2D baseline trainer, labels only
(``hebbax/cli/train_sup_2d.py``); with ``--load_hebbian_weights`` it is
the fine-tune step of the Hebbian bootstrap.

    python -m hebbax_torch.cli.train_sup_2d \\
        --load_hebbian_weights <run>/checkpoints/last.ckpt --regime 50 ...
"""

from ..config.datasets import dataset_cfg
from ..engine.loop import SupTrainer
from ..engine.state import TrainState
from ..engine.steps import make_eval_step, make_sup_train_step
from ..ops.losses import segmentation_loss
from ..utils.rundir import dump_config, make_run_dir, sup_run_tag
from . import common


def add_args(parser):
    parser.add_argument("--load_weights", default=None, type=str)
    parser.add_argument("--load_hebbian_weights", default=None, type=str)
    parser.add_argument("--hebbian_rule", default="swta_t", type=str)
    parser.add_argument("--hebb_inv_temp", default=1, type=int)
    return parser


def build(args, loaders=None):
    """The trainer for ``args``; ``loaders`` ({'train', 'val'}) replaces
    the folder datasets when given."""
    common.check_ported(args)
    device = common.resolve_device(args.device)
    cfg = dataset_cfg(args.dataset_name)
    phase, tag, inv_temp = sup_run_tag(args)
    paths = make_run_dir(args.path_root_exp, args.path_dataset, phase, tag,
                         inv_temp, args.regime, args.seed,
                         debug=bool(args.debug))
    dump_config(paths, args)

    if loaders is None:
        loaders = common.make_loaders_2d(args, cfg)
    model, hebb = common.build_model_2d(
        args, cfg, device, load_hebbian=args.load_hebbian_weights,
        load_weights=args.load_weights)
    # the schedule steps per epoch like the reference's scheduler.step()
    optimizer, schedule = common.build_optimizer(
        args, model.parameters(), steps_per_epoch=len(loaders["train"]))
    state = TrainState(model=model, optimizer=optimizer, schedule=schedule)

    criterion = segmentation_loss(args.loss)
    # -ds averages the loss over the heads of a deep4 network; a no-op
    # for single-output ones
    train_step = make_sup_train_step(
        model, args.network, criterion,
        deep_supervision=bool(args.deep_supervision))
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
    return common.enable_device_augment(trainer, args)


def main(argv=None, loaders=None):
    parser = add_args(common.base_parser_2d())
    args = parser.parse_args(argv)
    return common.train(build, args, loaders)


if __name__ == "__main__":
    main()
