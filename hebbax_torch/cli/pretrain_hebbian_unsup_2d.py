"""Unsupervised Hebbian pretraining, 2D
(``hebbax/cli/pretrain_hebbian_unsup_2d.py``).

Every non-excluded conv is Hebbian (a HebbSpec bound to the model); the
dice loss on the excluded head gives backprop grads only there; Hebbian
kernels update with grad = -delta (alpha=1) through the same optimizer;
converted conv biases and BN affine are frozen (not given to the
optimizer).  Deep-supervision networks (``unet_urpc``, ``unet_cct``)
average the loss over their four heads.  Snapshots carry hebb_params +
excluded_layers for the fine-tune hand-off.

    python -m hebbax_torch.cli.pretrain_hebbian_unsup_2d -n unet \\
        --exclude out_conv --hebb_mode swta_t --hebb_inv_temp 50 ...
"""

from ..config.datasets import dataset_cfg
from ..engine.loop import SupTrainer
from ..engine.state import TrainState
from ..engine.steps import make_eval_step, make_sup_train_step
from ..hebb.spec import HebbSpec
from ..hebb.surgery import pretrain_trainable_names
from ..models import network_meta
from ..ops.losses import segmentation_loss
from ..utils.rundir import dump_config, make_run_dir
from ..utils.seeding import init_seeds
from . import common


def add_args(parser):
    parser.add_argument("--exclude", nargs="*", default=["Conv_1x1"],
                        type=str)
    parser.add_argument("--hebb_mode", default="swta_t", type=str)
    parser.add_argument("--hebb_inv_temp", default=50.0, type=float)
    parser.add_argument("--hebb_w_nrm", default=True, type=bool)
    parser.add_argument("--hebb_alpha", default=1.0, type=float)
    parser.add_argument("--threshold", default=None, type=float)
    parser.set_defaults(optimizer="adam", regime=100)
    return parser


def build(args, loaders=None):
    """The trainer for ``args``; ``loaders`` ({'train', 'val'}) replaces
    the folder datasets when given."""
    common.check_ported(args)
    device = common.resolve_device(args.device)
    args.network = common.pretrain_base_network(args.network)
    cfg = dataset_cfg(args.dataset_name)
    paths = make_run_dir(
        args.path_root_exp, args.path_dataset, "hebbian_unsup",
        f"{args.network}_{args.hebb_mode}", int(args.hebb_inv_temp),
        100, args.seed, debug=bool(args.debug))
    dump_config(paths, args)

    spec = HebbSpec(mode=args.hebb_mode, k=args.hebb_inv_temp,
                    w_nrm=bool(args.hebb_w_nrm), alpha=args.hebb_alpha,
                    exclude=tuple(args.exclude))
    if loaders is None:
        loaders = common.make_loaders_2d(args, cfg, regime=100)
    n_cls = cfg["NUM_CLASSES"]
    init_seeds(args.seed)
    model = common.new_model(args, cfg, device, hebb=spec)

    trainable = set(pretrain_trainable_names(model, spec.exclude))
    optimizer, schedule = common.build_optimizer(
        args, [p for n, p in model.named_parameters() if n in trainable],
        steps_per_epoch=len(loaders["train"]))
    state = TrainState(model=model, optimizer=optimizer, schedule=schedule)

    criterion = segmentation_loss(args.loss)
    train_step = make_sup_train_step(
        model, args.network, criterion,
        # the heads of unet_urpc / unet_cct are averaged unconditionally
        deep_supervision=network_meta(args.network)["outputs"] == "deep4",
        hebb_alpha=spec.alpha,
        # alpha=1: backprop grads on converted kernels are scaled to zero,
        # so differentiate only the excluded head
        backprop_only=spec.exclude if spec.alpha == 1.0 else None)
    eval_step = make_eval_step(model, args.network, criterion)

    hebb_meta = {"hebb_params": spec.to_dict(),
                 "layers_excluded": list(spec.exclude)}
    return SupTrainer(
        state=state, train_step=train_step, eval_step=eval_step,
        loaders=loaders, num_classes=n_cls, paths=paths, args=args,
        device=device, hebb_meta=hebb_meta, palette=cfg["PALETTE"])


def main(argv=None, loaders=None):
    parser = add_args(common.base_parser_2d())
    args = parser.parse_args(argv)
    return common.train(build, args, loaders)


if __name__ == "__main__":
    main()
