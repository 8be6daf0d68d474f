"""Semi-supervised 3D trainers: EM, UAMT, CPS, URPC, CCT, DTC
(``hebbax/cli/train_semi_3d.py``), the 2D family's steps and harnesses
(:func:`hebbax_torch.cli.train_semi_2d.make_trainer`) on NRRD patch
queues.

    python -m hebbax_torch.cli.train_semi_3d <em|uamt|cps|urpc|cct|dtc> \\
        --load_hebbian_weights <run>/checkpoints/last.ckpt --regime 10 ...

The first argument plays the role of hebbax's six root shims.  Run dirs
follow the reference's 3D tag scheme
(:func:`hebbax_torch.cli.train_sup_3d.run_dir_3d`), e.g.
``semi_sup/h_cps_unet3d_s2d_swta_t/inv_temp-K/regime-R/run-S`` or
``semi_sup/kaiming_dtc_unet3d_dtc_s2d/inv_temp-1/...``.  DTC reads the
train volumes' ``mask_sdf1`` maps.  The dual-model hand-off is the 2D
one: model 2 from seed + 7919 (plus model 1's loaded parameters under
``--load_hebbian_weights``), UAMT's teacher with model 1's Hebbian spec,
CPS validated through a weight-normalized twin.
"""

import functools
import sys

from ..config.datasets import dataset_cfg
from ..engine.loop import to_device_batch_3d
from ..utils.rundir import dump_config
from . import common, common3d
from .train_semi_2d import make_trainer
from .train_sup_3d import run_dir_3d

ALGOS = ("em", "uamt", "cps", "urpc", "cct", "dtc")
# hebbax's defaults (the s2d names run the unfolded networks here)
ALGO_NETWORK_DEFAULT = {"em": "unet3d_s2d", "uamt": "unet3d_s2d",
                        "cps": "unet3d_s2d", "urpc": "unet3d_urpc_s2d",
                        "cct": "unet3d_cct_s2d", "dtc": "unet3d_dtc_s2d"}


def add_args(parser, algo):
    parser.add_argument("-u", "--unsup_weight", default=1.0, type=float)
    parser.add_argument("--load_weights", default=None, type=str)
    parser.add_argument("--load_hebbian_weights", default=None, type=str)
    parser.add_argument("--hebbian_rule", default="swta_t", type=str)
    parser.add_argument("--hebb_inv_temp", default=1, type=int)
    if algo == "uamt":
        parser.add_argument("--ema_decay", default=0.99, type=float)
    if algo == "dtc":
        parser.add_argument("--beta", default=0.3, type=float)
    parser.set_defaults(network=ALGO_NETWORK_DEFAULT[algo])
    return parser


def build(args, algo, loaders=None):
    """The trainer of ``algo`` for ``args``; ``loaders`` ({'train_sup',
    'train_unsup', 'val'}) replaces the patch queues over
    ``--path_dataset`` when given."""
    if algo not in ALGOS:
        raise ValueError(f"unknown algorithm {algo!r}; one of {ALGOS}")
    common.check_ported(args)
    device = common.resolve_device(args.device)
    cfg = dataset_cfg(args.dataset_name)
    paths = run_dir_3d(args, algo=algo)
    dump_config(paths, args)
    if loaders is None:
        sup = common3d.make_queues_3d(args, cfg, sup=True,
                                      sdf=(algo == "dtc"))
        loaders = {"train_sup": sup["train"], "val": sup["val"],
                   "train_unsup": common3d.make_queues_3d(
                       args, cfg, sup=False, splits=("train",))["train"]}
    common3d.parse_patch_size(args)
    model, hebb = common3d.build_model_3d(
        args, cfg, device, load_hebbian=args.load_hebbian_weights,
        load_weights=args.load_weights)
    trainer = make_trainer(args, algo, cfg, device, model, hebb, loaders,
                           paths)
    trainer.to_device = functools.partial(to_device_batch_3d, device=device)
    return trainer


def build_parser(algo):
    return add_args(common3d.base_parser_3d(), algo)


def main(algo, argv=None, loaders=None):
    args = build_parser(algo).parse_args(argv)
    return common.train(build, args, algo, loaders)


if __name__ == "__main__":
    if len(sys.argv) < 2 or sys.argv[1] not in ALGOS:
        sys.exit(f"usage: python -m hebbax_torch.cli.train_semi_3d "
                 f"<{'|'.join(ALGOS)}> [flags]")
    main(sys.argv[1], sys.argv[2:])
