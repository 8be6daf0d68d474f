"""Shared CLI plumbing for the 3D trainers (``hebbax/cli/common3d.py``):
the argparse surface, the patch queues and the model with the pretrain ->
fine-tune hand-off.

As in 2D, ``--device`` takes ``0`` (``cuda:0``), another card index, or
``cpu``, and an entry point raises without CUDA unless ``cpu`` was asked
for; ``--dtype bfloat16``, ``--resume``, ``--profile_dir`` and
``--dp_devices`` are hebbax's (:func:`hebbax_torch.cli.common.train`).
"""

import argparse
import os

from ..bridge import from_flax
from ..data.volumes3d import PatchQueue, VolumeDataset3D
from ..hebb.layers import transposed_paths
from ..utils.checkpoint import load_snapshot
from ..utils.seeding import init_seeds
from . import common


def base_parser_3d(defaults=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="0", type=str,
                   help="card index (cuda:<n>) or 'cpu'")
    p.add_argument("--path_root_exp", default="./runs")
    p.add_argument("--path_dataset", default="data/Atrial")
    p.add_argument("--dataset_name", default="Atrial")
    p.add_argument("--input1", default="image")
    p.add_argument("--regime", default=20, type=int)
    p.add_argument("-b", "--batch_size", default=1, type=int)
    p.add_argument("-e", "--num_epochs", default=200, type=int)
    p.add_argument("-s", "--step_size", default=50, type=int)
    p.add_argument("--optimizer", default="sgd", type=str)
    p.add_argument("-l", "--lr", default=0.1, type=float)
    p.add_argument("-g", "--gamma", default=0.5, type=float)
    p.add_argument("--patch_size", default=(96, 96, 80))
    p.add_argument("--loss", default="dice", type=str)
    p.add_argument("-w", "--warm_up_duration", default=20, type=int)
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--wd", default=-5, type=float)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("-i", "--display_iter", default=1, type=int)
    p.add_argument("--validate_iter", default=2, type=int)
    p.add_argument("--queue_length", default=48, type=int)
    p.add_argument("--samples_per_volume_train", default=4, type=int)
    p.add_argument("--samples_per_volume_val", default=8, type=int)
    p.add_argument("-n", "--network", default="unet3d_s2d", type=str)
    p.add_argument("--debug", default=False)
    p.add_argument("--init_weights", default="kaiming", type=str)
    p.add_argument("--num_workers", default=8, type=int)
    p.add_argument("--dp_devices", default=1, type=int,
                   help="data-parallel ranks: N cards (0 = every visible "
                        "card), or N CPU ranks with --device cpu")
    p.add_argument("--profile_dir", default=None, type=str,
                   help="trace epoch 1 with torch.profiler into this dir")
    p.add_argument("--dtype", default="float32", type=str,
                   help="model compute dtype: float32 | bfloat16 (params "
                        "stay f32)")
    p.add_argument("--resume", default=False,
                   help="write/consume <checkpoints>/resume.ckpt (model, "
                        "optimizer, step, epoch)")
    if defaults:
        p.set_defaults(**defaults)
    return p


def parse_tuple(v):
    """A size given on the command line as ``96,96,80`` or ``(96,96,80)``,
    or already a sequence, as a tuple of ints."""
    if isinstance(v, str):
        return tuple(int(x) for x in v.strip("()").split(","))
    return tuple(v)


def parse_patch_size(args):
    args.patch_size = parse_tuple(args.patch_size)
    return args.patch_size


def make_queues_3d(args, cfg, sup=True, sdf=False, splits=("train", "val")):
    """tio Queue-equivalent patch loaders over
    ``<path_dataset>/{train,val}``: the train split keeps the labelled
    volumes of the regime (``sup``) or their complement, and with ``sdf``
    carries their ``mask_sdf1`` maps (DTC)."""
    normalize = cfg.get("NORMALIZE", "mean")
    queues = {}
    for split in splits:
        sub = "val" if split == "val" else "train"
        ds = VolumeDataset3D(
            os.path.join(args.path_dataset, sub), args.input1,
            split=split, sup=True if split == "val" else sup,
            regime=args.regime if split == "train" else 100,
            seed=args.seed, normalize=normalize,
            num_classes=cfg["NUM_CLASSES"], sdf=sdf and split == "train",
            fmt=cfg.get("FORMAT", ".nrrd"))
        spv = (args.samples_per_volume_train if split == "train"
               else args.samples_per_volume_val)
        queues[split] = PatchQueue(
            ds, parse_patch_size(args), batch_size=args.batch_size,
            samples_per_volume=spv, max_length=args.queue_length,
            seed=args.seed, shuffle_subjects=(split == "train"),
            shuffle_patches=(split == "train"))
    return queues


def load_variables_into(model, variables, reinit=()):
    """Load a snapshot's variable tree into ``model``
    (:func:`hebbax_torch.cli.common.load_snapshot_into`), its kernels
    mapped by the model's module types (transpose convs by
    :func:`hebbax_torch.hebb.layers.transposed_paths`)."""
    state = from_flax(variables["params"], variables.get("batch_stats"),
                      transposed_paths(model))
    return common.load_snapshot_into(model, state, reinit)


def build_model_3d(args, cfg, device, load_hebbian=None, load_weights=None):
    """Model + the pretrain -> fine-tune hand-off: a Hebbian snapshot
    loads with alpha forced to 0 and its excluded modules' parameters
    re-initialised; a plain snapshot (``--load_weights``) loads EVERY
    parameter, the head included, as hebbax's 3D hand-off does (unlike
    2D, which re-initialises ``out_conv``)."""
    init_seeds(args.seed)
    hebb, variables = None, None
    if load_hebbian or load_weights:
        variables, meta = load_snapshot(load_hebbian or load_weights)
        if load_hebbian:
            hebb = common.hebbian_finetune_spec(meta)
    model = common.new_model(args, cfg, device, hebb)
    if variables is not None:
        load_variables_into(model, variables,
                            hebb.exclude if hebb is not None else ())
    return model, hebb
