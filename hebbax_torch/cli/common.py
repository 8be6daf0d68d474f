"""Shared CLI plumbing for the 2D trainers (``hebbax/cli/common.py``): the
argparse surface, device resolution, dataset/loader assembly, the model
with the pretrain -> fine-tune hand-off, and the optimizer/schedule stack.

``--device`` takes ``0`` (the default, ``cuda:0``), another card index, or
``cpu``.  Without CUDA an entry point raises unless ``cpu`` was asked for.
On the card TF32 is turned off for convolutions and matmuls, so the card
computes the float32 that the parity tests check.

``--dp_devices N`` runs a trainer data-parallel with hebbax's global-batch
semantics (:mod:`hebbax_torch.parallel`): :func:`train` starts N ranks
(NCCL on cards 0..N-1, or N gloo ranks with ``--device cpu``), each
building the trainer on its own card.
"""

import argparse
import os

import torch

from .. import parallel
from ..config.datasets import input_stats
from ..config.schedules import WarmupStepLR, make_optimizer
from ..data import Loader, SegDataset2D
from ..hebb.spec import HebbSpec, is_excluded
from ..models import get_network
from ..utils.checkpoint import load_state_dict
from ..utils.seeding import init_seeds, make_generator


def base_parser_2d(defaults=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="0", type=str,
                   help="card index (cuda:<n>) or 'cpu'")
    p.add_argument("--path_root_exp", default="./runs")
    p.add_argument("--path_dataset", default="data/GlaS")
    p.add_argument("--dataset_name", default="GlaS")
    p.add_argument("--input1", default="image")
    p.add_argument("--regime", default=20, type=int)
    p.add_argument("-b", "--batch_size", default=2, type=int)
    p.add_argument("-e", "--num_epochs", default=200, type=int)
    p.add_argument("-s", "--step_size", default=50, type=int)
    p.add_argument("--optimizer", default="sgd", type=str)
    p.add_argument("-l", "--lr", default=0.5, type=float)
    p.add_argument("-g", "--gamma", default=0.5, type=float)
    p.add_argument("--loss", default="dice", type=str)
    p.add_argument("-ds", "--deep_supervision", default=False)
    p.add_argument("-w", "--warm_up_duration", default=20, type=int)
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--wd", default=-5, type=float)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("-i", "--display_iter", default=1, type=int)
    p.add_argument("--validate_iter", default=2, type=int)
    p.add_argument("-n", "--network", default="unet_s2d", type=str)
    p.add_argument("--debug", default=True)
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
    p.add_argument("--device_augment", default=False,
                   help="run the train augmentation on the batch's device "
                        "(train_sup_2d / train_semi_2d)")
    if defaults:
        p.set_defaults(**defaults)
    return p


def check_ported(args):
    """Raise on a flag this machine cannot run: ``--dp_devices`` above the
    visible cards (or 0 with ``--device cpu``), naming both numbers
    (:func:`hebbax_torch.parallel.resolve_world`).  Every flag of the
    trainers is ported."""
    if getattr(args, "dp_devices", 1) != 1:
        parallel.resolve_world(args.dp_devices, args.device)


def _build_and_run(args, build, build_args):
    return build(args, *build_args).run()


def train(build, args, *build_args, **launch_kw):
    """``build(args, *build_args).run()`` under ``--dp_devices``
    (:func:`hebbax_torch.parallel.launch`: N spawned ranks, or the
    caller's process group); returns rank 0's result.  ``launch_kw``:
    the process group's ``timeout`` and the ``deadline`` (seconds) after
    which a spawned run's ranks are killed."""
    return parallel.launch(_build_and_run, args, build, build_args,
                           **launch_kw)


def model_dtype(args):
    """--dtype as the networks' compute dtype: None (float32) or
    ``torch.bfloat16``."""
    name = getattr(args, "dtype", "float32")
    if name in (None, "float32", "f32"):
        return None
    if name in ("bfloat16", "bf16"):
        return torch.bfloat16
    raise ValueError(f"unsupported dtype {name!r}")


def resolve_device(spec):
    """'cpu' -> the CPU; an index -> that CUDA card, with TF32 off.
    Raises when CUDA is missing and the CPU was not asked for."""
    if str(spec).lower() == "cpu":
        return torch.device("cpu")
    index = int(spec)
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {spec}: CUDA is not available (pass --device cpu "
            f"to run on the CPU)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", index)
    torch.cuda.set_device(device)
    return device


def make_loaders_2d(args, cfg, sup=True, regime=None,
                    splits=("train", "val")):
    """Loaders over ``<path_dataset>/{train,val}`` for ``splits``: the
    train split keeps the labelled files of ``regime`` (``sup``) or their
    unlabelled complement, without masks (``sup=False``)."""
    mean, std = input_stats(cfg, args.input1)
    loaders = {}
    regime = args.regime if regime is None else regime
    for split in splits:
        ds = SegDataset2D(
            os.path.join(args.path_dataset, split), args.input1, mean, std,
            split=split, sup=sup,
            regime=regime if split == "train" else 100, seed=args.seed)
        loaders[split] = Loader(
            ds, args.batch_size, shuffle=(split == "train"),
            seed=args.seed, num_workers=args.num_workers)
    return loaders


def hebbian_finetune_spec(meta):
    """HebbSpec for fine-tuning from a Hebbian snapshot: alpha forced to
    0, so the layers keep only the weight-normalized forward."""
    hp = dict(meta["hebb_params"])
    hp["alpha"] = 0.0
    return HebbSpec.from_dict(hp, exclude=meta.get("excluded_layers") or ())


def pretrain_base_network(name):
    """Folded (s2d) names map to their unfolded base for Hebbian
    pretraining, as hebbax's do (its delta path does not fold); the
    parameter trees are identical, so the snapshot hands off to either."""
    base = name.replace("_s2d_batched", "").replace("_s2d", "")
    from ..models import available_networks
    return base if base != name and base in available_networks() else name


def new_model(args, cfg, device, hebb=None):
    """The network named by args, initialised from args.seed (on the CPU,
    so a seed gives the same weights on every device) by
    ``--init_weights``, on ``device``, computing in ``--dtype``; dropout
    draws from seed+1 and the network's own streams
    (:func:`stream_generators`) from theirs."""
    return get_network(
        args.network, cfg["IN_CHANNELS"], cfg["NUM_CLASSES"],
        init_type=args.init_weights, hebb=hebb, device=device,
        generator=make_generator(args.seed),
        dropout_generator=make_generator(args.seed + 1, device),
        dtype=model_dtype(args), **stream_generators(args.seed, device))


HEBB_SEED_OFFSET = 6        # the contrastive permutations' stream: seed+6


def stream_generators(seed, device):
    """The generators of the networks' own random streams: on ``device``
    CCT perturbations from seed+2, the VAE latent from seed+3 and the
    SNN's Poisson spikes from seed+4; on the CPU the contrastive rule's
    batch permutations from seed+6 (the keyword arguments of
    :func:`hebbax_torch.models.get_network`; seed+5 is the device
    augmentation's)."""
    return {"perturb_generator": make_generator(seed + 2, device),
            "latent_generator": make_generator(seed + 3, device),
            "poisson_generator": make_generator(seed + 4, device),
            "hebb_generator": make_generator(seed + HEBB_SEED_OFFSET)}


def load_snapshot_into(model, state, reinit=()):
    """Load a snapshot ``state_dict`` into ``model``, as hebbax's hand-off
    and flax's tolerance of unused variables do.  Every entry of the
    model's own ``state_dict`` comes from the snapshot, except the
    parameters under the ``reinit`` modules (the Hebbian ``exclude`` list,
    or ``out_conv`` for ``--load_weights``), which keep their fresh values.
    Snapshot entries of modules the model lacks (a baseline's ``mu``,
    ``var``, ``reconstr``, ``out_superpix``) are ignored; an entry the
    model needs that the snapshot lacks, or has in another shape, raises
    naming it."""
    param_names = {n for n, _ in model.named_parameters()}
    own = model.state_dict()
    loaded = {}
    for name, fresh in own.items():
        if name in param_names and is_excluded(
                tuple(name.rsplit(".", 1)[0].split(".")), tuple(reinit)):
            loaded[name] = fresh
            continue
        if name not in state:
            raise RuntimeError(
                f"state_dict: the snapshot has no {name!r}, which "
                f"{type(model).__name__} needs")
        if tuple(state[name].shape) != tuple(fresh.shape):
            raise RuntimeError(
                f"state_dict: {name!r} is {tuple(state[name].shape)} in the "
                f"snapshot, {tuple(fresh.shape)} in "
                f"{type(model).__name__}")
        loaded[name] = state[name]
    model.load_state_dict(loaded)
    return model


def build_model_2d(args, cfg, device, load_hebbian=None, load_weights=None):
    """Model + the pretrain -> fine-tune hand-off
    (:func:`load_snapshot_into`): a Hebbian snapshot loads with alpha
    forced to 0 and its excluded modules' parameters re-initialised (BN
    statistics load for every module); a plain snapshot (e.g. a
    ``unet_vae`` or ``unet_superpix`` one) loads with the ``out_conv``
    head re-initialised and the baseline's extra modules dropped.  A
    snapshot that lacks what the network needs (e.g. ``unet`` into
    ``unet_urpc``) raises rather than loading in part."""
    init_seeds(args.seed)
    hebb, state, meta = None, None, None
    if load_hebbian:
        state, meta = load_state_dict(load_hebbian)
        hebb = hebbian_finetune_spec(meta)
    elif load_weights:
        state, _ = load_state_dict(load_weights)
    model = new_model(args, cfg, device, hebb)
    if state is not None:
        load_snapshot_into(model, state, hebb.exclude if hebb is not None
                           else ("out_conv",))
    return model, hebb


def build_optimizer(args, params, steps_per_epoch):
    """Optimizer over ``params`` + warmup/step schedule over optimizer
    steps; weight decay 5*10**wd for SGD only."""
    schedule = WarmupStepLR(args.lr, warmup=args.warm_up_duration,
                            step_size=args.step_size, gamma=args.gamma,
                            steps_per_epoch=steps_per_epoch)
    wd = 5 * 10 ** args.wd if args.optimizer == "sgd" else 0.0
    return make_optimizer(args.optimizer, params, momentum=args.momentum,
                          weight_decay=wd), schedule


AUGMENT_SEED_OFFSET = 5     # the device augmentation's stream: seed+5


def wrap_device_augment(train_step, generator):
    """A supervised step ``(state, batch, *rest)`` that first augments the
    batch's images and masks on their device
    (:func:`hebbax_torch.ops.augment_device.augment_batch`)."""
    from ..ops.augment_device import augment_batch

    def wrapped(state, batch, *rest):
        img, mask = augment_batch(generator, batch["image"], batch["mask"])
        return train_step(state, dict(batch, image=img, mask=mask), *rest)

    return wrapped


def wrap_device_augment_semi(train_step, generator):
    """A semi step ``(state, sup_batch, unsup_batch, *rest)`` that first
    augments the labelled batch (images and masks) and the unlabelled one
    (images), with separate draws."""
    from ..ops.augment_device import augment_batch

    def wrapped(state, sup_batch, unsup_batch, *rest):
        img_s, mask_s = augment_batch(generator, sup_batch["image"],
                                      sup_batch["mask"])
        img_u, _ = augment_batch(generator, unsup_batch["image"])
        return train_step(state, dict(sup_batch, image=img_s, mask=mask_s),
                          dict(unsup_batch, image=img_u), *rest)

    return wrapped


def enable_device_augment(trainer, args):
    """With ``--device_augment``, the train datasets give resized and
    normalized items only and the step augments on the device, from a
    CPU generator at seed+5 (hebbax's ``enable_device_augment``)."""
    if not getattr(args, "device_augment", False):
        return trainer
    generator = make_generator(args.seed + AUGMENT_SEED_OFFSET)
    if "train" in trainer.loaders:
        trainer.loaders["train"].dataset.host_augment = False
        trainer.train_step = wrap_device_augment(trainer.train_step,
                                                 generator)
    else:
        trainer.loaders["train_sup"].dataset.host_augment = False
        trainer.loaders["train_unsup"].dataset.host_augment = False
        trainer.train_step = wrap_device_augment_semi(trainer.train_step,
                                                      generator)
    return trainer
