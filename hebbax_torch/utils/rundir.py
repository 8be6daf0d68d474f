"""Run-directory convention and config dumping
(``hebbax/utils/rundir.py``), the reference experiment layout:

  <root>/<dataset>/<fully_sup|semi_sup|hebbian_unsup|...>/<tag>/
        inv_temp-<K>/regime-<R>/run-<seed>/
    checkpoints/  runs/  val_seg_preds/  [train_seg_preds/]  config.json
"""

import dataclasses
import json
import os


@dataclasses.dataclass
class RunPaths:
    run: str
    checkpoints: str
    tensorboard: str
    val_seg_preds: str
    train_seg_preds: str = None


def make_run_dir(path_root_exp, dataset_path, phase, tag, inv_temp, regime,
                 seed, debug=True):
    run = os.path.join(
        path_root_exp,
        os.path.split(dataset_path)[1],
        phase,
        tag,
        f"inv_temp-{inv_temp}",
        f"regime-{regime}",
        f"run-{seed}",
    )
    paths = RunPaths(
        run=run,
        checkpoints=os.path.join(run, "checkpoints"),
        tensorboard=os.path.join(run, "runs"),
        val_seg_preds=os.path.join(run, "val_seg_preds"),
        train_seg_preds=os.path.join(run, "train_seg_preds") if debug else None,
    )
    for p in dataclasses.asdict(paths).values():
        if p is not None:
            os.makedirs(p, exist_ok=True)
    return paths


def sup_run_tag(args):
    """Tag scheme for supervised/semi runs."""
    if args.regime < 100:
        if getattr(args, "load_hebbian_weights", None):
            return ("semi_sup", f"h_{args.network}_{args.hebbian_rule}",
                    args.hebb_inv_temp)
        if getattr(args, "load_weights", None):
            return "semi_sup", f"{args.network}", 1
        return "semi_sup", f"{args.init_weights}_{args.network}", 1
    return "fully_sup", f"{args.network}", 1


def dump_config(paths, args):
    """``config.json`` of the run's args (rank 0 alone writes it under
    data parallelism)."""
    from ..parallel import is_main
    if not is_main():
        return
    with open(os.path.join(paths.run, "config.json"), "w") as f:
        json.dump(
            {k: v for k, v in vars(args).items()},
            f, indent=2, default=str)
