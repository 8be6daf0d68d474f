"""Rank functions of tests/test_torch_multiclass.py and
tests/test_torch_cct_options.py, importable without JAX: each runs in one
process or on each of the ranks that :func:`hebbax_torch.parallel.run_ranks`
spawns, on that rank's rows of a global batch."""

import numpy as np
import torch
import torch.distributed as dist

from hebbax_torch import parallel
from hebbax_torch.hebb.spec import HebbSpec
from hebbax_torch.hebb.surgery import pop_deltas
from hebbax_torch.models.unet3d import UNet3DCCT
from hebbax_torch.ops.metrics import ConfusionAccumulator
from hebbax_torch.utils import remat


def _rank_rows(n):
    """(first row, row count, valid rows) of this rank's share of a global
    batch of ``n`` padded to a multiple of the ranks (all of it in one
    process), as the trainers' prep shards it."""
    if not parallel.active():
        return 0, n, n
    world = parallel.world_size()
    per = -(-n // world)
    lo = parallel.rank() * per
    return lo, per, max(0, min(per, n - lo))


def confusion_case(logits, target, n_cls):
    """The (None, Jaccard, Dice) of NHWC numpy logits and int targets,
    this rank's valid rows counted in two updates."""
    n = len(logits)
    total = -(-n // parallel.world_size()) * parallel.world_size()
    pad = total - n
    logits = np.concatenate([logits] + [logits[-1:]] * pad)
    target = np.concatenate([target] + [target[-1:]] * pad)
    lo, per, valid = _rank_rows(n)
    x = torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(logits[lo:lo + per], -1, 1)))[:valid]
    t = torch.from_numpy(target[lo:lo + per]).long()[:valid]
    acc = ConfusionAccumulator(n_cls)
    half = len(x) // 2
    acc.update(x[:half], t[:half]).update(x[half:], t[half:])
    return acc.finalize()


def rc_case(remat_on, policy="convs", batch=2, size=16, seed=0):
    """One training forward and backward of a 4-feature ``UNet3DCCT``
    (swta_t, K=50, ``conv`` excluded) on this rank's rows of a float64
    global batch, with the recompute ``remat_on`` or not.  Returns the
    grads, BN running statistics and Hebbian deltas, the number of
    ``dist.all_reduce`` calls the step made and the recomputations run."""
    counts = {"all_reduce": 0, "recomputed": 0}
    orig_reduce, orig_run = dist.all_reduce, remat.Tape.run

    def counting_reduce(*a, **k):
        counts["all_reduce"] += 1
        return orig_reduce(*a, **k)

    def counting_run(self):
        counts["recomputed"] += self.runs >= 1
        return orig_run(self)

    dist.all_reduce, remat.Tape.run = counting_reduce, counting_run
    try:
        spec = HebbSpec(mode="swta_t", k=50.0, w_nrm=True, alpha=1.0,
                        exclude=("conv",))
        model = UNet3DCCT(1, 2, init_features=4, hebb=spec,
                          generator=torch.Generator().manual_seed(seed),
                          perturb_generator=torch.Generator().manual_seed(
                              seed + 1),
                          remat=remat_on, remat_policy=policy).double()
        model.train()
        x = torch.randn((batch, 1, size, size, size), dtype=torch.float64,
                        generator=torch.Generator().manual_seed(seed + 2))
        lo, per, _ = _rank_rows(batch)
        outs = model(x[lo:lo + per])
        loss = sum(parallel.gmean(o ** 2) for o in outs)
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(loss, list(model.parameters()))
    finally:
        dist.all_reduce, remat.Tape.run = orig_reduce, orig_run
    return {"grads": {n: g.numpy() for n, g in zip(names, grads)},
            "stats": {k: v.numpy() for k, v in model.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))},
            "deltas": {k: v.numpy() for k, v in pop_deltas(model).items()},
            **counts}


def rc_pair(policy="convs"):
    """:func:`rc_case` without and with the recompute, on one rank."""
    return rc_case(False), rc_case(True, policy)
