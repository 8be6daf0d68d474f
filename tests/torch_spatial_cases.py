"""The port's side of tests/test_torch_spatial.py, importable without JAX:
the cases that the spawned ranks run under
:func:`hebbax_torch.parallel.spatial_sharding` (ranks started by
``run_ranks(..., data_parallel=False)``).  Each case returns numpy arrays
or the refusals' messages; a forward case returns the gathered sharded
outputs and the same rank's unsharded forward of the same weights."""

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from hebbax_torch import parallel
from hebbax_torch.models import get_network
from hebbax_torch.models.common import resize_linear_align_corners
from hebbax_torch.utils.seeding import make_generator


def _outs(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def build(case):
    """The case's eval-mode port network: ``state`` carried in, or the
    port's own init from ``seed``."""
    model = get_network(case["name"], case["in_channels"], 2,
                        generator=make_generator(case.get("seed", 0)))
    if "state" in case:
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in case["state"].items()})
    return model.eval()


def forward_case(case):
    """{'sharded': the gathered outputs, 'plain': the unsharded ones,
    'local_rows': this rank's shard length}; ``double``: the network and
    input in float64."""
    model = build(case)
    x = torch.from_numpy(case["x"])
    if case.get("double"):
        model, x = model.double(), x.double()
    dim = case.get("dim", 0)
    with torch.no_grad():
        plain = _outs(model(x))
        xr = parallel.shard_spatial(x, dim)
        with parallel.spatial_sharding(dim):
            got = _outs(model(xr))
        sharded = [parallel.gather_spatial(g, dim) for g in got]
    return {"sharded": [t.numpy() for t in sharded],
            "plain": [t.numpy() for t in plain],
            "local_rows": int(xr.shape[2 + dim])}


def halo_case(case):
    """Every (lo, hi) halo of this rank's shard of ``x``."""
    x = torch.from_numpy(case["x"])
    dim = case.get("dim", 0)
    xr = parallel.shard_spatial(x, dim)
    return {f"{lo},{hi}": parallel.halo_exchange(xr, dim, lo, hi).numpy()
            for lo, hi in case["widths"]}


def resize_case(case):
    """The gathered sharded align-corners resize of ``x`` to ``size`` and
    the unsharded one: ``F.interpolate`` for float32 and, for bfloat16,
    ``models/common.py``'s matmul form."""
    x = torch.from_numpy(case["x"])
    if case.get("bf16"):
        x = x.to(torch.bfloat16)
    n = dist.get_world_size()
    local = list(case["size"])
    local[0] //= n
    with torch.no_grad():
        plain = resize_linear_align_corners(x, case["size"])
        xr = parallel.shard_spatial(x)
        with parallel.spatial_sharding():
            got = resize_linear_align_corners(xr, local)
        sharded = parallel.gather_spatial(got)
    return {"sharded": sharded.float().numpy(),
            "plain": plain.float().numpy()}


class _Flatten(nn.Module):
    """conv -> flatten -> linear: a head that mixes the sharded axis, on
    ``rows`` x 32 images."""

    def __init__(self, rows):
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 3, padding=1)
        self.fc = nn.Linear(4 * rows * 32, 2)

    def forward(self, x):
        return self.fc(torch.flatten(self.conv(x), 1))


def _refusal(run):
    """(exception class name, message) of ``run()``; None if it ran."""
    try:
        with torch.no_grad():
            run()
    except (ValueError, RuntimeError, NotImplementedError) as exc:
        return type(exc).__name__, str(exc)
    return None


def refusal_case(case):
    """What each refused input, op or mode raises, on every rank: a shard
    not divisible by 16, a train-mode forward, grad enabled, a flatten
    head, an adaptive pool, a mean over the sharded axis, ``ann_vgg``'s
    pools, ``unet_s2d``'s fold, an input that is not a shard, and data
    parallelism on."""
    unet = get_network("unet", 3, 2, generator=make_generator(0)).eval()
    n = dist.get_world_size()
    odd = parallel.shard_spatial(torch.zeros(1, 3, 24 * n, 32))
    ok = parallel.shard_spatial(torch.zeros(1, 3, 16 * n, 32))
    flat = _Flatten(16 * n).eval()
    ann = get_network("ann_vgg", 3, 2, generator=make_generator(0)).eval()
    folded = get_network("unet_s2d", 3, 2,
                         generator=make_generator(0)).eval()

    def sharded(fn, *args):
        def run():
            with parallel.spatial_sharding():
                fn(*args)
        return run

    def train_mode():
        unet.train()
        try:
            sharded(unet, ok)()
        finally:
            unet.eval()

    def grad_on():
        with torch.enable_grad(), parallel.spatial_sharding():
            unet(ok)

    def data_parallel():
        parallel.enable()
        try:
            sharded(unet, ok)()
        finally:
            parallel.disable()

    runs = {
        "not_divisible": sharded(unet, odd),
        "train_mode": train_mode,
        "grad_enabled": grad_on,
        "flatten_head": sharded(flat, parallel.shard_spatial(
            torch.zeros(1, 3, 16 * n, 32))),
        "adaptive_pool": sharded(
            lambda t: F.adaptive_avg_pool2d(t, 1), ok),
        "mean_over_axis": sharded(lambda t: t.mean(dim=(2, 3)), ok),
        "ann_vgg": sharded(ann, ok),
        "folded": sharded(folded, ok),
        "not_a_shard": sharded(unet, torch.zeros(1, 3, 16, 32)),
        "data_parallel": data_parallel,
        "odd_pool": sharded(lambda t: F.max_pool2d(t, 3), ok),
    }
    return {k: _refusal(run) for k, run in runs.items()}


CASES = {"forward": forward_case, "halo": halo_case, "resize": resize_case,
         "refusal": refusal_case}


def run_cases(cases):
    """Every case's result, in order (the function the ranks run)."""
    return [CASES[c["kind"]](c) for c in cases]
