"""Rank functions of tests/test_torch_s2d_nets.py, importable without JAX
(the spawned ranks import this module; it holds no test): each runs in
one process or on each of the ranks that
:func:`hebbax_torch.parallel.run_ranks` spawns, on that rank's rows of a
global batch."""

import torch

from hebbax_torch import parallel
from hebbax_torch.hebb.spec import HebbSpec
from hebbax_torch.hebb.surgery import pop_deltas
from hebbax_torch.models import registry

HEADS = {"unet_s2d": ("out_conv",), "unet_cct_s2d": ("out_conv",),
         "unet_urpc_s2d": ("out_conv_dp1", "out_conv_dp2", "out_conv_dp3",
                           "out_conv"),
         "unet3d_s2d": ("conv",), "unet3d_cct_s2d": ("conv",),
         "unet3d_cct_s2d_batched": ("conv",)}


def folded_step(name, batch=4, size=32, seed=0):
    """One Hebbian (swta_t, K=50, heads excluded) training forward and
    backward of ``name`` in float64 (3D: 4 initial features) on this
    rank's rows of a global batch, dropout and perturbations on.  Returns
    the global grads (the trainers' ``average_grads``), BN running
    statistics and this rank's Hebbian deltas."""
    nd = registry.network_meta(name)["nd"]
    in_ch = 3 if nd == 2 else 1
    extra = {} if nd == 2 else {"init_features": 4}
    spec = HebbSpec(mode="swta_t", k=50.0, w_nrm=True, alpha=1.0,
                    exclude=HEADS[name])
    model = registry._REGISTRY[name][0](
        in_channels=in_ch, n_cls=2, hebb=spec,
        generator=torch.Generator().manual_seed(seed),
        dropout_generator=torch.Generator().manual_seed(seed + 1),
        **({"perturb_generator": torch.Generator().manual_seed(seed + 2)}
           if "cct" in name else {}), **extra).double()
    model.train()
    x = torch.randn((batch, in_ch) + (size,) * nd, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(seed + 3))
    per = batch // parallel.world_size()
    lo = parallel.rank() * per
    outs = model(x[lo:lo + per])
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum(parallel.gmean(o ** 2) for o in outs)
    names = [n for n, _ in model.named_parameters()]
    grads = parallel.average_grads(dict(zip(names, torch.autograd.grad(
        loss, list(model.parameters())))))
    return {"grads": {n: g.numpy() for n, g in grads.items()},
            "stats": {k: v.numpy() for k, v in model.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))},
            "deltas": {k: v.numpy() for k, v in pop_deltas(model).items()}}
