"""Data parallelism over N cards or N CPU ranks (``hebbax/parallel``):
hebbax's global-batch semantics with explicit collectives
(:mod:`hebbax_torch.parallel.mesh`), and spatial sharding, eval forwards
split over the ranks along a spatial axis with explicit halo exchanges
(:mod:`hebbax_torch.parallel.spatial`)."""

from .mesh import (DEFAULT_TIMEOUT_S, active, average_grads,
                   batch_var_mean, disable, draw_rows, enable, gather_rows,
                   gmean, gsum, is_main, launch, pad_batch_to, rank,
                   resolve_world, rows, run_ranks, shard_global_batch,
                   sum_dict, sum_tensors, world_size)
from .spatial import (gather_spatial, halo_exchange, shard_spatial,
                      spatial_sharding)

__all__ = ["DEFAULT_TIMEOUT_S", "active", "average_grads", "batch_var_mean", "disable", "draw_rows", "enable", "gather_rows",
           "gather_spatial", "gmean", "gsum", "halo_exchange", "is_main",
           "launch", "pad_batch_to", "rank", "resolve_world", "rows",
           "run_ranks", "shard_global_batch", "shard_spatial",
           "spatial_sharding", "sum_dict", "sum_tensors", "world_size"]
