"""Data parallelism (``hebbax/parallel/mesh.py`` and the ``--dp_devices``
path of ``hebbax/engine/loop.py``).

hebbax's data parallelism is the single-device program over the global
batch, partitioned by XLA: the padded global batch is split contiguously
(rank r holds rows ``[r*B/N, (r+1)*B/N)`` of ``P('data')``), parameters
are replicated and every reduction is over the global batch.  The port
keeps those semantics with explicit collectives, so N ranks compute what
one process computes on the same padded batch:

* **the batch** — every rank iterates the same loader (same seed, same
  augmentation), pads the global batch to a multiple of N
  (:func:`pad_batch_to`: repeat the last sample, ``mask*`` integer keys
  with ``ignore_index``), attaches the 0/1 ``weight`` vector and keeps its
  rows (:func:`shard_global_batch`).  The host work repeats on each rank.
* **global sums** — a loss's denominators, a batch norm's statistics and
  every other batch reduction go through :func:`gsum`, an all-reduce whose
  backward all-reduces the gradient, so every rank holds the global value
  and the global loss.
* **gradients** — every rank takes ``torch.autograd.grad`` of that same
  global loss; :func:`average_grads` all-reduces the grads and divides by
  N (the backward all-reduces make each rank's grads N times its share).
  DDP's reducer hooks would never fire on ``autograd.grad``.
* **Hebbian deltas** — sums over batch x pixels with no per-batch
  normalisation, so :func:`sum_tensors` of the per-rank deltas is the
  global delta.
* **random draws** — :func:`draw_rows`: each rank draws what the single
  process draws for the whole padded batch, from a generator in the same
  state, and keeps its rows; generators stay in step on every rank.

Every collective is an ``all_reduce`` (SUM): a gather is a zero-filled
buffer that each rank fills with its rows (:func:`gather_rows`).  The
same code runs under NCCL, under gloo on the CPU and under gloo with
several ranks sharing one card (the torch docs' table gives gloo only
``all_reduce``, ``broadcast`` and ``barrier`` on CUDA tensors).

:func:`launch` starts the ranks of a CLI run with ``torch.multiprocessing``
spawn (NCCL on the first N cards, or N gloo ranks on the CPU) and a
``file://`` rendezvous in a temporary directory; :func:`enable` is the
library entry for a caller that owns its process group (``torchrun``).
"""

import datetime
import math
import os
import pickle
import shutil
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ..utils import remat

_STATE = {"world": 1, "rank": 0}

DEFAULT_TIMEOUT_S = 600.0


# -- the process group --------------------------------------------------------

def enable():
    """Run data-parallel over the initialised default process group."""
    if not dist.is_initialized():
        raise RuntimeError("data parallelism needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    _STATE.update(world=dist.get_world_size(), rank=dist.get_rank())


def disable():
    _STATE.update(world=1, rank=0)


def world_size():
    return _STATE["world"]


def rank():
    return _STATE["rank"]


def active():
    return _STATE["world"] > 1


def is_main():
    """True on rank 0 (and without data parallelism): the rank that
    prints and writes logs, TensorBoard, snapshots and ``resume.ckpt``."""
    return _STATE["rank"] == 0


# -- the batch ----------------------------------------------------------------

def _is_array(v):
    return hasattr(v, "shape") and getattr(v, "ndim", 0) > 0


def pad_batch_to(batch: dict, total: int, ignore_index: int = -1) -> dict:
    """Pad the batch dim of every array entry to ``total``: integer
    ``mask*`` entries with ``ignore_index`` (the padded samples drop out of
    every loss), the rest by repeating the last sample."""
    out = {}
    for k, v in batch.items():
        if _is_array(v) and v.shape[0] < total:
            n = v.shape[0]
            if k.startswith("mask") and np.issubdtype(v.dtype, np.integer):
                pad = np.full((total - n,) + v.shape[1:], ignore_index,
                              v.dtype)
            else:
                pad = np.repeat(v[-1:], total - n, axis=0)
            v = np.concatenate([np.asarray(v), pad], axis=0)
        out[k] = v
    return out


def shard_global_batch(batch: dict):
    """The host global batch -> (this rank's rows, the global valid count,
    this rank's valid count).

    The batch is padded to a multiple of the world size
    (:func:`pad_batch_to`) and gets the 0/1 ``weight`` vector of its valid
    samples (``hebbax/engine/loop.py`` ``enable_data_parallel``); entries
    that are not arrays (ids, patch locations) are dropped."""
    arrays = {k: np.asarray(v) for k, v in batch.items() if _is_array(v)}
    n_valid = next(iter(arrays.values())).shape[0]
    world = world_size()
    total = -(-n_valid // world) * world
    arrays = pad_batch_to(arrays, total)
    w = np.zeros(total, np.float32)
    w[:n_valid] = 1.0
    arrays["weight"] = w
    local = total // world
    lo = rank() * local
    mine = {k: v[lo:lo + local] for k, v in arrays.items()}
    return mine, n_valid, max(0, min(local, n_valid - lo))


def rows(x, axis=0):
    """This rank's contiguous rows of a global tensor along ``axis``."""
    n = x.shape[axis] // world_size()
    return x.narrow(axis, rank() * n, n)


def draw_rows(draw, shape, axis=0):
    """``draw(global_shape)`` for the global batch (``shape`` is the local
    one, its ``axis`` the batch axis), this rank's rows of it: every rank
    draws what one process draws for the whole padded batch, so the
    generators stay in step."""
    if not active():
        return draw(tuple(shape))
    shape = list(shape)
    shape[axis] *= world_size()
    return rows(draw(tuple(shape)), axis)


# -- collectives --------------------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    """All-reduce (SUM) whose backward all-reduces the gradient."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


class _ReplayedSum(torch.autograd.Function):
    """The all-reduced value a region's first run kept, with
    :class:`_AllReduceSum`'s backward: a recomputed forward makes no
    collective call."""

    @staticmethod
    def forward(ctx, x, kept):
        return kept.clone()

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.backward(ctx, g), None


def gsum(x):
    """``x`` summed over the ranks (identity without data parallelism),
    differentiable: call it on a rank's partial sum of a batch reduction.
    In a recomputed checkpoint region (:mod:`hebbax_torch.utils.remat`) it
    replays the sum its first run all-reduced."""
    if not active():
        return x
    tape = remat.current()
    with remat.untracked():
        if tape is not None and tape.replaying:
            return _ReplayedSum.apply(x, tape.next())
        y = _AllReduceSum.apply(x)
    if tape is not None:
        tape.keep(y.detach())
    return y


def gmean(x):
    """The global-batch mean of ``x`` (N, ...): ``torch.mean`` without
    data parallelism."""
    if not active():
        return torch.mean(x)
    return gsum(torch.sum(x)) / (x.numel() * world_size())


def batch_var_mean(x, dims):
    """(biased var, mean) of ``x`` over ``dims`` (which include the batch
    dim 0) across the global batch, as ``torch.var_mean(x, dims,
    unbiased=False)`` over the concatenated shards; two passes, the mean
    first."""
    if not active():
        return torch.var_mean(x, dim=dims, unbiased=False)
    count = math.prod(x.shape[d] for d in dims) * world_size()
    mean = gsum(torch.sum(x, dim=dims)) / count
    view = [1] * x.dim()
    for d in range(x.dim()):
        if d not in dims:
            view[d] = x.shape[d]
    var = gsum(torch.sum((x - mean.view(view)) ** 2, dim=dims)) / count
    return var, mean


def sum_tensors(tensors):
    """All-reduce (SUM) a list of tensors in place, coalesced into one
    buffer per dtype and device; returns the list."""
    if not active() or not tensors:
        return tensors
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    for idx in groups.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            tensors[i].copy_(flat[off:off + n].view_as(tensors[i]))
            off += n
    return tensors


def sum_dict(values):
    """{key: tensor} with every tensor summed over the ranks (the same
    keys in the same order on every rank)."""
    if not active():
        return values
    keys = list(values)
    out = sum_tensors([values[k].clone() for k in keys])
    return dict(zip(keys, out))


def average_grads(grads):
    """{key: grad or None} -> the grads summed over the ranks and divided
    by N; a None stays None (the same on every rank: one graph)."""
    if not active():
        return grads
    keys = [k for k, g in grads.items() if g is not None]
    world = float(world_size())
    summed = sum_tensors([grads[k].clone() for k in keys])
    out = dict(grads)
    for k, g in zip(keys, summed):
        out[k] = g / world
    return out


def gather_rows(x):
    """The global batch of ``x`` (B, ...) on every rank, no gradient: a
    zero buffer of the global shape that each rank fills with its rows,
    all-reduced."""
    if not active():
        return x
    n = x.shape[0]
    buf = torch.zeros((n * world_size(),) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    buf[rank() * n:(rank() + 1) * n] = x.detach()
    dist.all_reduce(buf)
    return buf


# -- launching ----------------------------------------------------------------

def resolve_world(n, device):
    """``--dp_devices`` -> the number of ranks.  On the card: 0 means every
    visible card, N above the visible count raises naming both; on the CPU
    (``--device cpu``) N gloo ranks, and 0 raises."""
    n = int(n)
    if n < 0:
        raise ValueError(f"--dp_devices {n}: must be >= 0")
    if str(device).lower() == "cpu":
        if n == 0:
            raise ValueError("--dp_devices 0 means every visible card; with "
                             "--device cpu give the number of ranks")
        return n
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        n = visible
    if n > visible or n == 0:
        raise ValueError(f"--dp_devices {n}: only {visible} CUDA cards "
                         f"are visible")
    return n


def _rank_entry(rank_, world, workdir, backend, device_type, threads,
                timeout, data_parallel, fn, fn_args):
    if threads:
        torch.set_num_threads(threads)
    if device_type == "cuda" and backend == "nccl":
        torch.cuda.set_device(rank_)
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(workdir, "rendezvous"),
        world_size=world, rank=rank_,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        if data_parallel:
            enable()
        result = fn(*fn_args)
        with open(os.path.join(workdir, f"result-{rank_}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        disable()
        dist.destroy_process_group()


def run_ranks(fn, world, fn_args=(), device_type="cpu", backend=None,
              timeout=DEFAULT_TIMEOUT_S, deadline=None, threads=None,
              data_parallel=True):
    """Run ``fn(*fn_args)`` on ``world`` spawned ranks joined in one
    process group, data parallelism enabled (:func:`enable`) unless
    ``data_parallel`` is False, as spatial sharding's ranks run
    (:mod:`.spatial`); returns every rank's result, in rank order.

    backend: 'nccl' on the card (rank r on ``cuda:r``), 'gloo' on the CPU
    or for ranks that share a card (the default follows ``device_type``).
    timeout: the process group's, in seconds, so a hung collective fails.
    deadline: seconds after which the ranks are killed and TimeoutError
    raised (None: no limit).  A rank's exception fails the call; nothing
    falls back."""
    import torch.multiprocessing as mp

    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    workdir = tempfile.mkdtemp(prefix="hebbax_dp_")
    try:
        ctx = mp.start_processes(
            _rank_entry, nprocs=world, join=False, start_method="spawn",
            args=(world, workdir, backend, device_type, threads,
                  float(timeout), data_parallel, fn, tuple(fn_args)))
        end = None if deadline is None else time.monotonic() + deadline
        while not ctx.join(timeout=1.0):
            if end is not None and time.monotonic() > end:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(
                    f"ranks still running after {deadline} s")
        out = []
        for r in range(world):
            with open(os.path.join(workdir, f"result-{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _cli_rank(target, args, target_args):
    if str(args.device).lower() != "cpu":
        args.device = str(rank())
    return target(args, *target_args)


def launch(target, args, *target_args, timeout=DEFAULT_TIMEOUT_S,
           deadline=None):
    """``target(args, *target_args)`` under ``--dp_devices``: the plain
    call at 1; inside a caller's initialised process group on its ranks
    (under NCCL each on the card the caller set current; under gloo, as
    when ranks share a card, ``args.device`` as given); else on N spawned
    ranks (NCCL on cards 0..N-1, or gloo with ``--device cpu``), each with
    ``args.device`` set to its card.  Returns rank 0's result (each rank's
    own inside a caller's group).  ``timeout`` and ``deadline`` are
    :func:`run_ranks`'s."""
    n = getattr(args, "dp_devices", 1)
    if n == 1:
        return target(args, *target_args)
    if dist.is_initialized():
        # the caller's ranks (which may share a card under gloo)
        if n not in (0, dist.get_world_size()):
            raise ValueError(f"--dp_devices {n}, but the process group "
                             f"has {dist.get_world_size()} ranks")
        enable()
        if dist.get_backend() == "nccl":
            args.device = str(torch.cuda.current_device())
        return target(args, *target_args)
    world = resolve_world(n, args.device)
    if world == 1:
        return target(args, *target_args)
    cpu = str(args.device).lower() == "cpu"
    threads = max(1, torch.get_num_threads() // world) if cpu else None
    return run_ranks(
        _cli_rank, world, (target, args, target_args),
        device_type="cpu" if cpu else "cuda",
        timeout=timeout, deadline=deadline, threads=threads)[0]
