"""Slope timing of a training step (``hebbax/utils/timing.py``).

A run of steps ends in a barrier: ``torch.cuda.synchronize()`` when the
step's output lies on a card, then a host fetch of one scalar that
depends on the last step (the sum of its first output tensor).  The
fixed cost of the barrier and of the first dispatch is cancelled by the
slope between a run of ``n1`` steps and a run of ``n2`` steps:

    t_step = (T(n2) - T(n1)) / (n2 - n1)

On the CPU the same code runs without the synchronize.  hebbax's
``jitted_init`` (``model.init`` under ``jax.jit``, to compile a cold
model's initialisation once) has no counterpart: a torch module
initialises eagerly when it is built.
"""

import time

import torch


def _first_tensor(out):
    """The first tensor of ``out`` (a tensor, or a dict / list / tuple
    nesting them, in insertion order), or None."""
    if isinstance(out, torch.Tensor):
        return out
    values = out.values() if isinstance(out, dict) else (
        out if isinstance(out, (list, tuple)) else ())
    for v in values:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


def fetch(out):
    """Wait for the step that made ``out`` and pull one scalar of it to
    the host (the sum of its first tensor)."""
    t = _first_tensor(out)
    if t is None:
        raise ValueError("the step's output holds no tensor to fetch")
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return float(t.detach().sum())


def measure_step(step, state, *args, n1=10, n2=30, fetch=fetch, warmup=3):
    """Seconds per call of ``state, out = step(state, *args)``.

    The step threads ``state`` so the calls chain; ``fetch(out)`` must
    wait for the last call and pull data derived from it (by default
    :func:`fetch`)."""
    if not 0 < n1 < n2:
        raise ValueError(f"need 0 < n1 < n2, got n1={n1}, n2={n2}")
    s = state
    for _ in range(warmup):
        s, out = step(s, *args)
    if warmup:
        fetch(out)

    def run(n):
        nonlocal s, out
        t0 = time.perf_counter()
        for _ in range(n):
            s, out = step(s, *args)
        fetch(out)
        return time.perf_counter() - t0

    t1 = run(n1)
    t2 = run(n2)
    return max((t2 - t1) / (n2 - n1), 1e-9)
