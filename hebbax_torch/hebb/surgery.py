"""Gradient merging and the pretraining freeze (``hebbax/hebb/surgery.py``).

  grad[kernel] = (1 - alpha) * grad_backprop[kernel] - alpha * delta

on the converted kernels only; freezing is which parameters the optimizer
is given.
"""

from .layers import HConv
from .spec import is_excluded


def pop_deltas(model):
    """{weight name: delta} of every HConv that sowed one since the last
    call; clears them."""
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, HConv) and m.delta is not None:
            out[f"{name}.weight"] = m.delta
            m.delta = None
    return out


def merge_hebbian_grads(params, grads, deltas, alpha):
    """Blend backprop grads with Hebbian deltas on converted kernels.

    params: {name: Parameter}; grads: {name: grad or None} (None = no
    backprop reached it, i.e. zero); deltas: {weight name: delta}.
    Returns a new {name: grad or None}."""
    out = dict(grads)
    for name, delta in deltas.items():
        if name not in params:
            continue
        g = out.get(name)
        # the delta is float32; a float64 network's grad stays float64
        merged = -alpha * delta.to(params[name].dtype)
        if g is not None:
            merged = (1.0 - alpha) * g + merged
        out[name] = merged
    return out


def pretrain_trainable_names(model, exclude):
    """Names of the parameters that train during Hebbian pretraining:
    conv kernels (Hebbian or backprop) and everything under an excluded
    module.  Converted conv biases and BN affine stay frozen; BN running
    statistics (buffers) still update."""
    names = []
    for name, _ in model.named_parameters():
        mod, leaf = name.rsplit(".", 1)
        if is_excluded(tuple(mod.split(".")), exclude):
            names.append(name)
        elif leaf == "weight" and isinstance(model.get_submodule(mod),
                                             HConv):
            names.append(name)
    return names
