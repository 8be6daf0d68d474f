"""Parameter map between hebbax's flax variable trees and the port's
``state_dict``.

Module names are the same in both packages, so the map is mechanical:

  params/<path>/kernel (*k, I, O)      <->  <path>.weight (O, I, *k)
  params/<path>/kernel (*k, I, O)  (transpose conv)
                                       <->  <path>.weight (I, O, *k)
  params/<path>/kernel (I, O)  (Dense) <->  <path>.weight (O, I)  (Linear)
  params/<path>/bias                   <->  <path>.bias
  params/<path>/scale       (BN)       <->  <path>.weight (1-D)
  batch_stats/<path>/mean              <->  <path>.running_mean
  batch_stats/<path>/var               <->  <path>.running_var

e.g. ``encoder/in_conv/conv1/kernel`` is ``encoder.in_conv.conv1.weight``.
Both directions work on numpy trees (the flax side) and CPU tensors (the
torch side).

A 5-D kernel's layout cannot come from its shape: a conv's ``(O, I, *k)``
and a transpose conv's ``(I, O, *k)`` look alike, and at I == O a wrong
guess would load silently transposed.  So ``transposed`` — the dotted
module paths of the model's transpose convs
(:func:`hebbax_torch.hebb.layers.transposed_paths`) — decides it; a 5-D
kernel with ``transposed=None`` raises.  Without it a 4-D kernel is a 2D
conv's: the 2D networks have no transpose conv.
"""

import numpy as np
import torch


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v
    return out


def _insert(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _tensor(a):
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def _kernel_perm(name, ndim, transposed):
    """The axis permutation flax (*k, I, O) -> torch for a conv kernel of
    rank ``ndim`` under the module ``name``."""
    if ndim == 5 and transposed is None:
        raise ValueError(
            f"{name}: a 5-D kernel's layout needs the model's transpose "
            f"conv paths (pass transposed=transposed_paths(model))")
    nd = ndim - 2
    io = (nd, nd + 1) if name in (transposed or ()) else (nd + 1, nd)
    return io + tuple(range(nd))


def from_flax(params, batch_stats=None, transposed=None):
    """flax ``params`` / ``batch_stats`` trees -> state_dict;
    ``transposed``: the dotted paths of the transpose convs."""
    sd = {}
    for path, v in _flatten(params).items():
        mod, leaf = ".".join(path[:-1]), path[-1]
        v = np.asarray(v)
        if leaf == "kernel":
            if v.ndim in (4, 5):
                sd[mod + ".weight"] = _tensor(np.transpose(
                    v, _kernel_perm(mod, v.ndim, transposed)))
            elif v.ndim == 2:
                sd[mod + ".weight"] = _tensor(v.T)
            else:
                raise ValueError(f"{'/'.join(path)}: expected a conv or "
                                 f"Dense kernel, got shape {v.shape}")
        elif leaf == "scale":
            sd[mod + ".weight"] = _tensor(v)
        elif leaf == "bias":
            sd[mod + ".bias"] = _tensor(v)
        else:
            raise ValueError(f"unmapped flax param {'/'.join(path)}")
    for path, v in _flatten(batch_stats or {}).items():
        mod, leaf = ".".join(path[:-1]), path[-1]
        names = {"mean": "running_mean", "var": "running_var"}
        if leaf not in names:
            raise ValueError(f"unmapped flax batch stat {'/'.join(path)}")
        sd[f"{mod}.{names[leaf]}"] = _tensor(v)
    return sd


def to_flax(state_dict, transposed=None):
    """state_dict -> (params, batch_stats) numpy trees in flax layout;
    ``transposed``: the dotted paths of the transpose convs."""
    params, stats = {}, {}
    for name, t in state_dict.items():
        mod, leaf = name.rsplit(".", 1)
        path = tuple(mod.split("."))
        v = (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
             else np.asarray(t))
        if leaf == "weight" and v.ndim in (4, 5):
            perm = np.argsort(_kernel_perm(mod, v.ndim, transposed))
            _insert(params, path + ("kernel",),
                    np.ascontiguousarray(np.transpose(v, perm)))
        elif leaf == "weight" and v.ndim == 2:
            _insert(params, path + ("kernel",), np.ascontiguousarray(v.T))
        elif leaf == "weight" and v.ndim == 1:
            _insert(params, path + ("scale",), v)
        elif leaf == "bias":
            _insert(params, path + ("bias",), v)
        elif leaf == "running_mean":
            _insert(stats, path + ("mean",), v)
        elif leaf == "running_var":
            _insert(stats, path + ("var",), v)
        else:
            raise ValueError(f"unmapped state_dict entry {name}")
    return params, stats
