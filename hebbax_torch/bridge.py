"""Parameter map between hebbax's flax variable trees and the port's
``state_dict``.

Module names are the same in both packages, so the map is mechanical:

  params/<path>/kernel (kh, kw, I, O)  <->  <path>.weight (O, I, kh, kw)
  params/<path>/kernel (I, O)  (Dense) <->  <path>.weight (O, I)  (Linear)
  params/<path>/bias                   <->  <path>.bias
  params/<path>/scale       (BN)       <->  <path>.weight (1-D)
  batch_stats/<path>/mean              <->  <path>.running_mean
  batch_stats/<path>/var               <->  <path>.running_var

e.g. ``encoder/in_conv/conv1/kernel`` is ``encoder.in_conv.conv1.weight``.
Both directions work on numpy trees (the flax side) and CPU tensors (the
torch side).
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


def from_flax(params, batch_stats=None):
    """flax ``params`` / ``batch_stats`` trees -> state_dict."""
    sd = {}
    for path, v in _flatten(params).items():
        mod, leaf = ".".join(path[:-1]), path[-1]
        v = np.asarray(v)
        if leaf == "kernel":
            if v.ndim == 4:
                sd[mod + ".weight"] = _tensor(np.transpose(v, (3, 2, 0, 1)))
            elif v.ndim == 2:
                sd[mod + ".weight"] = _tensor(v.T)
            else:
                raise ValueError(f"{'/'.join(path)}: expected a 2D conv or "
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


def to_flax(state_dict):
    """state_dict -> (params, batch_stats) numpy trees in flax layout."""
    params, stats = {}, {}
    for name, t in state_dict.items():
        mod, leaf = name.rsplit(".", 1)
        path = tuple(mod.split("."))
        v = (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
             else np.asarray(t))
        if leaf == "weight" and v.ndim == 4:
            _insert(params, path + ("kernel",),
                    np.ascontiguousarray(np.transpose(v, (2, 3, 1, 0))))
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
