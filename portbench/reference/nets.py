"""The plain reference network of a configuration, found by its
``arch``: ``reference/arch_<arch>.py`` beside this file, loaded by name
as ``spec.Cell.reader`` loads ``metrics/<name>.py``.  An arch module
gives

* ``params(cfg)``: [(name, shape)] of every parameter, in a fixed order;
* ``forward(net, P, x)``: the network on the parameter dict ``P``, built
  from the layers of ``net`` (a :class:`Net`: ``conv`` with its Hebbian
  normalisation, ``norm``);
* ``conv_sites(cfg, batch, spatial)``: every conv in forward order,
  {path, cin, cout, k, n, in_sp, out_sp, transpose};
* ``forward_flops(cfg, batch, spatial)``: the forward's FLOPs, two per
  multiply-add.

Batch norm normalises by the batch's biased variance (eps from the
configuration).  A Hebbian conv (with ``hebb_exclude`` given, every conv
whose path is not under an excluded module path) convolves with its
weight normalised per output filter (per input channel for a transpose
conv), as a Hebbian layer does with ``w_nrm``; ``record``, where set, is
called on each Hebbian conv with (path, raw weight, input, output,
padding, transpose, stride).  A transpose conv has kernel and stride 2.
"""

import importlib.util
import os

import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
_ARCHS = {}


def arch(name):
    """The module of ``arch_<name>.py`` beside this file."""
    path = os.path.join(HERE, f"arch_{name}.py")
    if path not in _ARCHS:
        if not os.path.exists(path):
            raise ValueError(f"unknown arch {name!r}: no file {path}")
        spec = importlib.util.spec_from_file_location(
            "portbench_arch_" + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _ARCHS[path] = mod
    return _ARCHS[path]


def excluded(path, exclude):
    """Whether a dotted module path lies under one of ``exclude``."""
    parts = path.split(".")
    return any(".".join(parts[:i]) in exclude
               for i in range(1, len(parts) + 1))


def normalize(w):
    """``w`` over the L2 norm of each slice along dim 0 (an output filter
    of a conv, an input channel of a transpose conv), a zero norm left
    at 1."""
    dims = tuple(range(1, w.dim()))
    n = torch.sqrt(torch.sum(w * w, dim=dims, keepdim=True))
    return w / torch.where(n == 0, torch.ones_like(n), n)


class Net:
    """A network of the configuration ``cfg``: ``params()`` lists its
    parameters, ``forward(P, x)`` runs it on the parameter dict ``P``."""

    def __init__(self, cfg, hebb_exclude=None):
        self.arch = arch(cfg["arch"])
        self.cfg = cfg
        self.hebb_exclude = hebb_exclude
        self.record = None

    def params(self):
        return self.arch.params(self.cfg)

    def hebbian(self, path):
        if self.hebb_exclude is None:
            return False
        return not excluded(path, self.hebb_exclude)

    # -- layers -----------------------------------------------------------

    def conv(self, P, path, x, padding=0, transpose=False, stride=1):
        w, b = P[f"{path}.weight"], P[f"{path}.bias"]
        hebbian = self.hebbian(path)
        wn = normalize(w) if hebbian else w
        if transpose:
            stride = 2
            y = F.conv_transpose3d(x, wn, b, stride=stride)
        else:
            y = F.conv3d(x, wn, b, padding=padding, stride=stride)
        if hebbian and self.record is not None:
            self.record(path, w, x, y, padding, transpose, stride)
        return y

    def norm(self, P, path, x):
        dims = (0,) + tuple(range(2, x.dim()))
        var, mean = torch.var_mean(x, dim=dims, unbiased=False,
                                   keepdim=True)
        view = (1, -1) + (1,) * (x.dim() - 2)
        return ((x - mean) * torch.rsqrt(var + self.cfg["bn_eps"])
                * P[f"{path}.weight"].view(view) + P[f"{path}.bias"].view(view))

    # -- network ----------------------------------------------------------

    def forward(self, P, x):
        return self.arch.forward(self, P, x)
