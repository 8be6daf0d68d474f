"""Convolutions with optional Hebbian plasticity (``hebbax/hebb/layers.py``
``HConv`` and ``HConvTranspose``), 2D or 3D by the kernel's rank.

When a :class:`~hebbax_torch.hebb.spec.HebbSpec` is attached and the
layer's path is not excluded, the layer

  * L2-normalizes its weight per filter before applying it (``w_nrm``;
    per output filter of a conv, per input channel of a transpose conv),
  * on a training forward with alpha != 0 computes the plasticity delta
    under ``torch.no_grad()`` from the RAW weight (the decay term
    ``r_sum * w`` uses it), the layer input and the output including bias,
    and adds it to ``self.delta`` (hebbax's ``sow(reduce_fn=add)``);
    :func:`hebbax_torch.hebb.surgery.pop_deltas` collects and clears them,
  * keeps the parameters of the plain conv, so snapshots load across the
    pretrain -> fine-tune hand-off.

Weights are torch's: ``(O, I, *k)`` for a conv, padding applied natively by
the conv; ``(I, O, *k)`` for a transpose conv, which never pads.  hebbax's
transpose orientation is torch's, so no kernel flip is involved.
"""

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import rules
from .spec import HebbSpec, spec_if_active

_CONV = {2: F.conv2d, 3: F.conv3d}
_CONV_TRANSPOSE = {2: F.conv_transpose2d, 3: F.conv_transpose3d}


def kaiming_normal_(weight, generator=None):
    """torch fan_in convention: std = sqrt(2 / (dim1 * prod(k))), i.e.
    I * prod(k) for a conv weight (O, I, *k) and O * prod(k) for a
    transpose-conv weight (I, O, *k)."""
    fan_in = weight.shape[1] * math.prod(weight.shape[2:])
    with torch.no_grad():
        weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
    return weight


def _tuple(v, nd):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * nd


class HConv(nn.Module):
    """Stride-1 convolution with optional Hebbian plasticity; a tuple
    ``kernel_size`` of length 3 makes it 3D, an int a square 2D one."""

    transpose = False

    def __init__(self, in_channels: int, features: int, kernel_size,
                 padding=0, init_type: str = "kaiming", device=None,
                 generator=None):
        super().__init__()
        if init_type != "kaiming":
            raise NotImplementedError(
                f"init {init_type!r} is not ported yet (kaiming only)")
        nd = len(kernel_size) if isinstance(kernel_size,
                                            (tuple, list)) else 2
        self.nd = nd
        self.padding = _tuple(padding, nd)
        self.stride = (1,) * nd
        self.spec = None          # set by bind_paths once the path is known
        self.delta = None
        io = (in_channels, features) if self.transpose else (features,
                                                             in_channels)
        self.weight = nn.Parameter(torch.empty(
            io + _tuple(kernel_size, nd), device=device))
        # generator on the CPU: init draws the same numbers on every device
        w = torch.empty(self.weight.shape)
        kaiming_normal_(w, generator)
        with torch.no_grad():
            self.weight.copy_(w)
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def _apply_conv(self, x, w):
        return _CONV[self.nd](x, w, self.bias, padding=self.padding)

    def forward(self, x):
        spec = self.spec
        w = self.weight
        if spec is not None and spec.w_nrm:
            w = rules.normalize(w, rules.weight_norm_dims(self.nd))
        y = self._apply_conv(x, w)
        if spec is not None and self.training and spec.alpha != 0:
            with torch.no_grad():
                d = rules.compute_delta(spec, self.weight.detach(),
                                        x.detach(), y.detach(), self.padding,
                                        self.transpose, self.stride)
            self.delta = d if self.delta is None else self.delta + d
        return y


class HConvTranspose(HConv):
    """Transpose convolution with optional Hebbian plasticity, no padding:
    output = (in - 1) * stride + k.  The weight is ``(I, O, *k)``."""

    transpose = True

    def __init__(self, in_channels: int, features: int, kernel_size,
                 stride=1, init_type: str = "kaiming", device=None,
                 generator=None):
        super().__init__(in_channels, features, kernel_size, 0, init_type,
                         device, generator)
        self.stride = _tuple(stride, self.nd)

    def _apply_conv(self, x, w):
        return _CONV_TRANSPOSE[self.nd](x, w, self.bias, stride=self.stride)


def bind_paths(model: nn.Module, hebb: Optional[HebbSpec]):
    """Give every HConv (and HConvTranspose) the spec it is under (None
    where excluded), from its dotted module path — what flax knows from
    ``self.path``."""
    for name, m in model.named_modules():
        if isinstance(m, HConv):
            m.spec = spec_if_active(hebb, tuple(name.split(".")))
    return model


def transposed_paths(model: nn.Module):
    """The dotted paths of the model's transpose convs: the module type,
    not a weight's shape, decides a kernel's layout in a snapshot."""
    return {name for name, m in model.named_modules()
            if isinstance(m, HConvTranspose)}
