"""Convolution with optional Hebbian plasticity (``hebbax/hebb/layers.py``
``HConv``, 2D forward convs).

When a :class:`~hebbax_torch.hebb.spec.HebbSpec` is attached and the
layer's path is not excluded, the layer

  * L2-normalizes its weight per output filter before applying it
    (``w_nrm``),
  * on a training forward with alpha != 0 computes the plasticity delta
    under ``torch.no_grad()`` from the RAW weight (the decay term
    ``r_sum * w`` uses it), the layer input and the output including bias,
    and adds it to ``self.delta`` (hebbax's ``sow(reduce_fn=add)``);
    :func:`hebbax_torch.hebb.surgery.pop_deltas` collects and clears them,
  * keeps the parameters of the plain conv, so snapshots load across the
    pretrain -> fine-tune hand-off.

Weights are ``(O, I, kh, kw)``; padding is applied natively by the conv.
"""

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import rules
from .spec import HebbSpec, spec_if_active


def kaiming_normal_(weight, generator=None):
    """torch fan_in convention: std = sqrt(2 / (I * kh * kw))."""
    fan_in = weight.shape[1] * math.prod(weight.shape[2:])
    with torch.no_grad():
        weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
    return weight


class HConv(nn.Module):
    """2D stride-1 convolution with optional Hebbian plasticity."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 padding: int = 0, init_type: str = "kaiming", device=None,
                 generator=None):
        super().__init__()
        if init_type != "kaiming":
            raise NotImplementedError(
                f"init {init_type!r} is not ported yet (kaiming only)")
        self.padding = (padding, padding)
        self.spec = None          # set by bind_paths once the path is known
        self.delta = None
        self.weight = nn.Parameter(torch.empty(
            features, in_channels, kernel_size, kernel_size, device=device))
        # generator on the CPU: init draws the same numbers on every device
        w = torch.empty(self.weight.shape)
        kaiming_normal_(w, generator)
        with torch.no_grad():
            self.weight.copy_(w)
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x):
        spec = self.spec
        w = self.weight
        if spec is not None and spec.w_nrm:
            w = rules.normalize(w, rules.WEIGHT_NORM_DIMS)
        y = F.conv2d(x, w, self.bias, padding=self.padding)
        if spec is not None and self.training and spec.alpha != 0:
            with torch.no_grad():
                d = rules.compute_delta(spec, self.weight.detach(),
                                        x.detach(), y.detach(), self.padding)
            self.delta = d if self.delta is None else self.delta + d
        return y


def bind_paths(model: nn.Module, hebb: Optional[HebbSpec]):
    """Give every HConv the spec it is under (None where excluded), from
    its dotted module path — what flax knows from ``self.path``."""
    for name, m in model.named_modules():
        if isinstance(m, HConv):
            m.spec = spec_if_active(hebb, tuple(name.split(".")))
    return model
