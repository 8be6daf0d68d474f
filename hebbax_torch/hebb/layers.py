"""Convolutions with optional Hebbian plasticity (``hebbax/hebb/layers.py``
``HConv`` and ``HConvTranspose``), 2D or 3D by the kernel's rank.

When a :class:`~hebbax_torch.hebb.spec.HebbSpec` is attached and the
layer's path is not excluded, the layer

  * L2-normalizes its weight per filter before applying it (``w_nrm``;
    per output filter of a conv, per input channel of a transpose conv),
  * on a training forward with alpha != 0 computes the plasticity delta
    under ``torch.no_grad()`` from the RAW weight (the decay term
    ``r_sum * w`` uses it), the layer input, the output including bias,
    the bias and, for contrastive, a permutation of the batch
    (:meth:`HConv.draw_permutation`, hebbax's ``make_rng("hebb")``), and
    adds it to ``self.delta`` (hebbax's ``sow(reduce_fn=add)``);
    :func:`hebbax_torch.hebb.surgery.pop_deltas` collects and clears them,
  * keeps the parameters of the plain conv, so snapshots load across the
    pretrain -> fine-tune hand-off.

``compute_dtype`` (None: float32, the bias added inside the conv) is
flax's ``dtype=``: the float32 weight is normalized first, then weight
and input are cast to the dtype and convolved, and the bias, cast too, is
added after the conv in the dtype (two roundings, as hebbax's ``HConv``
does).  The delta takes float32 copies of the raw weight, of the CAST
input and of the output (hebbax's ``delta_compute_dtype``, float32).

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

INIT_TYPES = ("kaiming", "xavier", "normal", "orthogonal")
INIT_GAIN = 0.02


def init_weight_(weight, init_type="kaiming", generator=None,
                 gain=INIT_GAIN):
    """hebbax's ``torch_kernel_init`` on a torch-layout weight, drawn from
    ``generator``, with torch's fans: fan_in = dim1 * prod(k) and fan_out
    = dim0 * prod(k), so a transpose conv's (I, O, *k) weight has fan_in
    O * prod(k).  kaiming N(0, 2 / fan_in); xavier N(0, gain^2 * 2 /
    (fan_in + fan_out)); normal N(0, gain^2); orthogonal a semi-orthogonal
    (dim0, prod(rest)) matrix scaled by gain: rows O for a conv, I for a
    transpose conv."""
    rf = math.prod(weight.shape[2:])
    fan_in, fan_out = weight.shape[1] * rf, weight.shape[0] * rf
    with torch.no_grad():
        if init_type == "orthogonal":
            flat = torch.empty(weight.shape[0], weight[0].numel())
            nn.init.orthogonal_(flat, gain=gain, generator=generator)
            return weight.copy_(flat.reshape(weight.shape))
        if init_type == "kaiming":
            std = math.sqrt(2.0 / fan_in)
        elif init_type == "xavier":
            std = gain * math.sqrt(2.0 / (fan_in + fan_out))
        elif init_type == "normal":
            std = gain
        else:
            raise NotImplementedError(
                f"init {init_type!r}; one of {INIT_TYPES}")
        return weight.normal_(0.0, std, generator=generator)


def _tuple(v, nd):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * nd


class HConv(nn.Module):
    """Convolution with optional Hebbian plasticity; a tuple
    ``kernel_size`` of length 3 makes it 3D, an int a square 2D one.
    ``stride`` and ``padding`` are an int for every axis or a tuple.

    A contrastive site draws its batch permutation from
    ``hebb_generator`` (a CPU ``torch.Generator``, set on every HConv of a
    network by :func:`set_hebb_generator`), once per training forward, in
    call order; an instance may replace :meth:`draw_permutation` to
    inject one."""

    transpose = False

    def __init__(self, in_channels: int, features: int, kernel_size,
                 padding=0, init_type: str = "kaiming", device=None,
                 generator=None, stride=1):
        super().__init__()
        if init_type not in INIT_TYPES:
            raise NotImplementedError(
                f"init {init_type!r}; one of {INIT_TYPES}")
        nd = len(kernel_size) if isinstance(kernel_size,
                                            (tuple, list)) else 2
        self.nd = nd
        self.padding = _tuple(padding, nd)
        self.stride = _tuple(stride, nd)
        self.spec = None          # set by bind_paths once the path is known
        self.hebb_generator = None  # set by set_hebb_generator
        self.delta = None
        self.compute_dtype = None   # set by set_compute_dtype
        io = (in_channels, features) if self.transpose else (features,
                                                             in_channels)
        self.weight = nn.Parameter(torch.empty(
            io + _tuple(kernel_size, nd), device=device))
        # generator on the CPU: init draws the same numbers on every device
        w = torch.empty(self.weight.shape)
        init_weight_(w, init_type, generator)
        with torch.no_grad():
            self.weight.copy_(w)
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def _apply_conv(self, x, w, bias):
        return _CONV[self.nd](x, w, bias, stride=self.stride,
                              padding=self.padding)

    def draw_permutation(self, n):
        """The contrastive rule's permutation of a batch of ``n``, drawn
        on the CPU from ``hebb_generator``."""
        if self.hebb_generator is None:
            raise ValueError("a contrastive HConv needs a hebb_generator "
                             "(set_hebb_generator)")
        return torch.randperm(n, generator=self.hebb_generator)

    def forward(self, x):
        spec = self.spec
        w = self.weight
        if spec is not None and spec.w_nrm:
            w = rules.normalize(w, rules.weight_norm_dims(self.nd))
        dtype = self.compute_dtype
        if dtype is None:
            y = self._apply_conv(x, w, self.bias)
        else:
            x = x.to(dtype)
            y = self._apply_conv(x, w.to(dtype), None) + self.bias.to(
                dtype).view((-1,) + (1,) * self.nd)
        if spec is not None and self.training and spec.alpha != 0:
            perm = None
            if spec.conv_mode(self.transpose) == "contrastive":
                perm = self.draw_permutation(x.shape[0]).to(x.device)
            with torch.no_grad():
                d = rules.compute_delta(spec, self.weight.detach(),
                                        x.detach().float(),
                                        y.detach().float(), self.padding,
                                        self.transpose, self.stride,
                                        bias=self.bias.detach().float(),
                                        perm=perm)
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
                         device, generator, stride)

    def _apply_conv(self, x, w, bias):
        return _CONV_TRANSPOSE[self.nd](x, w, bias, stride=self.stride)


def bind_paths(model: nn.Module, hebb: Optional[HebbSpec]):
    """Give every HConv (and HConvTranspose) the spec it is under (None
    where excluded), from its dotted module path — what flax knows from
    ``self.path``."""
    for name, m in model.named_modules():
        if isinstance(m, HConv):
            m.spec = spec_if_active(hebb, tuple(name.split(".")))
    return model


def set_hebb_generator(model: nn.Module, generator):
    """The CPU generator every HConv of ``model`` draws its contrastive
    permutation from (hebbax's ``hebb`` rng stream)."""
    for m in model.modules():
        if isinstance(m, HConv):
            m.hebb_generator = generator
    return model


def set_compute_dtype(model: nn.Module, dtype):
    """flax's ``dtype=`` on a whole network: every module of ``model``
    with a ``compute_dtype`` (the HConvs and batch norms) computes in
    ``dtype`` (None: float32).  Parameters and BN statistics stay
    float32."""
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype
    return model


def transposed_paths(model: nn.Module):
    """The dotted paths of the model's transpose convs: the module type,
    not a weight's shape, decides a kernel's layout in a snapshot."""
    return {name for name, m in model.named_modules()
            if isinstance(m, HConvTranspose)}
