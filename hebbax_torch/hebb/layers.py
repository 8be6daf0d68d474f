"""Convolutions with optional Hebbian plasticity (``hebbax/hebb/layers.py``
``HConv`` and ``HConvTranspose``), 2D or 3D by the kernel's rank, and
their space-to-depth folded forms (``FoldedHConv``, ``FoldedHConv3``,
``FoldedHConvTranspose3``, ``FoldedDownHConv3``): the same parameters,
the conv computed on folded tensors, the delta on the unfolded ones.

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
does).  The delta takes copies of the raw weight, of the CAST input and
of the output in hebbax's delta dtype (``HEBBAX_DELTA_DTYPE``, float32 by
default: :func:`rules.delta_compute_dtype`) and is kept in float32.  In a
recomputed forward (a checkpointed CCT decoder) no delta is recorded.

Weights are torch's: ``(O, I, *k)`` for a conv, padding applied natively by
the conv; ``(I, O, *k)`` for a transpose conv, which never pads.  hebbax's
transpose orientation is torch's, so no kernel flip is involved.
"""

import math
import os
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import world_size
from ..utils import remat, trace
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

    def _out_bias(self, b):
        """The bias as the conv's output channels hold it (a folded
        layer's is folded)."""
        return b

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
            y = self._apply_conv(x, w, self._out_bias(self.bias))
        else:
            x = x.to(dtype)
            y = self._apply_conv(x, w.to(dtype), None) + self._out_bias(
                self.bias.to(dtype)).view((-1,) + (1,) * self.nd)
        # a recomputed forward (a checkpointed CCT decoder) records
        # nothing: its first run recorded the delta
        if (spec is not None and self.training and spec.alpha != 0
                and not remat.replaying()):
            with remat.untracked():
                self._record_delta(spec, x, y)
        return y

    def _record_delta(self, spec, x, y):
        """Add this forward's delta to ``self.delta`` (hebbax's ``sow``),
        computed in ``HEBBAX_DELTA_DTYPE`` (:func:`rules.delta_compute_dtype`)
        on copies of the raw weight, the input, the output and the bias,
        and kept in float32."""
        perm = None
        if spec.conv_mode(self.transpose) == "contrastive":
            # a permutation of the global batch under data parallelism
            perm = self.draw_permutation(
                x.shape[0] * world_size()).to(x.device)
        ddt = rules.delta_compute_dtype()
        with torch.no_grad():
            d = rules.compute_delta(
                spec, self.weight.detach().to(ddt), x.detach().to(ddt),
                y.detach().to(ddt), self.padding, self.transpose,
                self.stride, bias=self.bias.detach().to(ddt), perm=perm,
                dtype=ddt).float()
        self.delta = d if self.delta is None else self.delta + d


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


class FoldedHConv(HConv):
    """A 2D stride-1 HConv computed in the space-to-depth folded layout
    (``hebbax/hebb/layers.py`` ``FoldedHConv``, :mod:`..ops.s2d`).

    The parameters are HConv's, the original ``(Co, Ci, k, k)`` weight
    and ``(Co,)`` bias, so snapshots, exclusion paths and the bridge do
    not change; the forward folds the (normalized, cast) weight into the
    block kernel and convolves the FOLDED input, ``in_groups`` the
    original channel counts of its concatenated sources.  ``depth`` 2
    folds twice (4x4 blocks: the folded operator is itself a stride-1
    conv on the folded lattice, so the kernel fold composes).

    Hebbian modes: swta and hpca (the _t modes resolve to them on a
    forward conv); another raises NotImplementedError, as in hebbax.  The
    delta unfolds x (per input group) and y and takes the port's
    :func:`rules.compute_delta` with the original padding, so an swta
    site reaches ``kernels.swta_delta``: the CUDA kernel on CUDA tensors,
    its plain version on CPU ones.  (hebbax calls its composed rule there
    directly, the same function without Pallas.)  ``HEBBAX_S2D_FOLDED_DELTA``
    set (read at the call, depth 1 only) takes the folded-layout weight
    gradient instead (:meth:`_folded_delta`): all 144 (tap, block) slots
    for the 36 real ones."""

    def __init__(self, in_groups, features: int, kernel_size: int,
                 depth: int = 1, init_type: str = "kaiming", device=None,
                 generator=None):
        in_groups = tuple(int(g) for g in in_groups)
        k = int(kernel_size)
        super().__init__(sum(in_groups), features, k, k // 2, init_type,
                         device, generator)
        self.in_groups = in_groups
        self.depth = depth

    def _apply_conv(self, x, w, bias):
        from ..ops import s2d

        groups = self.in_groups
        for _ in range(self.depth):
            w = s2d.fold_conv_kernel(w, groups)
            groups = tuple(4 * g for g in groups)
        return F.conv2d(x, w, bias, padding=self.padding)

    def _out_bias(self, b):
        from ..ops import s2d

        for _ in range(self.depth):
            b = s2d.fold_bias(b)
        return b

    def _unfold(self, t, groups):
        from ..ops import s2d

        parts, off = [], 0
        for g in groups:
            p = t[:, off:off + 4 ** self.depth * g]
            for _ in range(self.depth):
                p = s2d.unfold(p)
            parts.append(p)
            off += 4 ** self.depth * g
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    def _record_delta(self, spec, x, y):
        mode = spec.conv_mode(False)
        if mode not in ("swta", "hpca"):
            raise NotImplementedError(
                f"FoldedHConv supports swta/hpca, got {mode!r}")
        if self.depth != 1 and len(self.in_groups) != 1:
            raise NotImplementedError(
                "FoldedHConv delta at depth>1 supports single-group "
                "inputs only (the depth-2 sites are the MLP head)")
        if os.environ.get("HEBBAX_S2D_FOLDED_DELTA") and self.depth == 1:
            ddt = rules.delta_compute_dtype()
            with torch.no_grad():
                d = self._folded_delta(
                    spec, mode, self.weight.detach().to(ddt),
                    x.detach().to(ddt), y.detach().to(ddt)).float()
            self.delta = d if self.delta is None else self.delta + d
            return
        with torch.no_grad():
            xu = self._unfold(x.detach(), self.in_groups)
            yu = self._unfold(y.detach(), (self.weight.shape[0],))
        super()._record_delta(spec, xu, yu)

    def _folded_delta(self, spec, mode, w, x, y):
        """The delta from the folded-layout weight gradient of the folded
        conv against r = softmax(k y) per subpixel block (swta) or y
        (hpca), mapped back by :func:`s2d.unfold_wgrad`, then the
        unfolded rule's decay term."""
        from ..ops import s2d

        co, k = w.shape[0], w.shape[-1]
        if mode == "swta":
            cot = s2d.per_subpixel(
                lambda t: torch.softmax(spec.k * t, dim=1), y, co)
        else:
            cot = y
        pos_f = torch.nn.grad.conv2d_weight(
            x, s2d.folded_kernel_shape(k, self.in_groups, co), cot,
            padding=self.padding)
        pos = s2d.unfold_wgrad(pos_f, k, self.in_groups, co)
        rows = cot.reshape(cot.shape[0], 4, co, -1).transpose(0, 2)
        rows = rows.reshape(co, -1)                         # (Co, P)
        if mode == "swta":
            return pos - rows.sum(dim=1).view(-1, 1, 1, 1) * w
        m = (rows @ rows.T) * rules.sanger_tril(co, w.device,
                                                dtype=w.dtype)
        return pos - (m @ w.reshape(co, -1)).reshape(w.shape)


class FoldedHConv3(HConv):
    """A 3D stride-1 HConv computed in the space-to-depth folded layout
    (``hebbax/hebb/layers.py`` ``FoldedHConv3``, :mod:`..ops.s2d3d`) at
    per-axis factors ``fold``.  HConv's parameters; FOLDED input and
    output, ``in_groups`` the original channel counts of the input's
    concatenated sources.  The conv pads :func:`s2d3d.folded_pad3` (the
    trimmed kernel), the delta the original ``k // 2``.

    ``out_groups`` emits the output in grouped-concat order
    (:func:`s2d3d.group_out_perm` on the folded kernel and bias), so a
    residual add against a folded concat needs no :func:`s2d3d.regroup3`.

    Hebbian modes: swta and hpca, on the unfolded x and y through
    :func:`rules.compute_delta` (3D: the composed rules, as at the
    unfolded 3D sites); another raises NotImplementedError."""

    def __init__(self, in_groups, features: int, kernel_size: int,
                 fold=(2, 1, 1), out_groups=None, init_type: str = "kaiming",
                 device=None, generator=None):
        from ..ops import s2d3d

        in_groups = tuple(int(g) for g in in_groups)
        k = int(kernel_size)
        super().__init__(sum(in_groups), features, (k, k, k), k // 2,
                         init_type, device, generator)
        self.in_groups = in_groups
        self.fold = tuple(int(a) for a in fold)
        self.folded_pad = s2d3d.folded_pad3(k, self.fold)
        self.out_groups = (None if out_groups is None
                           else tuple(int(g) for g in out_groups))
        self._perm = (None if out_groups is None else torch.from_numpy(
            s2d3d.group_out_perm(features, self.out_groups, self.fold)))
        self._perm_on = {}

    def _permuted(self, t):
        if self._perm is None:
            return t
        if t.device not in self._perm_on:
            self._perm_on[t.device] = self._perm.to(t.device)
        return t.index_select(0, self._perm_on[t.device])

    def _apply_conv(self, x, w, bias):
        from ..ops import s2d3d

        with trace.span("hx.fold"):
            wf = self._permuted(s2d3d.fold_conv_kernel3(w, self.in_groups,
                                                        self.fold))
        return F.conv3d(x, wf, bias, padding=self.folded_pad)

    def _out_bias(self, b):
        from ..ops import s2d3d

        with trace.span("hx.fold"):
            return self._permuted(s2d3d.fold_bias3(b, self.fold))

    def _record_delta(self, spec, x, y):
        from ..ops import s2d3d

        mode = spec.conv_mode(False)
        if mode not in ("swta", "hpca"):
            raise NotImplementedError(
                f"FoldedHConv3 supports swta/hpca, got {mode!r}")
        pf = s2d3d.prodf(self.fold)

        def unfold(t, groups):
            parts, off = [], 0
            for g in groups:
                parts.append(s2d3d.unfold3(t[:, off:off + pf * g],
                                           self.fold))
                off += pf * g
            return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

        with torch.no_grad():
            xu = unfold(x.detach(), self.in_groups)
            yu = unfold(y.detach(),
                        self.out_groups or (self.weight.shape[0],))
        super()._record_delta(spec, xu, yu)


class FoldedHConvTranspose3(HConvTranspose):
    """A k=2/s=2 HConvTranspose (3D) whose OUTPUT is folded
    (``hebbax/hebb/layers.py`` ``FoldedHConvTranspose3``): the f == 2
    axes' taps absorb into output channel blocks
    (:func:`s2d3d.fold_transpose_kernel3`).  Unfolded input, HConvTranspose's
    parameters.  Every rule applies, on x and the unfolded y; a
    contrastive site draws its permutation from ``hebb_generator`` in
    call order, as an HConv does."""

    def __init__(self, in_channels: int, features: int, fold=(2, 1, 1),
                 init_type: str = "kaiming", device=None, generator=None):
        super().__init__(in_channels, features, (2, 2, 2), 2, init_type,
                         device, generator)
        self.fold = tuple(int(a) for a in fold)

    def _apply_conv(self, x, w, bias):
        from ..ops import s2d3d

        with trace.span("hx.fold"):
            wf, strides = s2d3d.fold_transpose_kernel3(w, self.fold)
        return F.conv_transpose3d(x, wf, bias, stride=strides)

    def _out_bias(self, b):
        from ..ops import s2d3d

        with trace.span("hx.fold"):
            return s2d3d.fold_bias3(b, self.fold)

    def _record_delta(self, spec, x, y):
        from ..ops import s2d3d

        with torch.no_grad():
            yu = s2d3d.unfold3(y.detach(), self.fold)
        super()._record_delta(spec, x, yu)


class FoldedDownHConv3(HConv):
    """The k=2/s=2 VALID HConv (3D; VNet's down_conv) CONSUMING a folded
    input (``hebbax/hebb/layers.py`` ``FoldedDownHConv3``): on the folded
    axes both taps lie in one folded voxel (:func:`s2d3d.fold_down_kernel3`),
    so at fold (2,2,2) the conv is a dense (8·Ci, Co) matmul.  A
    multi-group input is made standard first (:func:`s2d3d.regroup3`).
    The output is unfolded.  HConv(k=2, s=2)'s parameters; Hebbian modes
    swta and hpca on the unfolded x (another raises
    NotImplementedError)."""

    def __init__(self, in_groups, features: int, fold=(2, 2, 2),
                 init_type: str = "kaiming", device=None, generator=None):
        in_groups = ((int(in_groups),) if isinstance(in_groups, int)
                     else tuple(int(g) for g in in_groups))
        super().__init__(sum(in_groups), features, (2, 2, 2), 0, init_type,
                         device, generator, stride=2)
        self.in_groups = in_groups
        self.fold = tuple(int(a) for a in fold)

    def _standard(self, x):
        from ..ops import s2d3d

        if len(self.in_groups) > 1:
            return s2d3d.regroup3(x, self.in_groups, self.fold)
        return x

    def _apply_conv(self, x, w, bias):
        from ..ops import s2d3d

        with trace.span("hx.fold"):
            wf, strides = s2d3d.fold_down_kernel3(w, self.fold)
        return F.conv3d(self._standard(x), wf, bias, stride=strides)

    def _record_delta(self, spec, x, y):
        from ..ops import s2d3d

        mode = spec.conv_mode(False)
        if mode not in ("swta", "hpca"):
            raise NotImplementedError(
                f"FoldedDownHConv3 supports swta/hpca, got {mode!r}")
        with torch.no_grad():
            xu = s2d3d.unfold3(self._standard(x.detach()), self.fold)
        super()._record_delta(spec, xu, y)


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
