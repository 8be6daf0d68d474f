"""Spatial sharding (``hebbax/parallel/mesh.py`` ``spatial_sharding``):
N ranks together compute the eval forward of a network on an input whose
first spatial axis (or another, ``dim``) is split contiguously over them.

hebbax shards H of NHWC (D of NDHWC) with ``P(None, 'data')`` and lets
XLA's SPMD partitioner insert every halo exchange; the networks do not
change.  PyTorch has no partitioner, so :func:`spatial_sharding` is a
``TorchFunctionMode`` that rewrites the ops of the port's networks that
read across the sharded axis, each exactly, and refuses every other op
that would:

* a stride-s conv with kernel k and padding p where 2p = k - s (3x3 pad 1,
  VNet's 5^3 pad 2, its k = s = 2 down convs) takes a p-row
  :func:`halo_exchange` and runs with no padding on that axis;
* a transpose conv with k = s and a max pool with kernel = stride map an
  even shard onto whole windows: local;
* an align-corners linear resize reads global rows: output row i reads
  input position ``i * (n_in - 1) / (n_out - 1)``, so a local resize is
  wrong away from rank 0.  Each of this shard's output rows mixes the two
  input rows the global resize reads (a halo) with the global resize's
  weights, and ``F.interpolate`` resizes the other axes; the matmul form
  ``models/common.py`` takes for other dtypes applies the global
  matrix's rows of this shard to the rows it reads;
* ``torch.var_mean`` over the sharded axis (instance norm) is global: sums
  and counts all-reduced, the variance in a second pass around the global
  mean;
* eval batch norm, elementwise ops, dtype or device copies, ``cat`` on
  another axis, ``repeat`` / ``repeat_interleave`` (a nearest resize by a
  whole multiple) and ``movedim`` are local.

Rank r holds rows ``[r*L/N, (r+1)*L/N)`` of the axis; outputs keep the
split; weights are replicated.  Which tensors are shards is tracked: a
tensor made by :func:`shard_spatial`, and every result the mode computes
from one, carries its sharded axis, so weights and constants pass through
untouched.  Everything refused raises, naming the op: a reshape, view or
flatten of a shard, a linear layer on a flattened map, attention, an
adaptive or average pool, indexing, any reduction over the axis other
than ``var_mean``, an op mixing a shard with a replicated tensor that
spans the axis, a training forward, grad mode, a shard length not
divisible by 16 (every network the mode runs halves the axis 4 times;
checked on the network's input, before any collective) and data
parallelism (:func:`hebbax_torch.parallel.run_ranks` starts ranks without
it when given ``data_parallel=False``).

Every collective is an ``all_reduce`` (SUM), as in :mod:`.mesh`, so the
same code runs under NCCL on several cards, gloo on the CPU and gloo with
ranks sharing one card.  Tensors stay on their device.

``dim`` counts spatial axes everywhere here: 0 is the first spatial axis
(tensor dim 2 of NCHW / NCDHW), hebbax's ``spatial_dim - 1``.
"""

import math

import torch
import torch.distributed as dist
from torch.overrides import TorchFunctionMode
from torch.nn.modules import module as nn_module

from . import mesh

# a shard's attribute: its sharded tensor dim, counted from the end
# (negative), so that broadcasting keeps it
_AXIS = "_hebbax_spatial_axis"
# how many times every network the mode runs halves the sharded axis
_HALVINGS = 4


def _world():
    """(ranks, this rank) of the default process group; (1, 0) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _tensor_dim(x, dim):
    if not 0 <= dim < x.dim() - 2:
        raise ValueError(f"spatial dim {dim} of a {x.dim()}-D tensor: "
                         f"NC + spatial axes expected")
    return 2 + dim


def _axis_of(t):
    return getattr(t, _AXIS, None) if isinstance(t, torch.Tensor) else None


def _mark(out, axis):
    """Tag every tensor of ``out`` (a tensor, or a tuple / list of them)
    as a shard along ``axis`` (negative); returns ``out``."""
    for t in (out if isinstance(out, (tuple, list)) else (out,)):
        if isinstance(t, torch.Tensor):
            setattr(t, _AXIS, axis)
    return out


# -- collectives ----------------------------------------------------------

def halo_exchange(x, dim, lo, hi):
    """``x`` with the ``lo`` rows before this rank's shard and the ``hi``
    rows after it concatenated on spatial ``dim``: rows ``[r*L - lo,
    (r+1)*L + hi)`` of the global tensor, zeros beyond its edges (the zero
    padding a conv would add).  Every rank writes its first ``min(hi, L)``
    and last ``min(lo, L)`` rows into its slot of a zero buffer, one
    all-reduce follows and each rank reads its neighbours' slots (several
    of them when a halo is longer than a shard).  Called by every rank
    with the same shapes."""
    if lo < 0 or hi < 0:
        raise ValueError(f"halo widths {lo}, {hi}: must be >= 0")
    axis = _tensor_dim(x, dim)
    if lo == 0 and hi == 0:
        return x
    world, rank = _world()
    n = x.shape[axis]
    hp, lp = min(hi, n), min(lo, n)
    slot = list(x.shape)
    slot[axis] = hp + lp
    buf = x.new_zeros([world] + slot)
    buf[rank].narrow(axis, 0, hp).copy_(x.narrow(axis, 0, hp))
    buf[rank].narrow(axis, hp, lp).copy_(x.narrow(axis, n - lp, lp))
    if world > 1:
        dist.all_reduce(buf)

    def rows_of(s, start, count):
        if 0 <= s < world:
            return buf[s].narrow(axis, start, count)
        shape = list(x.shape)
        shape[axis] = count
        return x.new_zeros(shape)

    parts = [x]
    if lo:      # the last rows of ranks r-k .. r-1, zeros before rank 0
        low = torch.cat([rows_of(s, hp, lp)
                         for s in range(rank - -(-lo // n), rank)], dim=axis)
        parts.insert(0, low.narrow(axis, low.shape[axis] - lo, lo))
    if hi:      # the first rows of ranks r+1 .. r+k, zeros after the last
        high = torch.cat([rows_of(s, 0, hp) for s in
                          range(rank + 1, rank + 1 + -(-hi // n))], dim=axis)
        parts.append(high.narrow(axis, 0, hi))
    return torch.cat(parts, dim=axis)


def shard_spatial(x, dim=0):
    """This rank's contiguous rows of the replicated tensor ``x`` along
    spatial ``dim`` (a copy, on ``x``'s device), tagged as a shard for
    :func:`spatial_sharding`.  The axis must split evenly over the
    ranks."""
    axis = _tensor_dim(x, dim)
    world, rank = _world()
    n = x.shape[axis]
    if n % world:
        raise ValueError(f"spatial dim {dim} of length {n} does not split "
                         f"over {world} ranks")
    local = n // world
    return _mark(x.narrow(axis, rank * local, local).clone(
        memory_format=torch.contiguous_format), axis - x.dim())


def gather_spatial(y, dim=0):
    """The whole tensor from every rank's shard ``y`` along spatial
    ``dim`` (the inverse of :func:`shard_spatial`), on every rank, no
    gradient: a zero buffer of the global shape that each rank fills with
    its rows, all-reduced (:func:`.mesh.gather_rows`'s way)."""
    axis = _tensor_dim(y, dim)
    world, rank = _world()
    if world == 1:
        return y.detach().clone()
    n = y.shape[axis]
    shape = list(y.shape)
    shape[axis] = n * world
    buf = y.new_zeros(shape)
    buf.narrow(axis, rank * n, n).copy_(y.detach())
    dist.all_reduce(buf)
    return buf


# -- the resize -----------------------------------------------------------

def _interp_matrix(n_in, n_out):
    """(n_out, n_in) float32 align-corners linear interpolation matrix
    (``models/common.py`` ``_linear_interp_matrix``: imported when first
    used, since the models import this package)."""
    from ..models.common import _linear_interp_matrix
    return _linear_interp_matrix(n_in, n_out)


def _read_rows(n_loc, n_out):
    """(lo, hi): the rows beyond a shard of ``n_loc`` that an
    align-corners linear resize to a local ``n_out`` reads, on any rank,
    plus one each side against float32 rounding of the source index."""
    world, _ = _world()
    m = _interp_matrix(n_loc * world, n_out * world)
    lo = hi = 0
    for r in range(world):
        cols = torch.nonzero(m[r * n_out:(r + 1) * n_out].any(0))
        lo = max(lo, r * n_loc - int(cols.min()) + 1)
        hi = max(hi, int(cols.max()) + 2 - (r + 1) * n_loc)
    return lo, hi


def _taps(n_in, n_out, first, count, dtype):
    """Output rows ``[first, first + count)`` of an align-corners linear
    resize from ``n_in`` rows to ``n_out``: the two input rows each reads
    and their weights, ``(i0, i1, w0, w1)``, computed in ``dtype`` as
    PyTorch's resize kernels compute them (source position ``i * ((n_in -
    1) / (n_out - 1))``, not ``i / factor``)."""
    scale = torch.tensor(float(n_in - 1) if n_out > 1 else 0.0,
                         dtype=dtype) / max(n_out - 1, 1)
    pos = scale * torch.arange(first, first + count, dtype=dtype)
    i0 = torch.floor(pos).long().clamp(max=n_in - 1)
    w1 = (pos - i0).clamp(0, 1)
    return i0, i0 + (i0 < n_in - 1).long(), 1 - w1, w1


def _resize_rows(func, x, axis, size, mode):
    """``F.interpolate`` (align-corners linear) of shard ``x`` to the
    local ``size``, each rank doing its share of the work and holding only
    its rows: ``F.interpolate`` resizes the other axes of this shard and
    the rows its output reads (a halo), then each output row on the
    sharded axis mixes its two input rows with the global resize's
    weights, ``t0 * w0 + t1 * w1`` with the first product fused.  On the
    CPU that is the trilinear kernel's own order (equal to the replicated
    call to the bit) and within a float32 ulp of the bilinear one's."""
    world, rank = _world()
    n_loc, n_out = x.shape[axis], size[axis - 2]
    if n_out == n_loc or world == 1:    # no rows to mix across shards
        return func(x, size=tuple(size), mode=mode, align_corners=True)
    lo, hi = _read_rows(n_loc, n_out)
    h = halo_exchange(x, axis - 2, lo, hi)
    inner = list(size)
    inner[axis - 2] = h.shape[axis]
    if tuple(inner) != tuple(h.shape[2:]):
        h = func(h, size=tuple(inner), mode=mode, align_corners=True)
    i0, i1, w0, w1 = _taps(n_loc * world, n_out * world, rank * n_out,
                           n_out, torch.promote_types(x.dtype, torch.float32))
    start = rank * n_loc - lo               # the global row of h's first
    shape = [1] * x.dim()
    shape[axis] = n_out
    dev = dict(device=x.device, dtype=x.dtype)
    y = h.index_select(axis, (i1 - start).to(x.device)).mul_(
        w1.to(**dev).view(shape))
    return y.addcmul_(h.index_select(axis, (i0 - start).to(x.device)),
                      w0.to(**dev).view(shape))


def _resize_matmul(x, axis, n_out, dtype):
    """The matmul form of the resize along the sharded ``axis`` of shard
    ``x`` (``models/common.py`` for non-float32 dtypes): the global
    interpolation matrix, cast to ``dtype``, restricted to this shard's
    output rows and the input rows they read (a halo)."""
    world, rank = _world()
    n_loc = x.shape[axis]
    lo, hi = _read_rows(n_loc, n_out)
    h = halo_exchange(x, axis - 2, lo, hi)
    m = _interp_matrix(n_loc * world, n_out * world)
    # global columns [r*L - lo, (r+1)*L + hi), zero beyond the edges
    c0 = rank * n_loc - lo
    cols = torch.zeros((n_out, n_loc + lo + hi), dtype=torch.float32)
    a, b = max(c0, 0), min(c0 + n_loc + lo + hi, m.shape[1])
    cols[:, a - c0:b - c0] = m[rank * n_out:(rank + 1) * n_out, a:b]
    cols = cols.to(dtype=dtype, device=x.device)
    y = torch.matmul(torch.movedim(h, axis, -1), cols.T)
    return torch.movedim(y, -1, axis)


# -- the mode -------------------------------------------------------------

# elementwise ops (and their in-place spellings, ``add_``), listed rather
# than read from ATen's pointwise tag, which differs between PyTorch
# versions
_POINTWISE = {
    "add", "sub", "mul", "div", "true_divide", "rsub", "neg", "abs", "pow",
    "exp", "log", "sqrt", "rsqrt", "reciprocal", "square", "sigmoid", "tanh",
    "relu", "relu6", "leaky_relu", "elu", "selu", "celu", "gelu", "silu",
    "mish", "softplus", "hardtanh", "hardsigmoid", "hardswish", "threshold",
    "clamp", "clip", "clamp_min", "clamp_max", "where", "maximum",
    "minimum", "lerp", "addcmul", "addcdiv", "sign", "floor", "ceil",
    "round", "trunc", "erf", "eq", "ne", "lt", "le", "gt", "ge",
    "logical_and", "logical_or", "logical_not", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "isnan", "isfinite", "nan_to_num",
    "masked_fill"}


def _pointwise(name):
    return name in _POINTWISE or name.rstrip("_") in _POINTWISE


# shape-preserving copies and metadata reads
_COPIES = {"to", "type", "float", "double", "half", "bfloat16", "contiguous",
           "clone", "detach", "cpu", "cuda", "zeros_like", "ones_like",
           "empty_like", "full_like"}
_META = {"size", "dim", "numel", "stride", "is_contiguous", "element_size",
         "data_ptr", "get_device", "is_floating_point", "is_complex",
         "len", "format", "repr", "hash", "storage_offset", "nelement",
         "ndimension"}
# Python operators named otherwise
_OPERATORS = {"truediv": "div", "and": "bitwise_and", "or": "bitwise_or",
              "xor": "bitwise_xor", "invert": "bitwise_not"}
_SPATIAL = {"conv2d", "conv3d", "conv_transpose2d", "conv_transpose3d",
            "max_pool2d", "max_pool3d", "interpolate"}


def _name(func):
    """The op's name: a property's own name, a Python operator's op
    (``__radd__`` and ``__iadd__`` -> ``add``, ``__truediv__`` ->
    ``div``)."""
    name = getattr(func, "__name__", repr(func))
    if name == "__get__":
        return getattr(getattr(func, "__self__", None), "__name__", name)
    if not (name.startswith("__") and name.endswith("__")):
        return name
    name = name[2:-2]
    if name not in _OPERATORS and name[:1] in ("r", "i") and (
            name[1:] in _OPERATORS or name[1:] in _POINTWISE):
        name = name[1:]
    return _OPERATORS.get(name, name)


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


def _arg(args, kwargs, i, key, default=None):
    if len(args) > i:
        return args[i]
    return kwargs.get(key, default)


def _per_axis(v, n):
    if isinstance(v, (tuple, list)):
        return tuple(v) if len(v) == n else tuple(v) * n
    return (v,) * n


class SpatialSharding(TorchFunctionMode):
    """The mode :func:`spatial_sharding` returns; see the module
    docstring."""

    def __init__(self, dim=0):
        super().__init__()
        if dim < 0:
            raise ValueError(f"spatial dim {dim}: must be >= 0")
        self.dim = dim
        self._hooks = ()
        self._depth = 0

    # -- entry and the network's input ----------------------------------

    def __enter__(self):
        if mesh.active():
            raise RuntimeError(
                "spatial sharding under data parallelism: start the ranks "
                "with run_ranks(..., data_parallel=False)")
        if torch.is_grad_enabled():
            raise RuntimeError("spatial sharding runs eval forwards only: "
                               "enter torch.no_grad() first")
        self._depth = 0
        self._hooks = (
            nn_module.register_module_forward_pre_hook(self._pre_hook),
            nn_module.register_module_forward_hook(self._post_hook,
                                                   always_call=True))
        return super().__enter__()

    def __exit__(self, *exc):
        for h in self._hooks:
            h.remove()
        self._hooks = ()
        return super().__exit__(*exc)

    def _pre_hook(self, module, args):
        # the post hook runs even when this one raises: count first
        self._depth += 1
        if module.training:
            raise RuntimeError(
                f"spatial sharding runs eval forwards only: "
                f"{type(module).__name__} is in train mode")
        if self._depth == 1:
            self._check_input(module, args)

    def _post_hook(self, module, args, out):
        self._depth -= 1

    def _check_input(self, module, args):
        """The network's input is a shard along ``dim`` whose length
        divides by ``2 ** _HALVINGS``: checked before any collective."""
        shards = [t for t in _tensors(args) if _axis_of(t) is not None]
        if not shards:
            raise ValueError(
                f"{type(module).__name__}'s input is not a shard: make it "
                f"with shard_spatial")
        for t in shards:
            axis = t.dim() + _axis_of(t)
            if axis != 2 + self.dim:
                raise ValueError(f"the input is sharded on tensor dim "
                                 f"{axis}, the mode on {2 + self.dim}")
            n, m = t.shape[axis], 2 ** _HALVINGS
            if n % m:
                raise ValueError(
                    f"shard length {n} on spatial dim {self.dim} is not "
                    f"divisible by 2**{_HALVINGS} = {m}: every level of "
                    f"the network halves it")

    # -- dispatch -------------------------------------------------------

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _name(func)
        if name in _META:
            return func(*args, **kwargs)
        axes = {_axis_of(t) for t in _tensors((args, kwargs))} - {None}
        if not axes:
            if name in _SPATIAL and isinstance(args[0], torch.Tensor):
                raise ValueError(f"{name} under spatial sharding on a "
                                 f"tensor that is not a shard (make the "
                                 f"input with shard_spatial)")
            return func(*args, **kwargs)
        if len(axes) > 1:
            raise NotImplementedError(
                f"spatial sharding: {name} mixes shards split on "
                f"different axes")
        axis = axes.pop()
        if getattr(func, "__name__", None) == "__get__":    # a property
            out = func(*args, **kwargs)
            if not isinstance(out, torch.Tensor):
                return out
            if name == "data":
                return _mark(out, axis)
            raise NotImplementedError(f"spatial sharding: {name} of a "
                                      f"shard")
        handler = getattr(self, "_op_" + name, None)
        if handler is not None:
            return handler(func, args, kwargs, axis)
        if name in _COPIES or _pointwise(name):
            return self._elementwise(name, func, args, kwargs, axis)
        raise NotImplementedError(
            f"spatial sharding cannot run {name!r} on a shard: it is not "
            f"one of the ops the mode knows to be exact on a split axis "
            f"(reshapes, linear layers, attention, adaptive pools and "
            f"reductions over the sharded axis are refused)")

    def _elementwise(self, name, func, args, kwargs, axis):
        """Local, when every replicated operand broadcasts along the
        sharded axis (extent 1 there, or fewer dims)."""
        for t in _tensors((args, kwargs)):
            if (_axis_of(t) is None and t.dim() >= -axis
                    and t.shape[axis] != 1):
                raise NotImplementedError(
                    f"spatial sharding: {name} combines a shard with a "
                    f"replicated tensor of shape {tuple(t.shape)} that "
                    f"spans the sharded axis")
        out = func(*args, **kwargs)
        return _mark(out, axis) if isinstance(out, torch.Tensor) and \
            out.dim() >= -axis else out

    def _grad_off(self, name):
        if torch.is_grad_enabled():
            raise RuntimeError(f"spatial sharding runs eval forwards only: "
                               f"{name} with grad enabled")

    # -- convolutions and pools -----------------------------------------

    def _conv(self, name, func, args, kwargs, axis, transpose):
        self._grad_off(name)
        x, w = args[0], args[1]
        nd = x.dim() - 2
        s = x.dim() + axis - 2
        if s < 0 or _axis_of(w) is not None:
            raise NotImplementedError(f"spatial sharding: {name} with the "
                                      f"weight or a non-spatial dim split")
        names = (("bias", "stride", "padding", "output_padding", "groups",
                  "dilation") if transpose else
                 ("bias", "stride", "padding", "dilation", "groups"))
        kw = {k: _arg(args, kwargs, i + 2, k) for i, k in enumerate(names)}
        kw = {k: v for k, v in kw.items() if v is not None}
        k = w.shape[2 + s]
        st = _per_axis(kw.get("stride", 1), nd)[s]
        pad = kw.get("padding", 0)
        if isinstance(pad, str):
            raise NotImplementedError(f"spatial sharding: {name} with "
                                      f"padding={pad!r}")
        pads = _per_axis(pad, nd)
        dil = _per_axis(kw.get("dilation", 1), nd)[s]
        n = x.shape[2 + s]
        if transpose:
            opad = _per_axis(kw.get("output_padding", 0), nd)[s]
            if not (k == st and pads[s] == 0 and opad == 0 and dil == 1):
                raise NotImplementedError(
                    f"spatial sharding: {name} on the sharded axis needs "
                    f"kernel == stride, no padding, no output padding")
            return _mark(func(x, w, **kw), axis)
        reach = dil * (k - 1) + 1
        p = pads[s]
        if 2 * p != reach - st or n % st:
            raise NotImplementedError(
                f"spatial sharding: {name} with kernel {k}, stride {st}, "
                f"padding {p}, dilation {dil} on a shard of {n}: only "
                f"2 * padding == reach - stride on a shard divisible by "
                f"the stride splits evenly")
        h = halo_exchange(x, s, p, p)
        kw["padding"] = tuple(0 if i == s else v for i, v in enumerate(pads))
        return _mark(func(h, w, **kw), axis)

    def _op_conv2d(self, func, args, kwargs, axis):
        return self._conv("conv", func, args, kwargs, axis, False)

    _op_conv3d = _op_conv2d

    def _op_conv_transpose2d(self, func, args, kwargs, axis):
        return self._conv("conv_transpose", func, args, kwargs, axis, True)

    _op_conv_transpose3d = _op_conv_transpose2d

    def _op_max_pool2d(self, func, args, kwargs, axis):
        x = args[0]
        nd = x.dim() - 2
        s = x.dim() + axis - 2
        k = _per_axis(_arg(args, kwargs, 1, "kernel_size"), nd)[s]
        st = _arg(args, kwargs, 2, "stride")
        st = k if st in (None, ()) else _per_axis(st, nd)[s]
        p = _per_axis(_arg(args, kwargs, 3, "padding", 0), nd)[s]
        dil = _per_axis(_arg(args, kwargs, 4, "dilation", 1), nd)[s]
        if (k != st or p or dil != 1 or x.shape[2 + s] % k
                or _arg(args, kwargs, 6, "return_indices", False)):
            raise NotImplementedError(
                f"spatial sharding: max pool {k}/{st} pad {p} on a shard "
                f"of {x.shape[2 + s]}: only kernel == stride on a shard "
                f"it divides, without indices")
        return _mark(func(*args, **kwargs), axis)

    _op_max_pool3d = _op_max_pool2d

    # -- resizes --------------------------------------------------------

    def _op_interpolate(self, func, args, kwargs, axis):
        x = args[0]
        s = x.dim() + axis - 2
        nd = x.dim() - 2
        size = _arg(args, kwargs, 1, "size")
        scale = _arg(args, kwargs, 2, "scale_factor")
        mode = _arg(args, kwargs, 3, "mode", "nearest")
        align = _arg(args, kwargs, 4, "align_corners")
        n_in = x.shape[2 + s]
        if size is not None:
            out = list(_per_axis(size, nd))
        else:
            out = [math.floor(x.shape[2 + i] * f)
                   for i, f in enumerate(_per_axis(scale, nd))]
        n_out = out[s]
        if mode not in ("linear", "bilinear", "trilinear") or not align \
                or _arg(args, kwargs, 6, "antialias", False):
            raise NotImplementedError(
                f"spatial sharding: interpolate mode={mode!r} "
                f"align_corners={align} from {n_in} to {n_out} rows on the "
                f"sharded axis (only align-corners linear resizes are "
                f"exact)")
        self._grad_off("interpolate")
        return _mark(_resize_rows(func, x, x.dim() + axis, out, mode), axis)

    def _op_matmul(self, func, args, kwargs, axis):
        """``models/common.py``'s resize of a non-float32 shard: a matmul
        of the sharded axis, moved last, with the local interpolation
        matrix's transpose; anything else contracting the axis raises."""
        a, b = args[0], args[1]
        if _axis_of(b) is not None or b.dim() != 2:
            raise NotImplementedError("spatial sharding: matmul of two "
                                      "shards, or with a batched operand")
        if axis != -1:          # the contraction is over another axis
            return _mark(func(a, b), axis)
        n_in, n_out = b.shape
        local = _interp_matrix(n_in, n_out).to(dtype=b.dtype,
                                               device=b.device)
        if not torch.equal(b, local.T):
            raise NotImplementedError(
                "spatial sharding: matmul contracting the sharded axis "
                "(only the align-corners resize's matrix is known)")
        self._grad_off("matmul")
        return _mark(_resize_matmul(a, a.dim() - 1, n_out, b.dtype), axis)

    def _op_repeat_interleave(self, func, args, kwargs, axis):
        x = args[0]
        dim = _arg(args, kwargs, 2, "dim")
        if dim is None or not isinstance(_arg(args, kwargs, 1, "repeats"),
                                         int):
            raise NotImplementedError("spatial sharding: repeat_interleave "
                                      "flattening or with per-row counts")
        return _mark(func(*args, **kwargs), axis)

    def _op_repeat(self, func, args, kwargs, axis):
        sizes = args[1] if len(args) == 2 and isinstance(
            args[1], (tuple, list, torch.Size)) else args[1:]
        if tuple(sizes)[len(sizes) + axis] != 1:
            raise NotImplementedError("spatial sharding: repeat along the "
                                      "sharded axis")
        return _mark(func(*args, **kwargs), axis)

    # -- statistics -----------------------------------------------------

    def _op_var_mean(self, func, args, kwargs, axis):
        """Over dims that hold the sharded axis (instance norm): the global
        mean, then the variance around it, each an all-reduced sum over
        the global count (:func:`.mesh.batch_var_mean`'s two passes)."""
        x = args[0]
        dims = _arg(args, kwargs, 1, "dim")
        if dims is None:
            raise NotImplementedError("spatial sharding: var_mean over all "
                                      "dims")
        dims = tuple(d % x.dim() for d in (
            dims if isinstance(dims, (tuple, list)) else (dims,)))
        keep = _arg(args, kwargs, 3, "keepdim", False)
        if x.dim() + axis not in dims:
            raise NotImplementedError("spatial sharding: var_mean that "
                                      "keeps the sharded axis")
        self._grad_off("var_mean")
        if "correction" in kwargs:
            corr = kwargs["correction"]
        else:
            corr = int(bool(_arg(args, kwargs, 2, "unbiased", True)))
        world, _ = _world()
        count = math.prod(x.shape[d] for d in dims) * world
        mean = torch.sum(x, dim=dims, keepdim=True)
        if world > 1:
            dist.all_reduce(mean)
        mean = mean / count
        sq = torch.sum((x - mean) ** 2, dim=dims, keepdim=True)
        if world > 1:
            dist.all_reduce(sq)
        var = sq / (count - corr)
        if not keep:
            var, mean = var.squeeze(dims), mean.squeeze(dims)
        return var, mean

    def _op_batch_norm(self, func, args, kwargs, axis):
        if _arg(args, kwargs, 5, "training", False):
            raise RuntimeError("spatial sharding runs eval forwards only: "
                               "batch_norm in training")
        return _mark(func(*args, **kwargs), axis)

    # -- layout ---------------------------------------------------------

    def _op_cat(self, func, args, kwargs, axis):
        ts = list(args[0])
        if any(_axis_of(t) != axis for t in ts):
            raise NotImplementedError("spatial sharding: cat of a shard "
                                      "with a replicated tensor")
        nd = ts[0].dim()
        if _arg(args, kwargs, 1, "dim", 0) % nd == nd + axis:
            raise NotImplementedError("spatial sharding: cat along the "
                                      "sharded axis")
        return _mark(func(*args, **kwargs), axis)

    _op_concat = _op_concatenate = _op_cat

    def _op_movedim(self, func, args, kwargs, axis):
        x = args[0]
        src, dst = _arg(args, kwargs, 1, "source"), _arg(args, kwargs, 2,
                                                         "destination")
        if not (isinstance(src, int) and isinstance(dst, int)):
            raise NotImplementedError("spatial sharding: movedim of several "
                                      "dims")
        order = list(range(x.dim()))
        order.insert(dst % x.dim(), order.pop(src % x.dim()))
        out = func(*args, **kwargs)
        return _mark(out, order.index(x.dim() + axis) - x.dim())

    _op_moveaxis = _op_movedim


def spatial_sharding(dim=0):
    """A context in which the process group's ranks run one eval forward
    with spatial ``dim`` (0: H of NCHW, D of NCDHW; hebbax's
    ``spatial_dim - 1``) split contiguously over them::

        x_r = shard_spatial(x, dim)             # this rank's rows
        with torch.no_grad(), spatial_sharding(dim):
            y_r = model.eval()(x_r)             # this rank's output rows
        y = gather_spatial(y_r, dim)            # the whole output

    The input's shard length must divide by 16: the port's UNets and
    VNet halve the axis 4 times.  Without a process group it is one
    rank."""
    return SpatialSharding(dim)
