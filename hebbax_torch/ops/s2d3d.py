"""Space-to-depth folding for 3D convolutions, with per-axis factors
(``hebbax/ops/s2d3d.py``), channels-first.

A folded tensor holds each ``prod(f)`` block of voxels in its channels:
(N, C, D, H, W) -> (N, prod(f)·C, D/fz, H/fy, W/fx), channel index
``((dz, dy, dx) subpixel-major) * C + c`` on dim 1, hebbax's order after
an NDHWC <-> NCDHW transpose.  A stride-1 conv on the original tensor is
a stride-1 conv on the folded one with a structured block kernel
(:func:`fold_conv_kernel3`); a k=5 axis at f=2 folds to a TRIMMED 3-tap
window (:func:`folded_k`).  A concat of folded tensors keeps per-source
subpixel blocks (``in_groups``); :func:`regroup3` makes it standard.

The folded kernels are gathers from the original weight through a
constant index map (a slot either holds one weight or the zero appended
after them), not float products: no TF32 or bf16 rounding reaches them.
Their backward is :func:`unfold_wgrad3`'s map, a gather through the
inverse index and a sum over each weight's slots: deterministic, and no
scatter piles the empty slots onto one address.  Weights are torch's:
a conv's ``(O, I, *k)``, a transpose conv's ``(I, O, *k)``.
"""

import functools
import math

import numpy as np
import torch

from ..utils import trace
from .s2d3d_kernels import SUBPIXEL_MAX3


def prodf(f):
    fz, fy, fx = f
    return fz * fy * fx


def fold_nd(x, f):
    """(N, C, *s) -> (N, prod(f)·C, *s/f), any spatial rank, channel
    order (subpixel-major over the axes in order, then c)."""
    n, c = x.shape[:2]
    sp = tuple(x.shape[2:])
    nd = len(sp)
    if any(s % a for s, a in zip(sp, f)):
        raise ValueError(f"space-to-depth fold {tuple(f)} needs divisible "
                         f"spatial dims, got {sp}")
    shape = [n, c]
    for s, a in zip(sp, f):
        shape += [s // a, a]
    x = x.reshape(shape)
    perm = ([0] + [3 + 2 * d for d in range(nd)] + [1]
            + [2 + 2 * d for d in range(nd)])
    return x.permute(perm).reshape(
        (n, math.prod(f) * c) + tuple(s // a for s, a in zip(sp, f)))


def unfold_nd(x, f):
    """Inverse of :func:`fold_nd`."""
    n, cf = x.shape[:2]
    sp = tuple(x.shape[2:])
    nd = len(sp)
    c = cf // math.prod(f)
    x = x.reshape((n,) + tuple(f) + (c,) + sp)
    perm = [0, 1 + nd]
    for d in range(nd):
        perm += [2 + nd + d, 1 + d]
    return x.permute(perm).reshape(
        (n, c) + tuple(s * a for s, a in zip(sp, f)))


def fold3(x, f):
    """(N, C, D, H, W) -> (N, prod(f)·C, D/fz, H/fy, W/fx)."""
    with trace.span("hx.fold"):
        return fold_nd(x, f)


def unfold3(x, f):
    """Inverse of :func:`fold3`."""
    with trace.span("hx.fold"):
        return unfold_nd(x, f)


def folded_k(k: int, f: int) -> int:
    """Folded tap count of a k-tap axis at factor f: the TRIMMED
    symmetric window 2*ceil((k//2)/f) + 1 (k=5, f=2 -> 3 taps)."""
    if f == 1:
        return k
    half = k // 2
    return 2 * (-(-half // f)) + 1


def _axis_taps(k, f):
    """t[T, d, e]: the original tap feeding folded tap T between input
    subpixel d and output subpixel e of one axis, or -1 (hebbax's
    ``_axis_selector``, as an index)."""
    kf = folded_k(k, f)
    t = np.full((kf, f, f), -1, np.int64)
    half, fhalf = k // 2, kf // 2
    for e in range(f):
        for tap in range(k):
            big_t, d = divmod(e + tap - half, f)
            t[big_t + fhalf, d, e] = tap
    return t


@functools.lru_cache(maxsize=None)
def _fold_index(ks, ci, co, in_groups, f):
    """The flat index into ``w.reshape(-1)`` (an ``(co, ci, *ks)``
    weight) of every slot of the folded ``(pf·co, pf·ci, *kf)`` kernel;
    ``co * ci * prod(ks)`` (the appended zero) where the slot is empty."""
    nd = len(ks)
    pf = math.prod(f)
    taps = [_axis_taps(k, a) for k, a in zip(ks, f)]
    kfs = tuple(t.shape[0] for t in taps)
    zero = co * ci * math.prod(ks)
    idx = np.full((pf * co, pf * ci) + kfs, zero, np.int64)
    subs = list(np.ndindex(*f))
    kstride = [math.prod(ks[d + 1:]) for d in range(nd)]
    rows = np.arange(co)
    for ei, e in enumerate(subs):
        for di, dsub in enumerate(subs):
            for tf in np.ndindex(*kfs):
                orig = [taps[a][tf[a], dsub[a], e[a]] for a in range(nd)]
                if min(orig) < 0:
                    continue
                tap = sum(o * s for o, s in zip(orig, kstride))
                view = idx[(slice(None), slice(None)) + tf]
                off = 0
                for g in in_groups:
                    cols = np.arange(g)
                    view[np.ix_(ei * co + rows, pf * off + di * g + cols)] = (
                        (rows[:, None] * ci + off + cols[None, :])
                        * math.prod(ks) + tap)
                    off += g
    return idx


@functools.lru_cache(maxsize=None)
def _unfold_index(ks, ci, co, in_groups, f):
    """The adjoint's map: for every original weight (flat, ``(co, ci,
    *ks)`` order) the flat positions of its slots in the folded kernel,
    padded with the position one past the end (a zero appended to the
    folded gradient)."""
    flat = _fold_index(ks, ci, co, in_groups, f).reshape(-1)
    n = co * ci * math.prod(ks)
    pos = np.nonzero(flat != n)[0]
    src = flat[pos]
    counts = np.bincount(src, minlength=n)
    order = np.argsort(src, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    src_sorted = src[order]
    inv = np.full((n, max(1, int(counts.max()))), flat.size, np.int64)
    inv[src_sorted, np.arange(len(src_sorted)) - starts[src_sorted]] = \
        pos[order]
    return inv


_INDEX_ON = {}


def _index_on(kind, ks, ci, co, in_groups, f, device):
    """``_fold_index`` (kind "fold") or ``_unfold_index`` ("unfold") as a
    tensor on ``device``, made once."""
    key = (kind, ks, ci, co, in_groups, f, str(device))
    if key not in _INDEX_ON:
        make = _fold_index if kind == "fold" else _unfold_index
        _INDEX_ON[key] = torch.from_numpy(
            make(ks, ci, co, in_groups, f)).to(device)
    return _INDEX_ON[key]


def _gather(t, index):
    """``t`` flattened with a zero appended, gathered at ``index``."""
    return torch.cat([t.reshape(-1), t.new_zeros(1)])[index]


class _FoldKernel(torch.autograd.Function):
    """The folded kernel as a gather; its backward sums each weight's
    slots through the inverse map, in a fixed order (a gather and a sum,
    no atomics: deterministic, and no scatter onto the shared empty
    slot)."""

    @staticmethod
    def forward(ctx, w, fold_index, unfold_index):
        ctx.save_for_backward(unfold_index)
        ctx.shape = w.shape
        return _gather(w, fold_index)

    @staticmethod
    def backward(ctx, g):
        (unfold_index,) = ctx.saved_tensors
        return (_gather(g, unfold_index).sum(-1).reshape(ctx.shape), None,
                None)


def fold_conv_kernel_nd(w, in_groups, f):
    """The folded kernel of an ``(O, I, *k)`` stride-1 conv weight at
    per-axis factors ``f``: ``(pf·O, pf·I, *folded_k)``, the output
    channels subpixel-major, the input channels per source group."""
    co, ci = w.shape[:2]
    ks = tuple(int(k) for k in w.shape[2:])
    in_groups = tuple(int(g) for g in in_groups)
    assert sum(in_groups) == ci, (in_groups, ci)
    key = (ks, ci, co, in_groups, tuple(int(a) for a in f), w.device)
    return _FoldKernel.apply(w, _index_on("fold", *key),
                             _index_on("unfold", *key))


def unfold_wgrad_nd(gf, ks, in_groups, co, f, dtype=None):
    """A folded kernel's gradient mapped back to the original
    ``(co, ci, *ks)`` weight: each original tap sums its slots (the
    adjoint of :func:`fold_conv_kernel_nd`)."""
    ks = tuple(int(k) for k in ks)
    in_groups = tuple(int(g) for g in in_groups)
    ci = sum(in_groups)
    index = _index_on("unfold", ks, ci, co, in_groups,
                      tuple(int(a) for a in f), gf.device)
    out = _gather(gf, index).sum(-1).reshape((co, ci) + ks)
    return out.to(dtype) if dtype else out


def folded_kernel_shape3(k, in_groups, co, f):
    p = prodf(f)
    return (p * co, p * sum(in_groups)) + tuple(folded_k(k, a) for a in f)


def fold_conv_kernel3(w, in_groups, f):
    """The folded kernel of an original ``(Co, Ci, k, k, k)`` weight;
    ``in_groups`` the original channel counts of the folded input's
    concatenated sources (sum == Ci)."""
    return fold_conv_kernel_nd(w, in_groups, f)


def unfold_wgrad3(gf, k, in_groups, co, f, dtype=None):
    """A folded 3D kernel's gradient mapped back to the original
    kernel."""
    return unfold_wgrad_nd(gf, (k, k, k), in_groups, co, f, dtype)


def fold_bias3(b, f):
    """Per-Co bias -> the folded prod(f)·Co bias (subpixel-major)."""
    return b.repeat(prodf(f))


def transpose_kernel_matrix(w, f):
    """A k=2/s=2 transpose conv emitting a FOLDED output at the full
    fold f == k: the ``(Ci, prod(f)·Co)`` matrix of the equivalent 1x1x1
    transpose conv, y_folded[((ez, ey, ex), o)] = x @ w[:, o, ez, ey, ex]."""
    ci, co = w.shape[:2]
    assert tuple(w.shape[2:]) == tuple(f), (tuple(w.shape[2:]), f)
    return w.permute(0, 2, 3, 4, 1).reshape(ci, prodf(f) * co)


def fold_transpose_kernel3(w, f):
    """A k=2/s=2 transpose conv ``(I, O, 2, 2, 2)`` whose output is
    folded on the f == 2 axes: their taps absorb into output channel
    blocks (kernel and stride 1 there), the f == 1 axes keep k=2/s=2.
    Returns (w', strides') for ``conv_transpose3d``, w' ``(I,
    prod(f)·O, *k')``, the output channels in fold3's order."""
    ci, co = w.shape[:2]
    assert tuple(w.shape[2:]) == (2, 2, 2), tuple(w.shape[2:])
    absorbed = [2 + a for a in range(3) if f[a] == 2]
    kept = [2 + a for a in range(3) if f[a] == 1]
    wt = w.permute([0] + absorbed + [1] + kept)
    kshape = tuple(1 if f[a] == 2 else 2 for a in range(3))
    return wt.reshape((ci, prodf(f) * co) + kshape), kshape


def folded_pad3(k, f):
    """The conv padding of the TRIMMED folded kernel: folded_k // 2 per
    axis (k=5, f=2 -> 1; f=1 -> k//2)."""
    return tuple(folded_k(k, a) // 2 for a in f)


def fold_down_kernel3(w, f):
    """A k=2/s=2 conv ``(O, I, 2, 2, 2)`` CONSUMING a folded input: on
    the f == 2 axes both taps lie inside one folded voxel and become
    input subpixel blocks (kernel and stride 1), the f == 1 axes keep
    k=2/s=2.  Returns (w', strides') for ``conv3d`` on the folded input;
    the output is unfolded (it lives at the strided resolution)."""
    co, ci = w.shape[:2]
    assert tuple(w.shape[2:]) == (2, 2, 2), tuple(w.shape[2:])
    # only fold factors 1 and 2 are representable
    assert all(a in (1, 2) for a in f), f
    absorbed = [2 + a for a in range(3) if f[a] == 2]
    kept = [2 + a for a in range(3) if f[a] == 1]
    wt = w.permute([0] + absorbed + [1] + kept)
    kshape = tuple(1 if f[a] == 2 else 2 for a in range(3))
    pf = 2 ** len(absorbed)
    return wt.reshape((co, pf * ci) + kshape), kshape


def group_out_perm(co, out_groups, f):
    """Index array permuting a folded conv's OUTPUT channels from
    standard subpixel-major order (d*Co + c) into grouped-concat order
    ([(d, c in g0) | (d, c in g1) | ...]); applied to the folded kernel
    and bias it makes the conv emit the grouped layout."""
    assert sum(out_groups) == co, (out_groups, co)
    pf = prodf(f)
    perm, c0 = [], 0
    for g in out_groups:
        for d in range(pf):
            for c in range(g):
                perm.append(d * co + c0 + c)
        c0 += g
    return np.asarray(perm, np.int64)


def regroup3(x, groups, f):
    """A grouped folded concat -> STANDARD folded channel order."""
    pf = prodf(f)
    n, sp = x.shape[0], tuple(x.shape[2:])
    parts, off = [], 0
    with trace.span("hx.fold"):
        for g in groups:
            parts.append(x[:, off:off + pf * g].reshape((n, pf, g) + sp))
            off += pf * g
        return torch.cat(parts, dim=2).reshape((n, pf * sum(groups)) + sp)


def ungroup3(x, groups, f):
    """Inverse of :func:`regroup3`: standard folded order -> grouped."""
    pf = prodf(f)
    n, sp = x.shape[0], tuple(x.shape[2:])
    parts, off = [], 0
    with trace.span("hx.fold"):
        xg = x.reshape((n, pf, sum(groups)) + sp)
        for g in groups:
            parts.append(xg[:, :, off:off + g].reshape((n, pf * g) + sp))
            off += g
        return torch.cat(parts, dim=1)


def _window_view(x, f):
    """The unfolded tensor's 2x2x2 pooling windows: (N, C, D/2, H/2,
    W/2, 8), the window's voxels in (z, y, x) row-major order."""
    xu = unfold3(x, f)
    n, c, d, h, w = xu.shape
    ew = xu.reshape(n, c, d // 2, 2, h // 2, 2, w // 2, 2)
    return ew.permute(0, 1, 2, 4, 6, 3, 5, 7).reshape(
        n, c, d // 2, h // 2, w // 2, 8)


def first_max_grad(x, g, f):
    """The plain version of the pool's backward: the folded gradient of
    x with the pooled cotangent g at each window's FIRST maximum in (z,
    y, x) order and zero elsewhere; none in a window holding a NaN."""
    ew = _window_view(x, f)
    m = ew == ew.amax(dim=-1, keepdim=True)
    first = m & (torch.cumsum(m.to(torch.int32), dim=-1) == 1)
    gx = torch.where(first, g.unsqueeze(-1).to(ew.dtype),
                     torch.zeros((), dtype=ew.dtype, device=ew.device))
    n, c, d2, h2, w2 = g.shape
    gx = gx.reshape(n, c, d2, h2, w2, 2, 2, 2).permute(
        0, 1, 2, 5, 3, 6, 4, 7).reshape(n, c, 2 * d2, 2 * h2, 2 * w2)
    return fold3(gx, f)


class _SubpixelMax3(torch.autograd.Function):
    """Forward: the max over each 2x2x2 window of the unfolded tensor,
    taken on the folded one.  Backward: the cotangent goes to the FIRST
    maximum of its window in (z, y, x) order (lax.reduce_window's
    select-and-scatter, the unfolded network's max pool), never split
    among ties: on a CUDA tensor one launch of ``csrc/subpixel_max3.cu``
    (:data:`~.s2d3d_kernels.SUBPIXEL_MAX3`), on any other
    :func:`first_max_grad`."""

    @staticmethod
    def forward(ctx, x, f):
        ctx.f = f
        ctx.save_for_backward(x)
        n, cf = x.shape[:2]
        fz, fy, fx = f
        c = cf // prodf(f)
        p, q, r = x.shape[2:]
        y = torch.amax(x.reshape(n, prodf(f), c, p, q, r), dim=1)
        if fz == 1:
            y = torch.amax(y.reshape(n, c, p // 2, 2, q, r), dim=3)
            p //= 2
        if fy == 1:
            y = torch.amax(y.reshape(n, c, p, q // 2, 2, r), dim=4)
            q //= 2
        if fx == 1:
            y = torch.amax(y.reshape(n, c, p, q, r // 2, 2), dim=5)
        return y

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        if x.is_cuda:
            return SUBPIXEL_MAX3(x, g, ctx.f), None
        return first_max_grad(x, g, ctx.f), None


def subpixel_max3(x, f):
    """The 2x2x2/stride-2 max pool of the ORIGINAL tensor computed on
    the folded one; the result is the UNFOLDED half-resolution tensor.
    Axes with f == 2 reduce over their subpixel blocks, axes with f == 1
    over adjacent pairs.  Its gradient goes to the first maximum of each
    window (:class:`_SubpixelMax3`), as the unfolded network's pool's
    does: post-ReLU zero ties are common."""
    with trace.span("hx.fold"):
        return _SubpixelMax3.apply(x, tuple(int(a) for a in f))


__all__ = ["fold3", "unfold3", "folded_k", "fold_conv_kernel3",
           "unfold_wgrad3", "fold_bias3", "subpixel_max3", "first_max_grad",
           "prodf", "folded_kernel_shape3", "transpose_kernel_matrix",
           "fold_transpose_kernel3", "folded_pad3", "fold_down_kernel3",
           "group_out_perm", "regroup3", "ungroup3", "fold_nd",
           "unfold_nd", "fold_conv_kernel_nd", "unfold_wgrad_nd"]
