"""Hebbian plasticity rules (``hebbax/hebb/rules.py``): weight
normalisation and every rule hebbax serves, 2D and 3D, forward and
transpose convs.

Conventions: channels-first activations, conv weights ``(O, I, *k)``,
transpose-conv weights ``(I, O, *k)`` (torch's layouts); ``x`` the
UNPADDED layer input and ``y`` the conv output including its bias;
``padding`` is the forward conv's symmetric per-axis padding, ``stride``
its per-axis stride (an int for all axes).  Every delta is float32.

  swta   : r = softmax(k*y) over O;  dw = <r, x_patches> - (sum r) * w
  hpca   : Sanger's rule;            dw = <y, x_patches> - tril(y^T y) @ w
  swta_t : r = softmax(k*y) over the channels of the (larger) output map
           of a transpose conv; dw = <r_unfold, x> - (sum_kappa sum
           r_unfold) * w
  hpca_t : Sanger over the transpose conv's unfolded output, with one
           output Gram per kernel offset
  contrastive: the gradient of a local neighbourhood objective
           (:func:`contrastive_delta`)

swta and hpca on a transpose conv run the forward-conv rule with x and y
swapped.  hebbax swaps its kernel's I/O axes for that; in torch's layouts
no swap is needed, since a transpose conv's ``(I, O, *k)`` weight already
is the ``(out, in, *k)`` weight of the forward conv from y (O channels) to
x (I channels), with the same stride and no padding.

:func:`swta_conv_delta` is the plain version of the CUDA kernel
``csrc/swta_delta.cu`` (2D, stride 1): softmax, then one (O, I)
contraction over the pixels per kernel tap on shifted slices of the
padded input — matmuls, no cuDNN.  The other rules are weight-gradient
convolutions (``torch.nn.grad.conv{2,3}d_weight``), Gram matmuls and, for
contrastive, ``torch.autograd.grad``, as hebbax composes them in XLA.
Only ``patchwise=False`` raises (dead code in the reference).
"""

import itertools

import torch
import torch.nn.functional as F

_CONV_WEIGHT = {2: torch.nn.grad.conv2d_weight,
                3: torch.nn.grad.conv3d_weight}
_CONV = {2: F.conv2d, 3: F.conv3d}
_CONV_TRANSPOSE = {2: F.conv_transpose2d, 3: F.conv_transpose3d}
HPCA_T_CHUNK_3D = 32    # hebb3d's PARALLEL_CHANNELS: the 3D hpca_t tril


def _tuple(v, nd):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * nd


def normalize(x, dims):
    """L2-normalize over ``dims`` with a zero-norm guard."""
    nrm = torch.sqrt(torch.sum(x * x, dim=dims, keepdim=True))
    nrm = torch.where(nrm == 0, torch.ones_like(nrm), nrm)
    return x / nrm


def weight_norm_dims(nd):
    """The dims :func:`normalize` takes for an ``nd``-D weight: every dim
    but the first.  That is per output filter over (I, *k) for a
    forward-conv weight ``(O, I, *k)``, and per INPUT channel over
    (O, *k) for a transpose-conv weight ``(I, O, *k)``, as the reference's
    transpose layers normalize their torch weight (hebbax's
    ``weight_norm_axes``)."""
    return tuple(range(1, nd + 2))


def swta_conv_delta(w, x, y, k, padding):
    """dw = <softmax(k y), x_patches> - (sum softmax) * w, in float32.

    w (O, I, kh, kw); x (N, I, H, W) unpadded; y (N, O, H', W') with
    H' = H + 2*ph - kh + 1 (stride 1)."""
    o, i, kh, kw = w.shape
    n, _, h, wd = y.shape
    ph, pw = padding
    r = torch.softmax(k * y.float(), dim=1)
    xp = F.pad(x.float(), (pw, pw, ph, ph))
    rf = r.permute(1, 0, 2, 3).reshape(o, -1)                 # (O, P)
    pos = torch.empty((o, i, kh, kw), dtype=torch.float32, device=w.device)
    for di in range(kh):
        for dj in range(kw):
            xs = xp[:, :, di:di + h, dj:dj + wd]
            pos[:, :, di, dj] = rf @ xs.permute(0, 2, 3, 1).reshape(-1, i)
    r_sum = r.sum(dim=(0, 2, 3))                               # (O,)
    return pos - r_sum[:, None, None, None] * w.float()


def swta_wgrad_delta(w, x, y, k, padding, stride=1):
    """The swta delta of a forward conv of any rank and stride, composed
    as hebbax's ``swta_conv_delta``: softmax over the channels, the
    weight gradient of the conv (``torch.nn.grad.conv{2,3}d_weight``,
    cuDNN on the card) with its stride and padding, then ``- r_sum * w``.

    w (O, I, *k); x (N, I, *s) unpadded; y (N, O, *s') the conv output."""
    nd = x.dim() - 2
    r = torch.softmax(k * y.float(), dim=1)
    pos = _CONV_WEIGHT[nd](x.float(), w.shape, r, stride=_tuple(stride, nd),
                           padding=_tuple(padding, nd))
    r_sum = r.sum(dim=(0,) + tuple(range(2, nd + 2)))          # (O,)
    return pos - r_sum.view((-1,) + (1,) * (nd + 1)) * w.float()


def _gram(y):
    """sum over the batch and the voxels of y y^T: (C, C), float32."""
    yf = y.float().transpose(0, 1).reshape(y.shape[1], -1)
    return yf @ yf.T


def sanger_tril(o, device=None, chunk=None):
    """Lower-triangular (diagonal included) lateral-competition mask
    (hebbax's ``_sanger_tril``).  ``chunk`` makes it block-diagonal: the
    reference's 3D transpose layer builds its tril over local indices of
    32-channel chunks of the output axis, so the ordering resets every
    ``chunk`` channels."""
    tril = torch.tril(torch.ones((o, o), dtype=torch.float32,
                                 device=device))
    if chunk:
        idx = torch.arange(o, device=device) // chunk
        tril = tril * (idx[:, None] == idx[None, :]).float()
    return tril


def hpca_conv_delta(w, x, y, padding, stride=1, chunk=None):
    """Sanger's rule on a forward conv, in float32:
    dw = <y, x_patches> - (tril ⊙ y^T y) @ w, ``pos`` the weight gradient
    of the conv against y and the decay the (O, O) output Gram masked by
    :func:`sanger_tril` times the flattened weight."""
    nd = x.dim() - 2
    o = w.shape[0]
    pos = _CONV_WEIGHT[nd](x.float(), w.shape, y.float(),
                           stride=_tuple(stride, nd),
                           padding=_tuple(padding, nd))
    m = _gram(y) * sanger_tril(o, w.device, chunk)
    dec = (m @ w.float().reshape(o, -1)).reshape(w.shape)
    return pos - dec


def swta_t_delta(w, x, y, k_temp, stride):
    """Transpose-conv swta (``hebbax`` ``swta_t_delta``), in float32.

    w (I, O, *k); x (N, I, *q) the layer input; y (N, O, *p) its output
    with p = (q - 1) * s + k (no padding).  Patch q of the output's
    (k, s) unfold lines up with input pixel q, so

      pos[i, o, kappa]  = sum_{n,q} x[n, i, q] r[n, o, s q + kappa]
      r_sum[o, kappa]   = sum_{n,q} r[n, o, s q + kappa]
      dec[i, o]         = sum_kappa r_sum[o, kappa] w[i, o, kappa]

    and dw = pos - dec, the decay summed over the kernel offsets and
    broadcast back to every offset (patchwise).  Both unfold sums are the
    weight gradient of a stride-s forward conv over r, against x and
    against an all-ones input."""
    nd = x.dim() - 2
    stride = _tuple(stride, nd)
    conv_weight = _CONV_WEIGHT[nd]
    r = torch.softmax(k_temp * y.float(), dim=1)
    pos = conv_weight(r, w.shape, x.float(), stride=stride)
    ones = torch.ones((x.shape[0], 1) + tuple(x.shape[2:]),
                      dtype=torch.float32, device=x.device)
    r_sum = conv_weight(r, (1,) + tuple(w.shape[1:]), ones,
                        stride=stride)                        # (1, O, *k)
    wf = w.float()
    kdims = tuple(range(2, nd + 2))
    return pos - torch.sum(r_sum * wf, dim=kdims, keepdim=True)


def strided_grams(y, q, k, stride):
    """Per-kernel-offset output Grams (hebbax's ``_strided_patches_m``):
    M[kappa][o, o'] = sum_{n,j} y[n, o, s j + kappa] y[n, o', s j + kappa]
    over the q input positions j, from strided slices of y (no unfold).
    Returns (prod(k), O, O), the offsets in row-major order."""
    nd = y.dim() - 2
    mats = []
    for kappa in itertools.product(*[range(ki) for ki in k]):
        idx = (slice(None), slice(None)) + tuple(
            slice(kappa[d], kappa[d] + stride[d] * q[d], stride[d])
            for d in range(nd))
        mats.append(_gram(y[idx]))
    return torch.stack(mats)


def hpca_t_delta(w, x, y, stride, chunk=None):
    """Transpose-conv Sanger (``hebbax`` ``hpca_t_delta``), in float32:
    ``pos`` as in :func:`swta_t_delta` with y for r, and

      dec[i, o] = sum_kappa sum_{o'} (M_kappa ⊙ tril)[o, o'] w[i, o', kappa]

    broadcast back to every offset; ``chunk`` block-diagonalizes the tril
    (the 3D reference's chunked unfold)."""
    nd = x.dim() - 2
    stride = _tuple(stride, nd)
    k = tuple(w.shape[2:])
    i_ch, o = w.shape[:2]
    pos = _CONV_WEIGHT[nd](y.float(), w.shape, x.float(), stride=stride)
    m = strided_grams(y, tuple(x.shape[2:]), k, stride) * sanger_tril(
        o, w.device, chunk)
    wk = w.float().reshape(i_ch, o, -1).permute(2, 0, 1)        # (K, I, O)
    dec = torch.einsum("kab,kib->ia", m, wk)
    return pos - dec.reshape((i_ch, o) + (1,) * nd)


def neighborhood_sum(y):
    """Sum over the 3^nd neighbourhood of every voxel, zeros outside (SAME
    padding): one shifted three-term sum per spatial axis."""
    for axis in range(2, y.dim()):
        size = y.shape[axis]
        pad = [0, 0] * (y.dim() - 2)      # F.pad lists the last dim first
        j = 2 * (y.dim() - 1 - axis)
        pad[j] = pad[j + 1] = 1
        yp = F.pad(y, pad)
        y = (yp.narrow(axis, 0, size) + yp.narrow(axis, 1, size)
             + yp.narrow(axis, 2, size))
    return y


def contrastive_delta(w, x, perm, stride, padding, transpose, w_nrm,
                      contrast=1.0, uniformity=False, bias=None):
    """+grad over w of the local objective (``hebbax``
    ``contrastive_delta``)

      sum[-nbr(y) . y + contrast * nbr(y)[perm] . y],

    with y = fwd(x, normalize(w)) + bias L2-normalized over the channels,
    nbr the 3^nd neighbourhood sum and ``perm`` a permutation of the
    batch.  The sign is the reference's: its delta is this gradient, and
    the update, grad = -delta, ascends the objective.  ``uniformity``
    weights each output voxel by fwd of the input's own neighbourhood
    agreement with an all-ones kernel (no gradient through it).  fwd is
    the layer's conv (stride, padding) or transpose conv (stride).

    Taken with ``torch.autograd.grad`` under ``torch.enable_grad()`` on a
    detached float32 copy of w, so it runs inside ``torch.no_grad()`` and
    leaves no trace in any outer graph."""
    if perm is None:
        raise ValueError("contrastive needs the batch permutation its site "
                         "drew (HConv.draw_permutation)")
    nd = x.dim() - 2
    stride = _tuple(stride, nd)
    if transpose:
        def fwd(inp, wt):
            return _CONV_TRANSPOSE[nd](inp, wt, stride=stride)
    else:
        padding = _tuple(padding, nd)

        def fwd(inp, wt):
            return _CONV[nd](inp, wt, stride=stride, padding=padding)
    x = x.detach().float()
    with torch.enable_grad():
        w_ = w.detach().float().clone().requires_grad_(True)
        w_eff = normalize(w_, weight_norm_dims(nd)) if w_nrm else w_
        y = fwd(x, w_eff)
        if bias is not None:
            y = y + bias.detach().float().view((-1,) + (1,) * nd)
        y = normalize(y, (1,))
        nbr = neighborhood_sum(y)
        obj = (-torch.sum(nbr * y, dim=1)
               + contrast * torch.sum(nbr[perm] * y, dim=1))
        if uniformity:
            with torch.no_grad():
                xn = normalize(x, (1,))
                umap = torch.sum(neighborhood_sum(xn) * xn, dim=1,
                                 keepdim=True)
                ones_k = torch.ones((1, 1) + tuple(w.shape[2:]),
                                    dtype=torch.float32, device=x.device)
                umap = fwd(umap, ones_k)[:, 0]
            obj = obj * umap
        return torch.autograd.grad(obj.sum(), w_)[0]


def compute_delta(spec, w, x, y, padding, transpose=False, stride=1,
                  bias=None, perm=None):
    """Route a conv's delta to the configured rule (``hebbax``
    ``compute_delta``):

    * contrastive -> :func:`contrastive_delta` (``perm``: the batch
      permutation the site drew; ``bias`` the layer's), no padding on a
      transpose conv;
    * swta / hpca on a transpose conv -> the forward-conv rule from y to
      x on the stored weight (stride s, no padding, no chunk);
    * swta on a forward conv (swta_t resolves to it) -> the SWTA-delta
      dispatcher, which routes by rank, stride and shape;
    * hpca on a forward conv -> :func:`hpca_conv_delta`, no chunk;
    * swta_t / hpca_t on a transpose conv -> :func:`swta_t_delta` /
      :func:`hpca_t_delta`, hpca_t with the 32-channel chunk in 3D only.
    """
    if not spec.patchwise:
        raise NotImplementedError(
            "patchwise=False is dead code in the reference (shape-"
            "inconsistent) and is not supported")
    from .kernels import swta_delta

    mode = spec.conv_mode(transpose)
    nd = x.dim() - 2
    if mode == "contrastive":
        return contrastive_delta(w, x, perm, stride,
                                 0 if transpose else padding, transpose,
                                 spec.w_nrm, spec.contrast, spec.uniformity,
                                 bias)
    if transpose and mode == "swta":
        return swta_delta(w, y, x, spec.k, (0,) * nd, stride)
    if transpose and mode == "hpca":
        return hpca_conv_delta(w, y, x, 0, stride)
    if mode == "swta":
        return swta_delta(w, x, y, spec.k, padding, stride)
    if mode == "hpca":
        return hpca_conv_delta(w, x, y, padding, stride)
    if mode == "swta_t":
        return swta_t_delta(w, x, y, spec.k, stride)
    if mode == "hpca_t":
        return hpca_t_delta(w, x, y, stride,
                            chunk=HPCA_T_CHUNK_3D if nd == 3 else None)
    raise NotImplementedError(f"Hebbian mode {mode!r} unavailable")
