"""Hebbian plasticity rules (``hebbax/hebb/rules.py``), the part the 2D
and 3D main paths need: weight normalisation, the swta rule on a stride-1
forward conv, and the swta_t rule on a transpose conv.

Conventions: channels-first activations, conv weights ``(O, I, *k)``,
transpose-conv weights ``(I, O, *k)`` (torch's layouts); ``x`` the
UNPADDED layer input and ``y`` the conv output including its bias;
``padding`` is the forward conv's symmetric per-axis padding.

  swta   : r = softmax(k*y) over O;  dw = <r, x_patches> - (sum r) * w
  swta_t : r = softmax(k*y) over the channels of the (larger) output map;
           dw = <r_unfold, x> - (sum_kappa sum r_unfold) * w

:func:`swta_conv_delta` is the plain version of the CUDA kernel
``csrc/swta_delta.cu`` (2D): softmax, then one (O, I) contraction over
the pixels per kernel tap on shifted slices of the padded input —
matmuls, no cuDNN.  The 3D rules are weight-gradient convolutions, as
hebbax composes them in XLA: :func:`swta_conv3d_delta` and
:func:`swta_t_delta`.  The other modes (hpca, hpca_t, swta / hpca on
transpose convs, contrastive) raise ``NotImplementedError``
(``ROADMAP.md`` item 16).
"""

import torch
import torch.nn.functional as F

_CONV_WEIGHT = {2: torch.nn.grad.conv2d_weight,
                3: torch.nn.grad.conv3d_weight}


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

    w (O, I, kh, kw); x (N, I, H, W) unpadded; y (N, O, H, W);
    padding (ph, pw) with H + 2*ph - kh + 1 == y's H (stride 1)."""
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


def swta_conv3d_delta(w, x, y, k, padding):
    """The swta delta of a stride-1 3D forward conv, in float32:
    softmax over the channels, the weight gradient of the conv
    (``torch.nn.grad.conv3d_weight``, cuDNN on the card) with the conv's
    padding, then ``- r_sum * w``.

    w (O, I, *k); x (N, I, *s) unpadded; y (N, O, *s)."""
    r = torch.softmax(k * y.float(), dim=1)
    pos = torch.nn.grad.conv3d_weight(x.float(), w.shape, r,
                                      padding=tuple(padding))
    r_sum = r.sum(dim=(0, 2, 3, 4))                            # (O,)
    return pos - r_sum[:, None, None, None, None] * w.float()


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
    stride = (stride,) * nd if isinstance(stride, int) else tuple(stride)
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


def compute_delta(spec, w, x, y, padding, transpose=False, stride=1):
    """Route a conv's delta to the configured rule: swta on a forward
    conv (swta_t on a forward conv resolves to swta) goes to the
    SWTA-delta dispatcher, which routes by rank; swta_t on a transpose
    conv goes to :func:`swta_t_delta`."""
    if not spec.patchwise:
        raise NotImplementedError(
            "patchwise=False is dead code in the reference (shape-"
            "inconsistent) and is not supported")
    mode = spec.conv_mode(transpose)
    if transpose and mode == "swta_t":
        return swta_t_delta(w, x, y, spec.k, stride)
    if transpose or mode != "swta":
        where = "transpose" if transpose else "forward"
        raise NotImplementedError(
            f"Hebbian mode {mode!r} on a {where} conv is not ported yet "
            f"(ROADMAP.md item 16)")
    from .kernels import swta_delta
    return swta_delta(w, x, y, spec.k, padding)
