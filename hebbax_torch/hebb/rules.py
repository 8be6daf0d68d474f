"""Hebbian plasticity rules (``hebbax/hebb/rules.py``), the part the 2D
main path needs: weight normalisation and the swta rule on a stride-1
forward conv.

Conventions: NCHW activations, conv weights ``(O, I, kh, kw)``, ``x`` the
UNPADDED layer input and ``y`` the conv output including its bias;
``padding`` is the conv's symmetric (ph, pw).

  swta : r = softmax(k*y) over O;  dw = <r, x_patches> - (sum r) * w

:func:`swta_conv_delta` is the plain version of the CUDA kernel
``csrc/swta_delta.cu``: softmax, then one (O, I) contraction over the
pixels per kernel tap on shifted slices of the padded input — matmuls, no
cuDNN.  The other modes (hpca, swta_t / hpca_t on transpose convs,
contrastive) and 3D raise ``NotImplementedError`` until their slice is
ported.
"""

import torch
import torch.nn.functional as F


def normalize(x, dims):
    """L2-normalize over ``dims`` with a zero-norm guard."""
    nrm = torch.sqrt(torch.sum(x * x, dim=dims, keepdim=True))
    nrm = torch.where(nrm == 0, torch.ones_like(nrm), nrm)
    return x / nrm


# per-filter normalization of an (O, I, kh, kw) forward-conv weight: each
# output filter over (I, kh, kw)
WEIGHT_NORM_DIMS = (1, 2, 3)


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


def compute_delta(spec, w, x, y, padding):
    """Route a 2D stride-1 forward conv's delta to the configured rule:
    swta (swta_t on a forward conv resolves to swta) goes to the
    SWTA-delta dispatcher."""
    if not spec.patchwise:
        raise NotImplementedError(
            "patchwise=False is dead code in the reference (shape-"
            "inconsistent) and is not supported")
    mode = spec.conv_mode(False)
    if mode != "swta":
        raise NotImplementedError(f"Hebbian mode {mode!r} is not ported yet")
    from .kernels import swta_delta
    return swta_delta(w, x, y, spec.k, padding)
