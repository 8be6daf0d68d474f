"""Space-to-depth folding of 2D convolutions (``hebbax/ops/s2d.py``),
channels-first.

Folding 2x2 spatial blocks into channels, (N, C, H, W) -> (N, 4C, H/2,
W/2) with channel index ``(dy*2+dx)*C + c`` on dim 1 (hebbax's order
after an NHWC <-> NCHW transpose), turns a 3x3 stride-1 conv into a 3x3
stride-1 conv on the folded tensor with a structured ``(4Co, 4Ci, k, k)``
block kernel that holds the original 9·Ci·Co weights in 36 of its 144
(tap, block) slots: for output subpixel (ey, ex) and original tap
(u, v) in {-1, 0, 1}^2, W'[(ey,ex,o), (dy,dx,i), U+1, V+1] =
W[o, i, u+1, v+1] with U = floor((ey+u)/2), dy = (ey+u) mod 2 (columns
alike).  The 2x2/stride-2 max pool becomes a max over the 4 subpixel
blocks of each folded pixel, and its output is the unfolded
half-resolution tensor.

The folded kernel is a gather from the original weight through a
constant index map (:func:`hebbax_torch.ops.s2d3d.fold_conv_kernel_nd`),
so every slot holds one weight or 0 exactly; its backward is
:func:`unfold_wgrad`'s map.  Used by ``models/unet2d_s2d.py`` and
``hebb/layers.py`` ``FoldedHConv``.
"""

import torch

from .s2d3d import fold_conv_kernel_nd, fold_nd, unfold_nd, unfold_wgrad_nd

F2 = (2, 2)


def fold(x):
    """(N, C, H, W) -> (N, 4C, H/2, W/2), channel order (dy*2+dx)*C + c."""
    h, w = x.shape[2:]
    if h % 2 or w % 2:
        raise ValueError(
            f"space-to-depth folding needs even spatial dims, got "
            f"{(h, w)}; the s2d model variants (unet_s2d / unet_urpc_s2d "
            f"/ unet_cct_s2d) require H, W % 4 == 0 — use the unfolded "
            f"network for odd-sized inputs")
    return fold_nd(x, F2)


def unfold(x):
    """Inverse of :func:`fold`."""
    return unfold_nd(x, F2)


def folded_kernel_shape(k, in_groups, co):
    return (4 * co, 4 * sum(in_groups), k, k)


def fold_conv_kernel(w, in_groups):
    """The folded ``(4Co, 4Ci, k, k)`` kernel of an original ``(Co, Ci,
    k, k)`` weight (k in {1, 3}); ``in_groups`` the original channel
    counts of the folded input's concatenated sources (a folded concat
    keeps each source's 4 subpixel blocks contiguous), sum == Ci."""
    return fold_conv_kernel_nd(w, in_groups, F2)


def unfold_wgrad(gf, k, in_groups, co, dtype=None):
    """A folded kernel's gradient mapped back to the original kernel:
    each original tap (o, i, u, v) sums its 4 subpixel slots."""
    return unfold_wgrad_nd(gf, (k, k), in_groups, co, F2, dtype)


def fold_bias(b):
    """Per-Co bias -> the folded 4Co bias ((ey, ex) major)."""
    return b.repeat(4)


def subpixel_max(x):
    """The 2x2/stride-2 max pool of the original tensor computed on the
    folded one; the result is the UNFOLDED half-resolution tensor.  Its
    gradient splits evenly among tied maxima, as hebbax's ``jnp.max``
    does (``torch.amax``)."""
    n, c4, p, q = x.shape
    return torch.amax(x.reshape(n, 4, c4 // 4, p, q), dim=1)


def per_subpixel(fn, x, co=None):
    """``fn`` over the original channels of each subpixel block of a
    folded tensor (a softmax over classes, say): ``fn`` sees an (N*4,
    co, P, Q) tensor, its original channels on dim 1."""
    n, c4, p, q = x.shape
    c = c4 // 4 if co is None else co
    return fn(x.reshape(n * 4, c, p, q)).reshape(n, 4 * c, p, q)


def fold_resize_linear_align_corners(x, out_spatial):
    """``resize_linear_align_corners`` of an UNFOLDED input, returned
    folded."""
    from ..models.common import resize_linear_align_corners
    return fold(resize_linear_align_corners(x, out_spatial))


__all__ = ["fold", "unfold", "fold_conv_kernel", "unfold_wgrad",
           "fold_bias", "subpixel_max", "per_subpixel",
           "folded_kernel_shape", "fold_resize_linear_align_corners"]
