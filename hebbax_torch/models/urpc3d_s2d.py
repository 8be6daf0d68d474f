"""The space-to-depth folded 3D URPC network ``unet3d_urpc_s2d``
(``hebbax/models/urpc3d_s2d.py``), NCDHW.

The same math, parameter tree and snapshots as :mod:`.urpc3d`; its top two
levels (16 channels at full and 32 at half resolution: conv1, conv2,
up_concat2, up_concat1 and the heads dsv1, dsv2) run on tensors folded
at ``FOLD`` = (2, 2, 2) (:mod:`..ops.s2d3d`).  The trilinear upsampling
runs on the unfolded tensor and is folded for the concat, the 2x2x2 max
pool of a folded level returns the unfolded half-resolution tensor, and
the instance norm and the channel dropout act per ORIGINAL channel.
Modules are built in the unfolded twin's order, and the folded dropouts
draw the twin's (N, C) keep masks.
"""

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..hebb.layers import FoldedHConv3, HConv, bind_paths, set_compute_dtype
from ..hebb.spec import HebbSpec
from ..ops import s2d3d
from ..parallel import draw_rows
from ..utils.remat import stash
from .common import (Dropout3d, max_pool, resize_linear_align_corners)
from .urpc3d import FILTERS, UP_DROPOUT, UnetConv3, UnetUp3CT

FOLD = (2, 2, 2)
PF = 8


def folded_instance_norm(x, pf, eps=1e-5):
    """:func:`~.common.instance_norm` per ORIGINAL channel of a folded
    tensor: per-sample statistics over the voxels and the ``pf`` subpixel
    blocks (a bfloat16 input's reduced in float32 and rounded, as the
    unfolded one's)."""
    n, sp = x.shape[0], tuple(x.shape[2:])
    xg = x.reshape((n, pf, x.shape[1] // pf) + sp)
    dims = (1,) + tuple(range(3, xg.dim()))
    var, mean = torch.var_mean(
        xg.to(torch.promote_types(x.dtype, torch.float32)), dim=dims,
        unbiased=False, keepdim=True)
    mean, var = mean.to(x.dtype), var.to(x.dtype)
    return ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)


class FoldedDropout3d(Dropout3d):
    """:class:`~.common.Dropout3d` on a folded tensor: one keep bit per
    (sample, ORIGINAL channel), shared by its ``pf`` subpixel blocks,
    drawn in the unfolded network's (N, C) shape."""

    def __init__(self, p: float, generator=None, pf: int = PF):
        super().__init__(p, generator)
        self.pf = pf

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        n, sp = x.shape[0], tuple(x.shape[2:])
        c = x.shape[1] // self.pf
        keep = stash(lambda: draw_rows(lambda shape: torch.empty(
            shape, dtype=x.dtype, device=x.device).bernoulli_(
            1.0 - self.p, generator=self.generator),
            (n, c) + (1,) * len(sp)))
        xg = x.reshape((n, self.pf, c) + sp)
        return (xg * keep.unsqueeze(1) * (1.0 / (1.0 - self.p))).reshape(
            x.shape)


class FoldedUnetConv3(nn.Module):
    """:class:`~.urpc3d.UnetConv3` on folded tensors; the same
    parameters (conv1 / conv2)."""

    def __init__(self, in_groups, features, init_type="kaiming",
                 device=None, generator=None):
        super().__init__()
        kw = dict(fold=FOLD, init_type=init_type, device=device,
                  generator=generator)
        self.conv1 = FoldedHConv3(in_groups, features, 3, **kw)
        self.conv2 = FoldedHConv3((features,), features, 3, **kw)

    def forward(self, x):
        x = F.relu(folded_instance_norm(self.conv1(x), PF))
        return F.relu(folded_instance_norm(self.conv2(x), PF))


class FoldedUnetUp3CT(nn.Module):
    """:class:`~.urpc3d.UnetUp3CT` whose conv runs folded: ``x`` arrives
    unfolded (or is unfolded here, ``x_folded``), is upsampled unfolded
    and folded for the concat ``[skip, up]`` with the FOLDED skip."""

    def __init__(self, skip_ch, x_ch, features, x_folded,
                 init_type="kaiming", device=None, generator=None):
        super().__init__()
        self.x_folded = x_folded
        self.conv = FoldedUnetConv3((skip_ch, x_ch), features,
                                    init_type=init_type, device=device,
                                    generator=generator)

    def forward(self, skip_f, x):
        if self.x_folded:
            x = s2d3d.unfold3(x, FOLD)
        out_spatial = tuple(2 * s for s in skip_f.shape[2:])
        x = s2d3d.fold3(resize_linear_align_corners(x, out_spatial), FOLD)
        return self.conv(torch.cat([skip_f, x], dim=1))


class UNet3DURPCS2D(nn.Module):
    """``unet3d_urpc_s2d``: returns (dsv1, dsv2, dsv3, dsv4),
    full-resolution logits, finest first."""

    def __init__(self, in_channels: int, n_cls: int,
                 hebb: Optional[HebbSpec] = None, init_type: str = "kaiming",
                 device=None, generator=None, dropout_generator=None,
                 dtype=None):
        super().__init__()
        kw = dict(init_type=init_type, device=device, generator=generator)
        f = FILTERS
        self.conv1 = FoldedUnetConv3((in_channels,), f[0], **kw)
        self.conv2 = FoldedUnetConv3((f[0],), f[1], **kw)
        self.conv3 = UnetConv3(f[1], f[2], **kw)
        self.conv4 = UnetConv3(f[2], f[3], **kw)
        self.center = UnetConv3(f[3], f[4], **kw)
        for i in range(4):
            if i < 2:
                up = FoldedUnetUp3CT(f[i], f[i + 1], f[i], i == 0, **kw)
                drop = FoldedDropout3d(UP_DROPOUT[i], dropout_generator)
                head = FoldedHConv3((f[i],), n_cls, 1, FOLD, **kw)
            else:
                up = UnetUp3CT(f[i + 1], f[i], **kw)
                drop = Dropout3d(UP_DROPOUT[i], dropout_generator)
                head = HConv(f[i], n_cls, kernel_size=(1, 1, 1), **kw)
            setattr(self, f"up_concat{i + 1}", up)
            setattr(self, f"dropout{i + 1}", drop)
            setattr(self, f"dsv{i + 1}", head)
        self.hebb = hebb
        bind_paths(self, hebb)
        set_compute_dtype(self, dtype)

    def forward(self, x):
        shape = x.shape[2:]
        x1f = self.conv1(s2d3d.fold3(x, FOLD))
        x2f = self.conv2(s2d3d.fold3(s2d3d.subpixel_max3(x1f, FOLD), FOLD))
        x3 = self.conv3(s2d3d.subpixel_max3(x2f, FOLD))
        x4 = self.conv4(max_pool(x3))
        up = self.center(max_pool(x4))
        feats = [x1f, x2f, x3, x4]
        outs = []
        for i in (4, 3, 2, 1):
            up = getattr(self, f"up_concat{i}")(feats[i - 1], up)
            up = getattr(self, f"dropout{i}")(up)
            out = getattr(self, f"dsv{i}")(up)
            if i <= 2:
                out = s2d3d.unfold3(out, FOLD)
            outs.append(resize_linear_align_corners(out, shape))
        dsv4, dsv3, dsv2, dsv1 = outs
        return dsv1, dsv2, dsv3, dsv4
