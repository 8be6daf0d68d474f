"""3D URPC network (``hebbax/models/urpc3d.py`` ``UNet3DURPC``), NCDHW,
with the same module names as hebbax so the parameter map to the flax
tree is mechanical.

An attention-free 3D U-Net with deep supervision: channels 16/32/64/128/
256, double conv3-InstanceNorm-ReLU blocks (no batch statistics), maxpool2
downs, trilinear (align_corners) upsampling with the skip concatenated as
``[skip, up]`` (the opposite order to ``Decoder3D``'s), channel dropout
0.5 / 0.3 / 0.2 / 0.1 on the four decode levels, and four 1x1x1
deep-supervision heads ``dsv1..dsv4``, the lower three resized to the
input.  It has 18 Hebbian sites (the 3x3x3 convs; the heads are the
pretraining's exclude).

``generator`` (CPU) draws the initial parameters; ``dropout_generator``
(on the model's device) draws the channel keep masks.
"""

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..hebb.layers import HConv, bind_paths, set_compute_dtype
from ..hebb.spec import HebbSpec
from .common import (Dropout3d, instance_norm, max_pool,
                     resize_linear_align_corners)

FILTERS = (16, 32, 64, 128, 256)
UP_DROPOUT = (0.1, 0.2, 0.3, 0.5)       # up_concat1..4


class UnetConv3(nn.Module):
    """conv3x3x3-InstanceNorm-ReLU x2."""

    def __init__(self, in_ch, features, init_type="kaiming", device=None,
                 generator=None):
        super().__init__()
        kw = dict(kernel_size=(3, 3, 3), padding=1, init_type=init_type,
                  device=device, generator=generator)
        self.conv1 = HConv(in_ch, features, **kw)
        self.conv2 = HConv(features, features, **kw)

    def forward(self, x):
        x = F.relu(instance_norm(self.conv1(x)))
        return F.relu(instance_norm(self.conv2(x)))


class UnetUp3CT(nn.Module):
    """Trilinear (align_corners) upsample to the skip's size, concat
    ``[skip, up]``, UnetConv3."""

    def __init__(self, in_ch, features, **kw):
        super().__init__()
        self.conv = UnetConv3(in_ch + features, features, **kw)

    def forward(self, skip, x):
        x = resize_linear_align_corners(x, skip.shape[2:])
        return self.conv(torch.cat([skip, x], dim=1))


class UNet3DURPC(nn.Module):
    """unet_3D_dv_semi: returns (dsv1, dsv2, dsv3, dsv4), full-resolution
    logits, finest first."""

    def __init__(self, in_channels: int, n_cls: int,
                 hebb: Optional[HebbSpec] = None, init_type: str = "kaiming",
                 device=None, generator=None, dropout_generator=None,
                 dtype=None):
        super().__init__()
        kw = dict(init_type=init_type, device=device, generator=generator)
        f = FILTERS
        chans = (in_channels,) + f[:3]
        for i in range(4):
            setattr(self, f"conv{i + 1}", UnetConv3(chans[i], f[i], **kw))
        self.center = UnetConv3(f[3], f[4], **kw)
        for i in range(4):
            setattr(self, f"up_concat{i + 1}",
                    UnetUp3CT(f[i + 1], f[i], **kw))
            setattr(self, f"dropout{i + 1}",
                    Dropout3d(UP_DROPOUT[i], dropout_generator))
            setattr(self, f"dsv{i + 1}",
                    HConv(f[i], n_cls, kernel_size=(1, 1, 1), **kw))
        self.hebb = hebb
        bind_paths(self, hebb)
        set_compute_dtype(self, dtype)

    def forward(self, x):
        shape = x.shape[2:]
        feats = []
        for i in range(4):
            if i:
                x = max_pool(x)
            x = getattr(self, f"conv{i + 1}")(x)
            feats.append(x)
        up = self.center(max_pool(x))
        outs = []
        for i in (4, 3, 2, 1):
            up = getattr(self, f"up_concat{i}")(feats[i - 1], up)
            up = getattr(self, f"dropout{i}")(up)
            outs.append(resize_linear_align_corners(
                getattr(self, f"dsv{i}")(up), shape))
        dsv4, dsv3, dsv2, dsv1 = outs
        return dsv1, dsv2, dsv3, dsv4
