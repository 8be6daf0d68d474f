"""3D UNet (``hebbax/models/unet3d.py`` ``UNet3D``), NCDHW, with the same
module names as hebbax so the parameter map to the flax tree is
mechanical.

Classic 3D U-Net: double conv3-BN-ReLU blocks, maxpool2 downs,
ConvTranspose3d(k=2, s=2) ups with the skip concatenated as ``[up, skip]``,
a 1x1x1 head ``conv``; init_features=64 (a 1024-channel bottleneck) for
``unet3d``, 32 for ``unet3d_min``.  It has 22 Hebbian sites: 18 3x3x3
convs and the 4 transpose convs (the head is the pretraining's exclude).

Every conv is an HConv / HConvTranspose; a HebbSpec passed to the model
makes the non-excluded ones Hebbian.  ``generator`` (CPU) draws the
initial parameters, so a seed gives the same model on every device.  The
other networks of hebbax's 3D zoo (DTC, CCT, URPC, VAE, superpixel, VNet)
are not ported yet (``ROADMAP.md`` item 12b, 12c).
"""

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..hebb.layers import HConv, HConvTranspose, bind_paths
from ..hebb.spec import HebbSpec
from .common import BatchNorm3d, max_pool


class Block3D(nn.Module):
    """conv3-BN-ReLU x2."""

    def __init__(self, in_ch, features, init_type="kaiming", device=None,
                 generator=None):
        super().__init__()
        kw = dict(kernel_size=(3, 3, 3), padding=1, init_type=init_type,
                  device=device, generator=generator)
        self.conv1 = HConv(in_ch, features, **kw)
        self.norm1 = BatchNorm3d(features, device=device)
        self.conv2 = HConv(features, features, **kw)
        self.norm2 = BatchNorm3d(features, device=device)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        return F.relu(self.norm2(self.conv2(x)))


class Encoder3D(nn.Module):
    """encoder1..4 + bottleneck with maxpool2 between; returns the four
    skip features and the bottleneck."""

    def __init__(self, in_channels, features, **kw):
        super().__init__()
        f = features
        chans = (in_channels, f, f * 2, f * 4, f * 8)
        for i in range(4):
            setattr(self, f"encoder{i + 1}",
                    Block3D(chans[i], chans[i + 1], **kw))
        self.bottleneck = Block3D(f * 8, f * 16, **kw)

    def forward(self, x):
        feats = []
        for i in range(4):
            if i:
                x = max_pool(x)
            x = getattr(self, f"encoder{i + 1}")(x)
            feats.append(x)
        return feats, self.bottleneck(max_pool(x))


class Decoder3D(nn.Module):
    """upconvN (transpose k=2 s=2) + concat([up, skip]) + Block3D, 4
    levels, returning the pre-head features."""

    def __init__(self, features, init_type="kaiming", device=None,
                 generator=None):
        super().__init__()
        kw = dict(init_type=init_type, device=device, generator=generator)
        f = features
        for i, ch in zip((4, 3, 2, 1), (f * 8, f * 4, f * 2, f)):
            setattr(self, f"upconv{i}",
                    HConvTranspose(ch * 2, ch, kernel_size=(2, 2, 2),
                                   stride=2, **kw))
            setattr(self, f"decoder{i}", Block3D(ch * 2, ch, **kw))

    def forward(self, bottleneck, feats):
        x = bottleneck
        for i in (4, 3, 2, 1):
            x = getattr(self, f"upconv{i}")(x)
            x = torch.cat([x, feats[i - 1]], dim=1)
            x = getattr(self, f"decoder{i}")(x)
        return x


class UNet3D(nn.Module):
    """Plain 3D U-Net with the 1x1x1 head ``conv``."""

    def __init__(self, in_channels: int, n_cls: int,
                 init_features: int = 64, hebb: Optional[HebbSpec] = None,
                 init_type: str = "kaiming", device=None, generator=None,
                 dropout_generator=None):
        super().__init__()
        del dropout_generator           # no dropout in this network
        kw = dict(init_type=init_type, device=device, generator=generator)
        self.encoder = Encoder3D(in_channels, init_features, **kw)
        self.decoder = Decoder3D(init_features, **kw)
        self.conv = HConv(init_features, n_cls, kernel_size=(1, 1, 1), **kw)
        self.hebb = hebb
        bind_paths(self, hebb)

    def forward(self, x):
        feats, bottleneck = self.encoder(x)
        return self.conv(self.decoder(bottleneck, feats))
