"""DDPM networks (``hebbax/models/ddpm.py``), NCHW, flax module names.

What the reference's DDPM_Wrapper runs (every resnet, attention and mid
block of lucidrains' Unet is commented out there):

  init ConvBlockLeaky(in+cls -> 64, p=.05)
  + time embedding (SinusoidalPosEmb(64) -> Linear 256 -> GELU -> Linear
    64) added per channel
  -> 4 down blocks (64 -> 64, 128, 256, 512; dropouts .1/.2/.3/.4)
  -> 4 UpBlocks (bilinear, skip concat; 512->256, 256->128, 128->64,
     64->64)
  -> final 3x3 conv to out_dim.

DDPMUNet holds two such nets, ``net`` (the image stream, pred_noise) and
``net_seg`` (the mask stream, pred_x0), both taking in_channels + n_cls
input channels, plus the 3x3 probe conv ``final_conv`` (n_cls -> n_cls).

flax's ``nn.gelu`` is the tanh approximation, and its ``nn.Dense`` kernels
initialise lecun-normal (a normal truncated at 2 standard deviations,
fan_in) with zero bias; the port's ``nn.Linear`` layers do the same.
"""

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..hebb.layers import HConv, bind_paths, set_compute_dtype
from ..hebb.spec import HebbSpec
from .common import lecun_normal_, max_pool
from .unet2d import ConvBlockLeaky, UpBlock2D

DIMS = (64, 64, 128, 256, 512)
DROPOUT = (0.05, 0.1, 0.2, 0.3, 0.4, 0.5)
def sinusoidal_pos_emb(t, dim, theta=10000.0):
    """[sin, cos] of t * exp(-log(theta) * i / (half - 1)), i < dim // 2."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * (-math.log(theta) / (half - 1)))
    args = t.to(torch.float32)[:, None] * freqs[None]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def dense(in_features, out_features, device=None, generator=None):
    """``nn.Linear`` initialised like flax's ``nn.Dense``: lecun-normal
    weight drawn on the CPU from ``generator``, zero bias."""
    layer = nn.Linear(in_features, out_features, device=device)
    lecun_normal_(layer.weight, in_features, generator)
    with torch.no_grad():
        layer.bias.zero_()
    return layer


class TimeUNet2D(nn.Module):
    """One DDPM_Wrapper-equivalent network: ``(x, time) -> (N, out_dim,
    H, W)``."""

    def __init__(self, in_channels: int, out_dim: int, dim: int = 64,
                 init_type: str = "kaiming", device=None, generator=None,
                 dropout_generator=None):
        super().__init__()
        kw = dict(init_type=init_type, device=device, generator=generator)
        self.dim = dim
        self.time_fc1 = dense(dim, dim * 4, device, generator)
        self.time_fc2 = dense(dim * 4, dim, device, generator)
        self.init_conv = ConvBlockLeaky(in_channels, DIMS[0], DROPOUT[0],
                                        dropout_generator=dropout_generator,
                                        **kw)
        for i in range(4):
            setattr(self, f"down{i + 1}",
                    ConvBlockLeaky(DIMS[i], DIMS[i + 1], DROPOUT[i + 1],
                                   dropout_generator=dropout_generator, **kw))
        prev = DIMS[4]
        for i, ch in enumerate((DIMS[3], DIMS[2], DIMS[1], DIMS[0])):
            # the skip popped here is the one taken before down(4 - i)
            setattr(self, f"up{i + 1}", UpBlock2D(prev, DIMS[3 - i], ch, ch,
                                                  **kw))
            prev = ch
        self.final_conv = HConv(DIMS[0], out_dim, kernel_size=3, padding=1,
                                **kw)

    def forward(self, x, time):
        t = sinusoidal_pos_emb(time, self.dim)
        t = self.time_fc2(F.gelu(self.time_fc1(t), approximate="tanh"))
        x = self.init_conv(x) + t[:, :, None, None]
        skips = []
        for i in range(4):
            skips.append(x)
            x = getattr(self, f"down{i + 1}")(max_pool(x))
        for i in range(4):
            x = getattr(self, f"up{i + 1}")(x, skips.pop())
        return self.final_conv(x)


class DDPMUNet(nn.Module):
    """Both diffusion nets and the linear-probe head.  Call modes:
      mode='probe'  : final_conv(x)
      mode='net'    : net(x, time)     — image stream (pred_noise)
      mode='net_seg': net_seg(x, time) — mask stream  (pred_x0)
    """

    def __init__(self, in_channels: int, n_cls: int,
                 hebb: Optional[HebbSpec] = None, init_type: str = "kaiming",
                 device=None, generator=None, dropout_generator=None,
                 dtype=None):
        super().__init__()
        kw = dict(init_type=init_type, device=device, generator=generator)
        self.net = TimeUNet2D(in_channels + n_cls, in_channels,
                              dropout_generator=dropout_generator, **kw)
        self.net_seg = TimeUNet2D(in_channels + n_cls, n_cls,
                                  dropout_generator=dropout_generator, **kw)
        self.final_conv = HConv(n_cls, n_cls, kernel_size=3, padding=1, **kw)
        self.hebb = hebb
        bind_paths(self, hebb)
        set_compute_dtype(self, dtype)

    def forward(self, x, time=None, mode: str = "probe"):
        if mode == "probe":
            return self.final_conv(x)
        if mode == "net":
            return self.net(x, time)
        if mode == "net_seg":
            return self.net_seg(x, time)
        raise ValueError(mode)
