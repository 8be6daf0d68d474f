"""Shared model ops (``hebbax/models/common.py``) in NCHW: pooling, the
align_corners bilinear resize, and flax-semantics batch norm."""

import torch
import torch.nn as nn
import torch.nn.functional as F


def max_pool(x):
    """MaxPool2d(kernel_size=2) over the spatial dims."""
    if min(x.shape[2:]) < 2:
        raise ValueError(
            f"max_pool collapses a spatial dim of {tuple(x.shape)} to "
            f"zero — 4-level UNets need >= 16 px per axis")
    return F.max_pool2d(x, 2)


def resize_linear_align_corners(x, out_spatial):
    """Bilinear resize with align_corners=True (torch Upsample parity)."""
    if tuple(x.shape[2:]) == tuple(out_spatial):
        return x
    return F.interpolate(x, size=tuple(out_spatial), mode="bilinear",
                         align_corners=True)


class BatchNorm2d(nn.Module):
    """Batch norm with flax ``nn.BatchNorm`` semantics and torch defaults.

    eps 1e-5; running statistics move by 0.1 per training forward (flax
    momentum 0.9); ``running_var`` takes the BIASED batch variance, as
    flax does (stock ``nn.BatchNorm2d`` takes the unbiased one); the scale
    initialises to N(1, 0.02) (the reference's 2D init_weights), drawn on
    the CPU from ``generator``.
    """

    eps = 1e-5
    momentum = 0.1
    gain_init = 0.02

    def __init__(self, features: int, device=None, generator=None):
        super().__init__()
        scale = 1.0 + self.gain_init * torch.randn(features,
                                                   generator=generator)
        self.weight = nn.Parameter(scale.to(device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(features, device=device))
        self.register_buffer("running_var",
                             torch.ones(features, device=device))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.eps)
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        with torch.no_grad():
            self.running_mean.lerp_(mean.detach(), self.momentum)
            self.running_var.lerp_(var.detach(), self.momentum)
        inv = torch.rsqrt(var + self.eps)
        return ((x - mean[None, :, None, None])
                * (inv * self.weight)[None, :, None, None]
                + self.bias[None, :, None, None])
