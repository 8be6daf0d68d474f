"""2D UNet family (``hebbax/models/unet2d.py``), NCHW, with the same
module names as hebbax so the parameter map to the flax tree is
mechanical.

* Encoder: ConvBlockLeaky(in->16, p=.05) then 4x [maxpool2 +
  ConvBlockLeaky] with channels [32,64,128,256], dropout [.1,.2,.3,.5].
* Decoder: 4 UpBlocks, each = 1x1 conv + bilinear(align_corners=True) 2x
  upsample + concat(skip, up) + two conv3x3-BN-ReLU (no transpose convs).
* Heads: UNet2D's MLPHead, three 3x3 convs with ReLU+Dropout(0.5);
  UNetURPC2D's four single-conv deep-supervision heads; UNetCCT2D's
  single conv after a decoder shared by four passes; the unsupervised
  baselines' 1x1 linear probes beside their pretext heads (UNetVAE2D's
  reparameterized bottleneck and reconstruction, UNetSuperpix2D's
  2-class superpixel head).

Every conv is an HConv; a HebbSpec passed to the model makes the
non-excluded ones Hebbian.  ``generator`` (CPU) draws the initial
parameters, so a seed gives the same model on every device;
``dropout_generator`` (on the model's device) draws the dropout masks;
``latent_generator`` (likewise) UNetVAE2D's reparameterization noise.
"""

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..hebb.layers import HConv, bind_paths, set_compute_dtype
from ..hebb.spec import HebbSpec
from ..ops.dropout import Dropout
from ..parallel import draw_rows
from .common import (CCT_PERTURB_KINDS, BatchNorm2d, cct_aux_outputs,
                     draw_perturbation, max_pool, perturb_features,
                     resize_linear_align_corners, resize_nearest_torch)

FEATURES = (16, 32, 64, 128, 256)
ENC_DROPOUT = (0.05, 0.1, 0.2, 0.3, 0.5)
LEAKY_SLOPE = 0.01


def leaky_relu(x):
    """flax's ``leaky_relu``: the slope 0.01 is a weakly typed constant,
    so it takes x's dtype before it multiplies (in bfloat16 the slope is
    0.010009765625)."""
    slope = float(torch.tensor(LEAKY_SLOPE, dtype=x.dtype))
    return F.leaky_relu(x, slope)


class ConvBlockLeaky(nn.Module):
    """conv3-BN-LeakyReLU-Dropout(p)-conv3-BN-LeakyReLU."""

    def __init__(self, in_ch, features, dropout_p, init_type="kaiming",
                 device=None, generator=None, dropout_generator=None):
        super().__init__()
        kw = dict(kernel_size=3, padding=1, init_type=init_type,
                  device=device, generator=generator)
        self.conv1 = HConv(in_ch, features, **kw)
        self.bn1 = BatchNorm2d(features, device=device,
                               generator=generator)
        self.dropout = Dropout(dropout_p, dropout_generator)
        self.conv2 = HConv(features, features, **kw)
        self.bn2 = BatchNorm2d(features, device=device,
                               generator=generator)

    def forward(self, x):
        x = leaky_relu(self.bn1(self.conv1(x)))
        x = self.dropout(x)
        return leaky_relu(self.bn2(self.conv2(x)))


class ConvBlockReLU(nn.Module):
    """conv3-BN-ReLU x2 (the decoder's ConvBlock)."""

    def __init__(self, in_ch, features, init_type="kaiming", device=None,
                 generator=None):
        super().__init__()
        kw = dict(kernel_size=3, padding=1, init_type=init_type,
                  device=device, generator=generator)
        self.conv1 = HConv(in_ch, features, **kw)
        self.bn1 = BatchNorm2d(features, device=device,
                               generator=generator)
        self.conv2 = HConv(features, features, **kw)
        self.bn2 = BatchNorm2d(features, device=device,
                               generator=generator)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))


class Encoder2D(nn.Module):
    """5-feature encoder; returns the 5 feature maps."""

    def __init__(self, in_channels, init_type="kaiming", device=None,
                 generator=None, dropout_generator=None):
        super().__init__()
        kw = dict(init_type=init_type, device=device, generator=generator,
                  dropout_generator=dropout_generator)
        self.in_conv = ConvBlockLeaky(in_channels, FEATURES[0],
                                      ENC_DROPOUT[0], **kw)
        for i in range(1, 5):
            setattr(self, f"down{i}",
                    ConvBlockLeaky(FEATURES[i - 1], FEATURES[i],
                                   ENC_DROPOUT[i], **kw))

    def forward(self, x):
        x = self.in_conv(x)
        feats = [x]
        for i in range(1, 5):
            x = getattr(self, f"down{i}")(max_pool(x))
            feats.append(x)
        return feats


class UpBlock2D(nn.Module):
    """1x1 conv + bilinear(align_corners) up + concat(skip, up) +
    ConvBlockReLU."""

    def __init__(self, in_ch, skip_ch, mid, out, init_type="kaiming",
                 device=None, generator=None):
        super().__init__()
        self.conv1x1 = HConv(in_ch, mid, kernel_size=1, init_type=init_type,
                             device=device, generator=generator)
        self.conv = ConvBlockReLU(skip_ch + mid, out, init_type=init_type,
                                  device=device, generator=generator)

    def forward(self, x1, x2):
        x1 = self.conv1x1(x1)
        x1 = resize_linear_align_corners(x1, x2.shape[2:])
        return self.conv(torch.cat([x2, x1], dim=1))


class Decoder2D(nn.Module):
    """4 UpBlocks from the bottleneck back to full resolution."""

    def __init__(self, init_type="kaiming", device=None, generator=None):
        super().__init__()
        kw = dict(init_type=init_type, device=device, generator=generator)
        f = FEATURES
        self.up1 = UpBlock2D(f[4], f[3], f[3], f[3], **kw)
        self.up2 = UpBlock2D(f[3], f[2], f[2], f[2], **kw)
        self.up3 = UpBlock2D(f[2], f[1], f[1], f[1], **kw)
        self.up4 = UpBlock2D(f[1], f[0], f[0], f[0], **kw)

    def forward(self, feats):
        x0, x1, x2, x3, x4 = feats
        x = self.up1(x4, x3)
        x = self.up2(x, x2)
        x = self.up3(x, x1)
        return self.up4(x, x0)


class MLPHead(nn.Module):
    """3-conv segmentation head with ReLU+Dropout(0.5); a single
    ``conv_out`` when multiple_layers=False.  ``kernel`` is 3, or 1 for
    the baselines' linear probes."""

    def __init__(self, in_ch, n_cls, kernel=3, multiple_layers=True,
                 init_type="kaiming", device=None, generator=None,
                 dropout_generator=None):
        super().__init__()
        kw = dict(kernel_size=kernel, padding=kernel // 2,
                  init_type=init_type, device=device, generator=generator)
        self.multiple_layers = multiple_layers
        if not multiple_layers:
            self.conv_out = HConv(in_ch, n_cls, **kw)
            return
        self.conv1 = HConv(in_ch, in_ch * 4, **kw)
        self.dropout1 = Dropout(0.5, dropout_generator)
        self.conv2 = HConv(in_ch * 4, in_ch * 2, **kw)
        self.dropout2 = Dropout(0.5, dropout_generator)
        self.conv_out = HConv(in_ch * 2, n_cls, **kw)

    def forward(self, x):
        if self.multiple_layers:
            x = self.dropout1(F.relu(self.conv1(x)))
            x = self.dropout2(F.relu(self.conv2(x)))
        return self.conv_out(x)


class UNet2D(nn.Module):
    """The flagship 2D model (UNet_Transposed_Leaky)."""

    def __init__(self, in_channels: int, n_cls: int,
                 hebb: Optional[HebbSpec] = None, init_type: str = "kaiming",
                 device=None, generator=None, dropout_generator=None,
                 dtype=None):
        super().__init__()
        kw = dict(init_type=init_type, device=device, generator=generator)
        self.encoder = Encoder2D(in_channels,
                                 dropout_generator=dropout_generator, **kw)
        self.main_decoder = Decoder2D(**kw)
        self.out_conv = MLPHead(FEATURES[0], n_cls,
                                dropout_generator=dropout_generator, **kw)
        self.hebb = hebb
        bind_paths(self, hebb)
        set_compute_dtype(self, dtype)

    def forward(self, x):
        return self.out_conv(self.main_decoder(self.encoder(x)))


class UNetURPC2D(nn.Module):
    """Multi-scale deep supervision: a single 3x3 head after each
    UpBlock, the lower three nearest-upsampled to the input size.  Returns
    (out_conv, dp1, dp2, dp3), finest first."""

    def __init__(self, in_channels: int, n_cls: int,
                 hebb: Optional[HebbSpec] = None, init_type: str = "kaiming",
                 device=None, generator=None, dropout_generator=None,
                 dtype=None):
        super().__init__()
        kw = dict(init_type=init_type, device=device, generator=generator)
        hk = dict(kernel_size=3, padding=1, **kw)
        f = FEATURES
        self.encoder = Encoder2D(in_channels,
                                 dropout_generator=dropout_generator, **kw)
        self.up1 = UpBlock2D(f[4], f[3], f[3], f[3], **kw)
        self.out_conv_dp3 = HConv(f[3], n_cls, **hk)
        self.up2 = UpBlock2D(f[3], f[2], f[2], f[2], **kw)
        self.out_conv_dp2 = HConv(f[2], n_cls, **hk)
        self.up3 = UpBlock2D(f[2], f[1], f[1], f[1], **kw)
        self.out_conv_dp1 = HConv(f[1], n_cls, **hk)
        self.up4 = UpBlock2D(f[1], f[0], f[0], f[0], **kw)
        self.out_conv = HConv(f[0], n_cls, **hk)
        self.hebb = hebb
        bind_paths(self, hebb)
        set_compute_dtype(self, dtype)

    def forward(self, x):
        shape = x.shape[2:]
        x0, x1, x2, x3, x4 = self.encoder(x)
        up = self.up1(x4, x3)
        dp3 = resize_nearest_torch(self.out_conv_dp3(up), shape)
        up = self.up2(up, x2)
        dp2 = resize_nearest_torch(self.out_conv_dp2(up), shape)
        up = self.up3(up, x1)
        dp1 = resize_nearest_torch(self.out_conv_dp1(up), shape)
        up = self.up4(up, x0)
        return self.out_conv(up), dp1, dp2, dp3


class UNetCCT2D(nn.Module):
    """One shared decoder (``up1..up4`` + a 3x3 ``out_conv``) run on the
    clean encoder features and on 3 perturbed copies (noise, dropout,
    feature dropout).  Returns (main, aux1, aux2, aux3).

    A training forward always perturbs, drawing from
    ``perturb_generator`` through :meth:`draw_perturbations` (an instance
    may replace that method to inject draws).  An eval forward skips the
    perturbed passes and returns the main output four times: only the
    primary output is read in eval.  ``batched_aux`` (``unet_cct_s2d_batched``)
    runs the four decoder passes as one of 4N
    (:func:`~hebbax_torch.models.common.cct_aux_outputs`).
    """

    def __init__(self, in_channels: int, n_cls: int,
                 hebb: Optional[HebbSpec] = None, init_type: str = "kaiming",
                 device=None, generator=None, dropout_generator=None,
                 perturb_generator=None, dtype=None,
                 batched_aux: bool = False):
        super().__init__()
        kw = dict(init_type=init_type, device=device, generator=generator)
        f = FEATURES
        self.encoder = Encoder2D(in_channels,
                                 dropout_generator=dropout_generator, **kw)
        self.up1 = UpBlock2D(f[4], f[3], f[3], f[3], **kw)
        self.up2 = UpBlock2D(f[3], f[2], f[2], f[2], **kw)
        self.up3 = UpBlock2D(f[2], f[1], f[1], f[1], **kw)
        self.up4 = UpBlock2D(f[1], f[0], f[0], f[0], **kw)
        self.out_conv = HConv(f[0], n_cls, kernel_size=3, padding=1, **kw)
        self.perturb_generator = perturb_generator
        self.batched_aux = batched_aux
        self.hebb = hebb
        bind_paths(self, hebb)
        set_compute_dtype(self, dtype)

    def decode(self, feats):
        x0, x1, x2, x3, x4 = feats
        d = self.up1(x4, x3)
        d = self.up2(d, x2)
        d = self.up3(d, x1)
        return self.out_conv(self.up4(d, x0))

    def draw_perturbations(self, feats):
        """{kind: [draw per feature level]} for one training forward."""
        return {kind: [draw_perturbation(kind, f, self.perturb_generator)
                       for f in feats] for kind in CCT_PERTURB_KINDS}

    def forward(self, x):
        feats = self.encoder(x)
        if not self.training:
            main = self.decode(feats)
            return main, main, main, main
        draws = self.draw_perturbations(feats)
        return cct_aux_outputs(
            feats, lambda kind: perturb_features(feats, kind,
                                                 draws=draws[kind]),
            self.decode, self.batched_aux)


class UNetVAE2D(nn.Module):
    """Backbone + 1x1 ``mu`` / ``var`` (256 -> 256) on the bottleneck, the
    reparameterized latent ``eps * exp(0.5 * log_var) + mu`` into the
    decoder in place of the bottleneck, then a 1x1 three-layer probe head
    ``out_conv`` and a 1x1 ``reconstr`` (16 -> in_channels).  Returns
    {'output', 'mu', 'log_var', 'reconstr'}.

    eps is drawn from ``latent_generator`` on every forward, eval
    included, through :meth:`draw_latent` (an instance may replace it, or
    a caller pass ``eps``); without a generator eps is 0.
    """

    def __init__(self, in_channels: int, n_cls: int,
                 hebb: Optional[HebbSpec] = None, init_type: str = "kaiming",
                 device=None, generator=None, dropout_generator=None,
                 latent_generator=None, dtype=None):
        super().__init__()
        kw = dict(init_type=init_type, device=device, generator=generator)
        f = FEATURES
        self.encoder = Encoder2D(in_channels,
                                 dropout_generator=dropout_generator, **kw)
        self.mu = HConv(f[4], 256, kernel_size=1, **kw)
        self.var = HConv(f[4], 256, kernel_size=1, **kw)
        self.main_decoder = Decoder2D(**kw)
        self.out_conv = MLPHead(f[0], n_cls, kernel=1,
                                dropout_generator=dropout_generator, **kw)
        self.reconstr = HConv(f[0], in_channels, kernel_size=1, **kw)
        self.latent_generator = latent_generator
        self.hebb = hebb
        bind_paths(self, hebb)
        set_compute_dtype(self, dtype)

    def draw_latent(self, std):
        if self.latent_generator is None:
            return torch.zeros_like(std)
        return draw_rows(lambda shape: torch.randn(
            shape, dtype=std.dtype, device=std.device,
            generator=self.latent_generator), std.shape)

    def forward(self, x, eps=None):
        feats = self.encoder(x)
        mu = self.mu(feats[-1])
        log_var = self.var(feats[-1])
        std = torch.exp(0.5 * log_var)
        if eps is None:
            eps = self.draw_latent(std)
        dec = self.main_decoder(feats[:4] + [eps * std + mu])
        return {"output": self.out_conv(dec), "mu": mu, "log_var": log_var,
                "reconstr": self.reconstr(dec)}


class UNetSuperpix2D(nn.Module):
    """Backbone + a single 1x1 probe ``out_conv`` and a 2-class 1x1
    ``out_superpix`` head; returns (seg, superpix)."""

    def __init__(self, in_channels: int, n_cls: int,
                 hebb: Optional[HebbSpec] = None, init_type: str = "kaiming",
                 device=None, generator=None, dropout_generator=None,
                 dtype=None):
        super().__init__()
        kw = dict(init_type=init_type, device=device, generator=generator)
        f = FEATURES
        self.encoder = Encoder2D(in_channels,
                                 dropout_generator=dropout_generator, **kw)
        self.main_decoder = Decoder2D(**kw)
        self.out_conv = MLPHead(f[0], n_cls, kernel=1, multiple_layers=False,
                                **kw)
        self.out_superpix = HConv(f[0], 2, kernel_size=1, **kw)
        self.hebb = hebb
        bind_paths(self, hebb)
        set_compute_dtype(self, dtype)

    def forward(self, x):
        dec = self.main_decoder(self.encoder(x))
        return self.out_conv(dec), self.out_superpix(dec)
