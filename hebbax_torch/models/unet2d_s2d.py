"""The space-to-depth folded 2D UNet family (``hebbax/models/unet2d_s2d.py``),
NCHW: ``unet_s2d``, ``unet_urpc_s2d``, ``unet_cct_s2d`` and
``unet_cct_s2d_batched``.

The same math, parameter tree and snapshots as :mod:`.unet2d`; only the
layout differs.  The top two pyramid levels (16 and 32 channels at full
and half resolution), their decoder blocks and the heads that read them
run on 2x2-folded tensors (:mod:`..ops.s2d`): 4x the channels at a
quarter of the pixels.  The 2x2 max pool of a folded level is a max over
its subpixel blocks and returns the unfolded half-resolution tensor.
Levels 2-4 are :mod:`.unet2d`'s modules.  H and W must be multiples of 4
(of 8 for ``head_depth=2``).

Every module is built in the unfolded twin's order, so a seed draws the
same parameters for ``unet`` and ``unet_s2d``.  The dropouts draw their
masks in the unfolded shape and fold them (:class:`FoldedDropout`), and
CCT draws its perturbations on the unfolded levels, so a folded network
and its twin on the same generators take the same draws.
"""

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..hebb.layers import FoldedHConv, HConv, bind_paths, set_compute_dtype
from ..hebb.spec import HebbSpec
from ..ops import s2d
from ..ops.dropout import Dropout
from ..ops.s2d3d import fold_nd
from ..parallel import draw_rows
from ..utils.remat import stash
from .common import (CCT_PERTURB_KINDS, BatchNorm2d, cct_aux_outputs,
                     draw_perturbation, max_pool, perturb_features,
                     resize_linear_align_corners, resize_nearest_torch)
from .unet2d import (ENC_DROPOUT, FEATURES, ConvBlockLeaky, UpBlock2D,
                     leaky_relu)


class FoldedBatchNorm(BatchNorm2d):
    """:class:`BatchNorm2d` on a folded tensor (N, pf·C, *s): statistics
    per ORIGINAL channel over the batch, the spatial dims and the ``pf``
    subpixel blocks, parameters and running statistics (C,) as the
    unfolded network's.  The folded tensor is viewed as (N·pf, C, *s), so
    the statistics (global under data parallelism), the recompute replay
    and the dtypes are BatchNorm2d's."""

    def __init__(self, features: int, pf: int = 4, device=None,
                 generator=None):
        super().__init__(features, device=device, generator=generator)
        self.pf = pf

    def forward(self, x):
        n, sp = x.shape[0], tuple(x.shape[2:])
        c = x.shape[1] // self.pf
        y = super().forward(x.reshape((n * self.pf, c) + sp))
        return y.reshape(x.shape)


class FoldedDropout(Dropout):
    """Elementwise dropout on a tensor folded ``depth`` times at factors
    ``f``: the keep mask is drawn in the UNFOLDED shape (the twin's draw)
    and folded."""

    def __init__(self, p: float, generator=None, f=(2, 2), depth=1):
        super().__init__(p, generator)
        self.f, self.depth = tuple(f), depth

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        pf = 1
        for a in self.f:
            pf *= a ** self.depth
        shape = ((x.shape[0], x.shape[1] // pf)
                 + tuple(s * a ** self.depth
                         for s, a in zip(x.shape[2:], self.f)))

        def draw():
            keep = draw_rows(lambda sh: torch.empty(
                sh, dtype=x.dtype, device=x.device).bernoulli_(
                1.0 - self.p, generator=self.generator), shape)
            for _ in range(self.depth):
                keep = fold_nd(keep, self.f)
            return keep
        return x * stash(draw) * (1.0 / (1.0 - self.p))


class FoldedConvBlockLeaky(nn.Module):
    """:class:`~.unet2d.ConvBlockLeaky` on folded tensors; the same
    parameters (conv1 / bn1 / conv2 / bn2)."""

    def __init__(self, in_groups, features, dropout_p, init_type="kaiming",
                 device=None, generator=None, dropout_generator=None):
        super().__init__()
        kw = dict(init_type=init_type, device=device, generator=generator)
        self.conv1 = FoldedHConv(in_groups, features, 3, **kw)
        self.bn1 = FoldedBatchNorm(features, device=device,
                                   generator=generator)
        self.dropout = FoldedDropout(dropout_p, dropout_generator)
        self.conv2 = FoldedHConv((features,), features, 3, **kw)
        self.bn2 = FoldedBatchNorm(features, device=device,
                                   generator=generator)

    def forward(self, x):
        x = leaky_relu(self.bn1(self.conv1(x)))
        x = self.dropout(x)
        return leaky_relu(self.bn2(self.conv2(x)))


class FoldedConvBlockReLU(nn.Module):
    """The decoder's :class:`~.unet2d.ConvBlockReLU` on folded tensors."""

    def __init__(self, in_groups, features, init_type="kaiming",
                 device=None, generator=None):
        super().__init__()
        kw = dict(init_type=init_type, device=device, generator=generator)
        self.conv1 = FoldedHConv(in_groups, features, 3, **kw)
        self.bn1 = FoldedBatchNorm(features, device=device,
                                   generator=generator)
        self.conv2 = FoldedHConv((features,), features, 3, **kw)
        self.bn2 = FoldedBatchNorm(features, device=device,
                                   generator=generator)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))


class FoldedMLPHead(nn.Module):
    """:class:`~.unet2d.MLPHead` (three 3x3 convs) on a once-folded
    input, returning UNFOLDED logits.  ``depth=2`` folds the input again,
    so the head's convs run on 4x4 blocks."""

    def __init__(self, in_ch, n_cls, depth=1, init_type="kaiming",
                 device=None, generator=None, dropout_generator=None):
        super().__init__()
        kw = dict(kernel_size=3, depth=depth, init_type=init_type,
                  device=device, generator=generator)
        self.depth = depth
        self.conv1 = FoldedHConv((in_ch,), in_ch * 4, **kw)
        self.dropout1 = FoldedDropout(0.5, dropout_generator, depth=depth)
        self.conv2 = FoldedHConv((in_ch * 4,), in_ch * 2, **kw)
        self.dropout2 = FoldedDropout(0.5, dropout_generator, depth=depth)
        self.conv_out = FoldedHConv((in_ch * 2,), n_cls, **kw)

    def forward(self, x):
        for _ in range(self.depth - 1):
            x = s2d.fold(x)
        x = self.dropout1(F.relu(self.conv1(x)))
        x = self.dropout2(F.relu(self.conv2(x)))
        y = self.conv_out(x)
        for _ in range(self.depth):
            y = s2d.unfold(y)
        return y


class FoldedEncoder2D(nn.Module):
    """:class:`~.unet2d.Encoder2D` with levels 0 and 1 folded: feats[0]
    and feats[1] are returned FOLDED (the folded decoder blocks concat
    them so), feats[2..4] unfolded."""

    def __init__(self, in_channels, init_type="kaiming", device=None,
                 generator=None, dropout_generator=None):
        super().__init__()
        kw = dict(init_type=init_type, device=device, generator=generator,
                  dropout_generator=dropout_generator)
        self.in_conv = FoldedConvBlockLeaky((in_channels,), FEATURES[0],
                                            ENC_DROPOUT[0], **kw)
        self.down1 = FoldedConvBlockLeaky((FEATURES[0],), FEATURES[1],
                                          ENC_DROPOUT[1], **kw)
        for i in range(2, 5):
            setattr(self, f"down{i}",
                    ConvBlockLeaky(FEATURES[i - 1], FEATURES[i],
                                   ENC_DROPOUT[i], **kw))

    def forward(self, x):
        x0 = self.in_conv(s2d.fold(x))                   # folded 16 @ H
        x1 = self.down1(s2d.fold(s2d.subpixel_max(x0)))  # folded 32 @ H/2
        feats = [x0, x1]
        xk = s2d.subpixel_max(x1)                        # unfolded @ H/4
        for i in range(2, 5):
            if i > 2:
                xk = max_pool(xk)
            xk = getattr(self, f"down{i}")(xk)
            feats.append(xk)
        return feats


class FoldedUpBlock(nn.Module):
    """:class:`~.unet2d.UpBlock2D` whose ConvBlock runs folded: ``x1``
    arrives unfolded (or is unfolded here, ``x_folded``), the 1x1 conv and
    the align-corners resize run unfolded, the concat with the FOLDED
    skip and the ConvBlock folded."""

    def __init__(self, in_ch, skip_ch, mid, out, x_folded,
                 init_type="kaiming", device=None, generator=None):
        super().__init__()
        self.x_folded = x_folded
        self.conv1x1 = HConv(in_ch, mid, kernel_size=1, init_type=init_type,
                             device=device, generator=generator)
        self.conv = FoldedConvBlockReLU((skip_ch, mid), out,
                                        init_type=init_type, device=device,
                                        generator=generator)

    def forward(self, x1, x2_folded):
        if self.x_folded:
            x1 = s2d.unfold(x1)
        x1 = self.conv1x1(x1)
        out_spatial = tuple(2 * s for s in x2_folded.shape[2:])
        x1 = s2d.fold(resize_linear_align_corners(x1, out_spatial))
        return self.conv(torch.cat([x2_folded, x1], dim=1))


def _folded_ups(owner, kw):
    """up1..up4 on ``owner``: two :class:`~.unet2d.UpBlock2D`, then two
    :class:`FoldedUpBlock`."""
    f = FEATURES
    owner.up1 = UpBlock2D(f[4], f[3], f[3], f[3], **kw)
    owner.up2 = UpBlock2D(f[3], f[2], f[2], f[2], **kw)
    owner.up3 = FoldedUpBlock(f[2], f[1], f[1], f[1], False, **kw)
    owner.up4 = FoldedUpBlock(f[1], f[0], f[0], f[0], True, **kw)


def _decode(owner, feats):
    x0f, x1f, x2, x3, x4 = feats
    x = owner.up1(x4, x3)
    x = owner.up2(x, x2)
    x = owner.up3(x, x1f)
    return owner.up4(x, x0f)


class FoldedDecoder2D(nn.Module):
    """:class:`~.unet2d.Decoder2D` with up3 / up4 folded; returns the
    FOLDED 16-channel features."""

    def __init__(self, init_type="kaiming", device=None, generator=None):
        super().__init__()
        _folded_ups(self, dict(init_type=init_type, device=device,
                               generator=generator))

    def forward(self, feats):
        return _decode(self, feats)


def _finish(model, hebb, dtype):
    model.hebb = hebb
    bind_paths(model, hebb)
    set_compute_dtype(model, dtype)


class UNet2DS2D(nn.Module):
    """``unet_s2d``: :class:`~.unet2d.UNet2D` with folded top levels and
    a folded MLP head (``head_depth=2``: 4x4-folded)."""

    def __init__(self, in_channels: int, n_cls: int,
                 hebb: Optional[HebbSpec] = None, init_type: str = "kaiming",
                 device=None, generator=None, dropout_generator=None,
                 dtype=None, head_depth: int = 1):
        super().__init__()
        kw = dict(init_type=init_type, device=device, generator=generator)
        self.encoder = FoldedEncoder2D(
            in_channels, dropout_generator=dropout_generator, **kw)
        self.main_decoder = FoldedDecoder2D(**kw)
        self.out_conv = FoldedMLPHead(
            FEATURES[0], n_cls, depth=head_depth,
            dropout_generator=dropout_generator, **kw)
        _finish(self, hebb, dtype)

    def forward(self, x):
        return self.out_conv(self.main_decoder(self.encoder(x)))


class UNetURPC2DS2D(nn.Module):
    """``unet_urpc_s2d``: :class:`~.unet2d.UNetURPC2D` with folded top
    levels; the dp1 and main heads run folded and return unfolded logits.
    Returns (out_conv, dp1, dp2, dp3)."""

    def __init__(self, in_channels: int, n_cls: int,
                 hebb: Optional[HebbSpec] = None, init_type: str = "kaiming",
                 device=None, generator=None, dropout_generator=None,
                 dtype=None):
        super().__init__()
        kw = dict(init_type=init_type, device=device, generator=generator)
        hk = dict(kernel_size=3, padding=1, **kw)
        f = FEATURES
        self.encoder = FoldedEncoder2D(
            in_channels, dropout_generator=dropout_generator, **kw)
        self.up1 = UpBlock2D(f[4], f[3], f[3], f[3], **kw)
        self.out_conv_dp3 = HConv(f[3], n_cls, **hk)
        self.up2 = UpBlock2D(f[3], f[2], f[2], f[2], **kw)
        self.out_conv_dp2 = HConv(f[2], n_cls, **hk)
        self.up3 = FoldedUpBlock(f[2], f[1], f[1], f[1], False, **kw)
        self.out_conv_dp1 = FoldedHConv((f[1],), n_cls, 3, **kw)
        self.up4 = FoldedUpBlock(f[1], f[0], f[0], f[0], True, **kw)
        self.out_conv = FoldedHConv((f[0],), n_cls, 3, **kw)
        _finish(self, hebb, dtype)

    def forward(self, x):
        shape = x.shape[2:]
        x0f, x1f, x2, x3, x4 = self.encoder(x)
        up = self.up1(x4, x3)
        dp3 = resize_nearest_torch(self.out_conv_dp3(up), shape)
        up = self.up2(up, x2)
        dp2 = resize_nearest_torch(self.out_conv_dp2(up), shape)
        up = self.up3(up, x1f)
        dp1 = resize_nearest_torch(s2d.unfold(self.out_conv_dp1(up)), shape)
        up = self.up4(up, x0f)
        return s2d.unfold(self.out_conv(up)), dp1, dp2, dp3


def unfold_levels(feats):
    """The 2D encoder levels in the unfolded layout: levels 0 and 1
    unfolded."""
    return [s2d.unfold(feats[0]), s2d.unfold(feats[1])] + list(feats[2:])


def fold_levels(feats):
    """Inverse of :func:`unfold_levels`."""
    return [s2d.fold(feats[0]), s2d.fold(feats[1])] + list(feats[2:])


class UNetCCT2DS2D(nn.Module):
    """``unet_cct_s2d``: :class:`~.unet2d.UNetCCT2D` with the shared
    decoder's top levels and its head folded.  The perturbations are
    drawn and applied on the UNFOLDED levels (:meth:`draw_perturbations`
    sees the twin's shapes, so the same generator or injected draws give
    the same perturbations) and refolded.  ``batched_aux``
    (``unet_cct_s2d_batched``) decodes the clean and 3 perturbed levels as
    one batch of 4N.  Returns (main, aux1, aux2, aux3)."""

    def __init__(self, in_channels: int, n_cls: int,
                 hebb: Optional[HebbSpec] = None, init_type: str = "kaiming",
                 device=None, generator=None, dropout_generator=None,
                 perturb_generator=None, dtype=None,
                 batched_aux: bool = False):
        super().__init__()
        kw = dict(init_type=init_type, device=device, generator=generator)
        self.encoder = FoldedEncoder2D(
            in_channels, dropout_generator=dropout_generator, **kw)
        _folded_ups(self, kw)
        self.out_conv = FoldedHConv((FEATURES[0],), n_cls, 3, **kw)
        self.perturb_generator = perturb_generator
        self.batched_aux = batched_aux
        _finish(self, hebb, dtype)

    def decode(self, feats):
        return s2d.unfold(self.out_conv(_decode(self, feats)))

    def draw_perturbations(self, feats):
        """{kind: [draw per UNFOLDED feature level]} for one training
        forward."""
        return {kind: [draw_perturbation(kind, f, self.perturb_generator)
                       for f in feats] for kind in CCT_PERTURB_KINDS}

    def forward(self, x):
        feats = self.encoder(x)
        if not self.training:
            main = self.decode(feats)
            return main, main, main, main
        unfolded = unfold_levels(feats)
        draws = self.draw_perturbations(unfolded)
        return cct_aux_outputs(
            feats, lambda kind: fold_levels(perturb_features(
                unfolded, kind, draws=draws[kind])),
            self.decode, self.batched_aux)
