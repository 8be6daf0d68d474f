"""The space-to-depth folded 3D UNet family (``hebbax/models/unet3d_s2d.py``),
NCDHW: ``unet3d_s2d``, ``unet3d_dtc_s2d`` and ``unet3d_cct_s2d`` with its
``_batched`` / ``_rc`` variants.

The same math, parameter tree and snapshots as :mod:`.unet3d`; only the
layout of the full-resolution level differs: encoder1, upconv1, decoder1
and the 1x1x1 heads run on tensors folded at ``FOLD`` = (2, 1, 1) (the
depth axis into the channels, :mod:`..ops.s2d3d`).  upconv1 emits the
folded layout directly, the 2x2x2 max pool of the folded level returns
the unfolded half-resolution tensor, and levels 1-4 are :mod:`.unet3d`'s
modules.  Modules are built in the unfolded twin's order, so a seed draws
the same parameters, and CCT draws its perturbations on the unfolded
levels.
"""

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..hebb.layers import (FoldedHConv3, FoldedHConvTranspose3,
                           HConvTranspose, bind_paths, set_compute_dtype)
from ..hebb.spec import HebbSpec
from ..ops import s2d3d
from .common import (CCT_PERTURB_KINDS, BatchNorm3d, cct_aux_outputs,
                     checkpointed, draw_perturbation, max_pool,
                     perturb_features)
from .unet3d import Block3D

FOLD = (2, 1, 1)


class FoldedBatchNorm3(BatchNorm3d):
    """:class:`BatchNorm3d` on a folded 3D tensor (N, pf·C, *s):
    statistics per ORIGINAL channel over the batch, the voxels and the
    ``pf`` subpixel blocks, parameters and statistics (C,).  ``groups``:
    the input is in grouped-concat order (a folded concat, or a
    FoldedHConv3 with ``out_groups``), and so is the output; the
    parameters stay in original (group-major) channel order."""

    def __init__(self, features: int, pf: int, groups=None, device=None):
        super().__init__(features, device=device)
        self.pf = pf
        self.groups = None if groups is None else tuple(groups)

    def forward(self, x):
        f = (self.pf, 1, 1)
        if self.groups is not None:
            x = s2d3d.regroup3(x, self.groups, f)
        n, sp = x.shape[0], tuple(x.shape[2:])
        c = x.shape[1] // self.pf
        y = super().forward(x.reshape((n * self.pf, c) + sp)).reshape(
            x.shape)
        if self.groups is not None:
            y = s2d3d.ungroup3(y, self.groups, f)
        return y


class FoldedBlock3D(nn.Module):
    """:class:`~.unet3d.Block3D` on folded tensors; the same parameters
    (conv1 / norm1 / conv2 / norm2)."""

    def __init__(self, in_groups, features, fold=FOLD, init_type="kaiming",
                 device=None, generator=None):
        super().__init__()
        kw = dict(fold=fold, init_type=init_type, device=device,
                  generator=generator)
        pf = s2d3d.prodf(fold)
        self.conv1 = FoldedHConv3(in_groups, features, 3, **kw)
        self.norm1 = FoldedBatchNorm3(features, pf, device=device)
        self.conv2 = FoldedHConv3((features,), features, 3, **kw)
        self.norm2 = FoldedBatchNorm3(features, pf, device=device)

    def forward(self, x):
        x = F.relu(self.norm1(self.conv1(x)))
        return F.relu(self.norm2(self.conv2(x)))


class FoldedEncoder3D(nn.Module):
    """:class:`~.unet3d.Encoder3D` with level 0 folded: feats[0] is
    returned FOLDED, feats[1..3] and the bottleneck unfolded."""

    def __init__(self, in_channels, features, fold=FOLD,
                 init_type="kaiming", device=None, generator=None):
        super().__init__()
        kw = dict(init_type=init_type, device=device, generator=generator)
        f = features
        self.fold = tuple(fold)
        self.encoder1 = FoldedBlock3D((in_channels,), f, fold, **kw)
        for i, (cin, cout) in enumerate(((f, 2 * f), (2 * f, 4 * f),
                                         (4 * f, 8 * f)), start=2):
            setattr(self, f"encoder{i}", Block3D(cin, cout, **kw))
        self.bottleneck = Block3D(f * 8, f * 16, **kw)

    def forward(self, x):
        x0 = self.encoder1(s2d3d.fold3(x, self.fold))
        feats = [x0]
        xk = s2d3d.subpixel_max3(x0, self.fold)        # unfolded @ half
        for i in range(2, 5):
            if i > 2:
                xk = max_pool(xk)
            xk = getattr(self, f"encoder{i}")(xk)
            feats.append(xk)
        return feats, self.bottleneck(max_pool(xk))


class FoldedDecoder3D(nn.Module):
    """:class:`~.unet3d.Decoder3D` with upconv1 / decoder1 folded;
    returns the FOLDED pre-head features."""

    def __init__(self, features, fold=FOLD, init_type="kaiming",
                 device=None, generator=None):
        super().__init__()
        kw = dict(init_type=init_type, device=device, generator=generator)
        f = features
        for i, ch in zip((4, 3, 2), (f * 8, f * 4, f * 2)):
            setattr(self, f"upconv{i}",
                    HConvTranspose(ch * 2, ch, kernel_size=(2, 2, 2),
                                   stride=2, **kw))
            setattr(self, f"decoder{i}", Block3D(ch * 2, ch, **kw))
        self.upconv1 = FoldedHConvTranspose3(f * 2, f, fold, **kw)
        self.decoder1 = FoldedBlock3D((f, f), f, fold, **kw)

    def forward(self, bottleneck, feats):
        x = bottleneck
        for i in (4, 3, 2):
            x = getattr(self, f"upconv{i}")(x)
            x = torch.cat([x, feats[i - 1]], dim=1)
            x = getattr(self, f"decoder{i}")(x)
        x = torch.cat([self.upconv1(x), feats[0]], dim=1)
        return self.decoder1(x)


def _finish(model, hebb, dtype):
    model.hebb = hebb
    bind_paths(model, hebb)
    set_compute_dtype(model, dtype)


class UNet3DS2D(nn.Module):
    """``unet3d_s2d``: :class:`~.unet3d.UNet3D` with the full-resolution
    level folded and the 1x1x1 head ``conv`` on the folded features."""

    def __init__(self, in_channels: int, n_cls: int,
                 init_features: int = 64, hebb: Optional[HebbSpec] = None,
                 init_type: str = "kaiming", device=None, generator=None,
                 dropout_generator=None, dtype=None):
        super().__init__()
        del dropout_generator           # no dropout in this network
        kw = dict(init_type=init_type, device=device, generator=generator)
        f, fold = init_features, FOLD
        self.fold = fold
        self.encoder = FoldedEncoder3D(in_channels, f, fold, **kw)
        self.decoder = FoldedDecoder3D(f, fold, **kw)
        self.conv = FoldedHConv3((f,), n_cls, 1, fold, **kw)
        _finish(self, hebb, dtype)

    def forward(self, x):
        feats, bottleneck = self.encoder(x)
        return s2d3d.unfold3(self.conv(self.decoder(bottleneck, feats)),
                             self.fold)


class UNet3DDTCS2D(nn.Module):
    """``unet3d_dtc_s2d``: :class:`~.unet3d.UNet3DDTC` on the folded
    layout, the tanh SDF head ``out_sdf`` and the segmentation head
    ``out_seg`` on the folded features; returns (sdf, seg)."""

    def __init__(self, in_channels: int, n_cls: int,
                 init_features: int = 64, hebb: Optional[HebbSpec] = None,
                 init_type: str = "kaiming", device=None, generator=None,
                 dropout_generator=None, dtype=None):
        super().__init__()
        del dropout_generator           # no dropout in this network
        kw = dict(init_type=init_type, device=device, generator=generator)
        f, fold = init_features, FOLD
        self.fold = fold
        self.encoder = FoldedEncoder3D(in_channels, f, fold, **kw)
        self.decoder = FoldedDecoder3D(f, fold, **kw)
        self.out_sdf = FoldedHConv3((f,), n_cls, 1, fold, **kw)
        self.out_seg = FoldedHConv3((f,), n_cls, 1, fold, **kw)
        _finish(self, hebb, dtype)

    def forward(self, x):
        feats, bottleneck = self.encoder(x)
        dec = self.decoder(bottleneck, feats)
        return (torch.tanh(s2d3d.unfold3(self.out_sdf(dec), self.fold)),
                s2d3d.unfold3(self.out_seg(dec), self.fold))


class UNet3DCCTS2D(nn.Module):
    """``unet3d_cct_s2d``: :class:`~.unet3d.UNet3DCCT` on the folded
    layout; the shared ``main_decoder`` and head ``conv`` run folded for
    all four passes.  The perturbations are drawn and applied on the
    UNFOLDED levels (level 0 unfolded, perturbed, refolded), so the same
    generator or injected draws give the twin's.  ``batched_aux`` and
    ``remat`` / ``remat_policy`` are UNet3DCCT's (the ``_batched`` and
    ``_rc`` names); the plain name recomputes nothing.  Returns (main,
    aux1, aux2, aux3)."""

    def __init__(self, in_channels: int, n_cls: int,
                 init_features: int = 64, hebb: Optional[HebbSpec] = None,
                 init_type: str = "kaiming", device=None, generator=None,
                 dropout_generator=None, perturb_generator=None, dtype=None,
                 batched_aux: bool = False, remat: bool = False,
                 remat_policy: Optional[str] = None):
        super().__init__()
        del dropout_generator           # no dropout in this network
        kw = dict(init_type=init_type, device=device, generator=generator)
        f, fold = init_features, FOLD
        self.fold = fold
        self.encoder = FoldedEncoder3D(in_channels, f, fold, **kw)
        self.main_decoder = FoldedDecoder3D(f, fold, **kw)
        self.conv = FoldedHConv3((f,), n_cls, 1, fold, **kw)
        self.perturb_generator = perturb_generator
        self.batched_aux = batched_aux
        self.remat = remat
        self.remat_policy = remat_policy
        _finish(self, hebb, dtype)

    def decode(self, levels):
        """levels: the four skip features (the first folded), then the
        bottleneck."""
        decoder = (checkpointed(self.main_decoder, self.remat_policy)
                   if self.remat else self.main_decoder)
        return s2d3d.unfold3(self.conv(decoder(levels[-1], levels[:4])),
                             self.fold)

    def draw_perturbations(self, levels):
        """{kind: [draw per UNFOLDED level]} for one training forward."""
        return {kind: [draw_perturbation(kind, f, self.perturb_generator)
                       for f in levels] for kind in CCT_PERTURB_KINDS}

    def forward(self, x):
        feats, bottleneck = self.encoder(x)
        levels = feats + [bottleneck]
        if not self.training:
            main = self.decode(levels)
            return main, main, main, main
        unfolded = [s2d3d.unfold3(levels[0], self.fold)] + levels[1:]
        draws = self.draw_perturbations(unfolded)

        def perturb_one(kind):
            p = perturb_features(unfolded, kind, draws=draws[kind])
            return [s2d3d.fold3(p[0], self.fold)] + p[1:]
        return cct_aux_outputs(levels, perturb_one, self.decode,
                               self.batched_aux)
