"""V-Net family (``hebbax/models/vnet.py`` ``VNet``, ``VNetCCT``,
``VNetDTC``), NCDHW, with hebbax's module names so the parameter map to
the flax tree is mechanical.

InputTransition: conv5 -> BN, plus the input tiled to 16 channels
(``16 // in_channels`` copies), ELU.  DownTransition: a k = s = 2 strided
conv doubling the channels -> BN -> ELU, then a residual LUConv stack
(conv5 pad 2 -> BN -> ELU, n times).  UpTransition: ``Dropout3d(0.5)``
on the skip, a k = s = 2 transpose conv to out // 2 -> BN -> ELU,
concat([up, skip]), then the residual stack.  OutputTransition: conv5 ->
BN -> ELU -> the 1x1x1 ``conv2``.  Every conv is an HConv /
HConvTranspose (25 Hebbian sites: 4 strided down convs, 4 transpose up
convs), every batch norm flax's defaults (momentum 0.9, eps 1e-5, scale
ones: :class:`BatchNorm3d`), every ELU alpha 1.

VNetCCT runs one shared ``main_decoder`` (the four UpTransitions and
``out_tr``) on the clean encoder levels and on three perturbed copies of
all five; hebbax rematerializes it, which changes no value, so it runs
plainly here.  VNetDTC has a tanh signed-distance head ``out_sdf`` beside
the segmentation head ``out_seg``.

``generator`` (CPU) draws the initial parameters, ``dropout_generator``
(on the model's device) the skip dropout, ``perturb_generator`` VNetCCT's
perturbations.
"""

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..hebb.layers import HConv, HConvTranspose, bind_paths, set_compute_dtype
from ..hebb.spec import HebbSpec
from .common import (CCT_PERTURB_KINDS, BatchNorm3d, Dropout3d,
                     cct_aux_outputs, draw_perturbation, perturb_features)


class LUConvStack(nn.Module):
    """n x (conv5 pad 2 -> BN -> ELU) at constant width."""

    def __init__(self, features, n, **kw):
        super().__init__()
        device = kw.get("device")
        self.n = n
        for i in range(n):
            setattr(self, f"conv{i + 1}", HConv(
                features, features, kernel_size=(5, 5, 5), padding=2, **kw))
            setattr(self, f"bn{i + 1}", BatchNorm3d(features, device=device))

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"conv{i + 1}")(x)
            x = F.elu(getattr(self, f"bn{i + 1}")(x))
        return x


class InputTransition(nn.Module):
    """conv5 -> BN, plus the input tiled to 16 channels, then ELU."""

    def __init__(self, in_channels, **kw):
        super().__init__()
        self.conv1 = HConv(in_channels, 16, kernel_size=(5, 5, 5), padding=2,
                           **kw)
        self.bn1 = BatchNorm3d(16, device=kw.get("device"))

    def forward(self, x):
        out = self.bn1(self.conv1(x))
        return F.elu(out + x.repeat(1, 16 // x.shape[1], 1, 1, 1))


class DownTransition(nn.Module):
    """k = s = 2 conv doubling the channels -> BN -> ELU, then a residual
    LUConv stack."""

    def __init__(self, in_features, out_features, n_convs, **kw):
        super().__init__()
        self.down_conv = HConv(in_features, out_features,
                               kernel_size=(2, 2, 2), stride=2, **kw)
        self.bn1 = BatchNorm3d(out_features, device=kw.get("device"))
        self.ops = LUConvStack(out_features, n_convs, **kw)

    def forward(self, x):
        down = F.elu(self.bn1(self.down_conv(x)))
        return F.elu(self.ops(down) + down)


class UpTransition(nn.Module):
    """Dropout3d(0.5) on the skip; k = s = 2 transpose conv to
    out_features // 2 -> BN -> ELU; concat([up, skip]) and a residual
    LUConv stack."""

    def __init__(self, in_features, out_features, n_convs,
                 dropout_generator=None, **kw):
        super().__init__()
        self.drop = Dropout3d(0.5, dropout_generator)
        self.up_conv = HConvTranspose(in_features, out_features // 2,
                                      kernel_size=(2, 2, 2), stride=2, **kw)
        self.bn1 = BatchNorm3d(out_features // 2, device=kw.get("device"))
        self.ops = LUConvStack(out_features, n_convs, **kw)

    def forward(self, x, skip):
        skip = self.drop(skip)
        up = F.elu(self.bn1(self.up_conv(x)))
        xcat = torch.cat([up, skip], dim=1)
        return F.elu(self.ops(xcat) + xcat)


class OutputTransition(nn.Module):
    """conv5 -> BN -> ELU -> the 1x1x1 head ``conv2``."""

    def __init__(self, in_features, n_cls, **kw):
        super().__init__()
        self.conv1 = HConv(in_features, n_cls, kernel_size=(5, 5, 5),
                           padding=2, **kw)
        self.bn1 = BatchNorm3d(n_cls, device=kw.get("device"))
        self.conv2 = HConv(n_cls, n_cls, kernel_size=(1, 1, 1), **kw)

    def forward(self, x):
        return self.conv2(F.elu(self.bn1(self.conv1(x))))


def _add_encoder(owner, in_channels, **kw):
    """in_tr and the four DownTransitions, at the root of ``owner`` as in
    hebbax's trees."""
    owner.in_tr = InputTransition(in_channels, **kw)
    owner.down_tr32 = DownTransition(16, 32, 1, **kw)
    owner.down_tr64 = DownTransition(32, 64, 2, **kw)
    owner.down_tr128 = DownTransition(64, 128, 3, **kw)
    owner.down_tr256 = DownTransition(128, 256, 2, **kw)


def _encode(owner, x):
    """The five levels [out256, out128, out64, out32, out16] (hebbax's
    order: the one CCT perturbs them in)."""
    out16 = owner.in_tr(x)
    out32 = owner.down_tr32(out16)
    out64 = owner.down_tr64(out32)
    out128 = owner.down_tr128(out64)
    return [owner.down_tr256(out128), out128, out64, out32, out16]


def _add_decoder(owner, dropout_generator, **kw):
    """The four UpTransitions on ``owner``."""
    for name, cin, cout, n in (("up_tr256", 256, 256, 2),
                               ("up_tr128", 256, 128, 2),
                               ("up_tr64", 128, 64, 1),
                               ("up_tr32", 64, 32, 1)):
        setattr(owner, name, UpTransition(
            cin, cout, n, dropout_generator=dropout_generator, **kw))


def _decode(owner, levels):
    """The UpTransitions over the five levels: 32-channel features."""
    out256, out128, out64, out32, out16 = levels
    out = owner.up_tr256(out256, out128)
    out = owner.up_tr128(out, out64)
    out = owner.up_tr64(out, out32)
    return owner.up_tr32(out, out16)


def _finish(model, hebb, dtype):
    model.hebb = hebb
    bind_paths(model, hebb)
    set_compute_dtype(model, dtype)


class VNet(nn.Module):
    """VNet: in_tr, down_tr32..256, up_tr256..32 and the head ``out_tr``
    (``out_tr.conv2`` is the 1x1x1 conv a pretraining excludes)."""

    def __init__(self, in_channels: int, n_cls: int,
                 hebb: Optional[HebbSpec] = None, init_type: str = "kaiming",
                 device=None, generator=None, dropout_generator=None,
                 dtype=None):
        super().__init__()
        kw = dict(init_type=init_type, device=device, generator=generator)
        _add_encoder(self, in_channels, **kw)
        _add_decoder(self, dropout_generator, **kw)
        self.out_tr = OutputTransition(32, n_cls, **kw)
        _finish(self, hebb, dtype)

    def forward(self, x):
        return self.out_tr(_decode(self, _encode(self, x)))


class VNetDecoder(nn.Module):
    """The shared decode path of VNetCCT: the four UpTransitions and
    ``out_tr``."""

    def __init__(self, n_cls, dropout_generator=None, **kw):
        super().__init__()
        _add_decoder(self, dropout_generator, **kw)
        self.out_tr = OutputTransition(32, n_cls, **kw)

    def forward(self, levels):
        return self.out_tr(_decode(self, levels))


class VNetCCT(nn.Module):
    """The VNet encoder and one shared ``main_decoder`` run on the clean
    levels and on 3 perturbed copies (noise, dropout, feature dropout) of
    all five.  Returns (main, aux1, aux2, aux3).

    As :class:`~hebbax_torch.models.unet3d.UNet3DCCT`: a training forward
    perturbs, drawing from ``perturb_generator`` through
    :meth:`draw_perturbations` (an instance may replace it to inject
    draws); an eval forward returns the main output four times.  Four
    serial decoder passes per training forward: each batch norm of the
    decoder takes four momentum updates, and each Hebbian site of the
    decoder sums four deltas."""

    def __init__(self, in_channels: int, n_cls: int,
                 hebb: Optional[HebbSpec] = None, init_type: str = "kaiming",
                 device=None, generator=None, dropout_generator=None,
                 perturb_generator=None, dtype=None):
        super().__init__()
        kw = dict(init_type=init_type, device=device, generator=generator)
        _add_encoder(self, in_channels, **kw)
        self.main_decoder = VNetDecoder(n_cls, dropout_generator, **kw)
        self.perturb_generator = perturb_generator
        _finish(self, hebb, dtype)

    def draw_perturbations(self, levels):
        """{kind: [draw per level]} for one training forward."""
        return {kind: [draw_perturbation(kind, f, self.perturb_generator)
                       for f in levels] for kind in CCT_PERTURB_KINDS}

    def forward(self, x):
        levels = _encode(self, x)
        if not self.training:
            main = self.main_decoder(levels)
            return main, main, main, main
        draws = self.draw_perturbations(levels)
        return cct_aux_outputs(
            levels, lambda kind: perturb_features(levels, kind,
                                                  draws=draws[kind]),
            self.main_decoder)


class VNetDTC(nn.Module):
    """The VNet trunk with two OutputTransition heads: a tanh
    signed-distance head ``out_sdf`` and the segmentation head
    ``out_seg``; returns (sdf, seg)."""

    def __init__(self, in_channels: int, n_cls: int,
                 hebb: Optional[HebbSpec] = None, init_type: str = "kaiming",
                 device=None, generator=None, dropout_generator=None,
                 dtype=None):
        super().__init__()
        kw = dict(init_type=init_type, device=device, generator=generator)
        _add_encoder(self, in_channels, **kw)
        _add_decoder(self, dropout_generator, **kw)
        self.out_sdf = OutputTransition(32, n_cls, **kw)
        self.out_seg = OutputTransition(32, n_cls, **kw)
        _finish(self, hebb, dtype)

    def forward(self, x):
        dec = _decode(self, _encode(self, x))
        return torch.tanh(self.out_sdf(dec)), self.out_seg(dec)
