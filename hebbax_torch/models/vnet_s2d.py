"""The space-to-depth folded V-Net family (``hebbax/models/vnet_s2d.py``),
NCDHW: ``vnet_s2d``, ``vnet_dtc_s2d`` and ``vnet_cct_s2d`` with its
``_batched`` / ``_rc`` variants.

The same math, parameter tree and snapshots as :mod:`.vnet`; the
full-resolution level runs on tensors folded at ``FOLD`` = (2, 2, 2)
(:mod:`..ops.s2d3d`; its 5^3 convs fold to trimmed 3^3 windows):

* in_tr on the folded input, the input tiled to 16 channels per subpixel
  block;
* down_tr32's k=2/s=2 down_conv CONSUMES the folded level-0 tensor (a
  dense matmul, :class:`~..hebb.layers.FoldedDownHConv3`) and its
  32-channel LUConv stack is refolded at half resolution;
* down_tr64 and up_tr64 fold only their LUConv stacks, at (2, 2, 1);
* up_tr32's transpose conv emits the folded layout, its concat and its
  stack stay in grouped (16, 16) order (the last conv emits that order,
  :func:`s2d3d.group_out_perm`), and out_tr reads it through
  ``in_groups``.

down_tr128 / 256 and up_tr256 / 128 are :mod:`.vnet`'s modules.  Modules
are built in the unfolded twin's order, the folded skip dropout draws
the twin's (N, C) keep mask, and CCT draws its perturbations on the
unfolded levels.
"""

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..hebb.layers import (FoldedDownHConv3, FoldedHConv3,
                           FoldedHConvTranspose3, HConv, HConvTranspose,
                           bind_paths, set_compute_dtype)
from ..hebb.spec import HebbSpec
from ..ops import s2d3d
from .common import (CCT_PERTURB_KINDS, BatchNorm3d, Dropout3d,
                     cct_aux_outputs, checkpointed, draw_perturbation,
                     perturb_features)
from .unet3d_s2d import FoldedBatchNorm3
from .urpc3d_s2d import FoldedDropout3d
from .vnet import DownTransition, UpTransition

FOLD = (2, 2, 2)
PF = 8
MID_FOLD = (2, 2, 1)


class FoldedLUConvStack(nn.Module):
    """:class:`~.vnet.LUConvStack` on folded tensors; the same parameters
    (conv{i} / bn{i}).  ``out_groups``: the last conv emits, and its BN
    reads, the grouped-concat order."""

    def __init__(self, features, n, in_groups, fold=FOLD, out_groups=None,
                 init_type="kaiming", device=None, generator=None):
        super().__init__()
        kw = dict(fold=fold, init_type=init_type, device=device,
                  generator=generator)
        pf = s2d3d.prodf(fold)
        self.n = n
        groups = tuple(in_groups)
        for i in range(n):
            og = out_groups if i == n - 1 else None
            setattr(self, f"conv{i + 1}", FoldedHConv3(
                groups, features, 5, out_groups=og, **kw))
            setattr(self, f"bn{i + 1}", FoldedBatchNorm3(
                features, pf, groups=og, device=device))
            groups = (features,)

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"conv{i + 1}")(x)
            x = F.elu(getattr(self, f"bn{i + 1}")(x))
        return x


class DownTransitionOpsFolded(nn.Module):
    """:class:`~.vnet.DownTransition` at a mid level with only its LUConv
    stack folded (at ``fold``)."""

    def __init__(self, in_features, out_features, n_convs, fold=MID_FOLD,
                 **kw):
        super().__init__()
        self.fold = tuple(fold)
        self.down_conv = HConv(in_features, out_features,
                               kernel_size=(2, 2, 2), stride=2, **kw)
        self.bn1 = BatchNorm3d(out_features, device=kw.get("device"))
        self.ops = FoldedLUConvStack(out_features, n_convs, (out_features,),
                                     fold, **kw)

    def forward(self, x):
        down = F.elu(self.bn1(self.down_conv(x)))
        out = self.ops(s2d3d.fold3(down, self.fold))
        return F.elu(s2d3d.unfold3(out, self.fold) + down)


class UpTransitionOpsFolded(nn.Module):
    """:class:`~.vnet.UpTransition` at a mid level with only its LUConv
    stack folded (at ``fold``)."""

    def __init__(self, in_features, out_features, n_convs,
                 dropout_generator=None, fold=MID_FOLD, **kw):
        super().__init__()
        self.fold = tuple(fold)
        self.drop = Dropout3d(0.5, dropout_generator)
        self.up_conv = HConvTranspose(in_features, out_features // 2,
                                      kernel_size=(2, 2, 2), stride=2, **kw)
        self.bn1 = BatchNorm3d(out_features // 2, device=kw.get("device"))
        self.ops = FoldedLUConvStack(out_features, n_convs, (out_features,),
                                     fold, **kw)

    def forward(self, x, skip):
        skip = self.drop(skip)
        up = F.elu(self.bn1(self.up_conv(x)))
        xcat = torch.cat([up, skip], dim=1)
        out = self.ops(s2d3d.fold3(xcat, self.fold))
        return F.elu(s2d3d.unfold3(out, self.fold) + xcat)


class FoldedInputTransition(nn.Module):
    """:class:`~.vnet.InputTransition` on the folded layout: takes the
    UNFOLDED input, returns the FOLDED 16-channel tensor."""

    def __init__(self, in_channels, **kw):
        super().__init__()
        self.conv1 = FoldedHConv3((in_channels,), 16, 5, FOLD, **kw)
        self.bn1 = FoldedBatchNorm3(16, PF, device=kw.get("device"))

    def forward(self, x):
        xf = s2d3d.fold3(x, FOLD)
        out = self.bn1(self.conv1(xf))
        n, c, sp = xf.shape[0], x.shape[1], tuple(xf.shape[2:])
        # the input tiled to 16 channels within each subpixel block
        x16 = xf.reshape((n, PF, c) + sp).repeat(
            (1, 1, 16 // c) + (1,) * len(sp)).reshape(out.shape)
        return F.elu(out + x16)


class DownTransitionFromFolded(nn.Module):
    """:class:`~.vnet.DownTransition` whose down_conv consumes the folded
    level-0 tensor; its LUConv stack runs refolded at half resolution.
    Returns the unfolded half-resolution tensor."""

    def __init__(self, in_features, out_features, n_convs, **kw):
        super().__init__()
        self.down_conv = FoldedDownHConv3((in_features,), out_features,
                                          FOLD, **kw)
        self.bn1 = BatchNorm3d(out_features, device=kw.get("device"))
        self.ops = FoldedLUConvStack(out_features, n_convs, (out_features,),
                                     FOLD, **kw)

    def forward(self, xf):
        down = F.elu(self.bn1(self.down_conv(xf)))
        downf = s2d3d.fold3(down, FOLD)
        return s2d3d.unfold3(F.elu(self.ops(downf) + downf), FOLD)


class UpTransitionFolded(nn.Module):
    """:class:`~.vnet.UpTransition` at full resolution: the skip arrives
    FOLDED (its channel dropout per original channel), the transpose conv
    emits the folded layout, and the concat, the stack and the output
    stay in grouped (out // 2, skip) order."""

    def __init__(self, in_features, out_features, n_convs,
                 dropout_generator=None, **kw):
        super().__init__()
        half = out_features // 2
        self.groups = (half, out_features - half)
        self.drop = FoldedDropout3d(0.5, dropout_generator)
        self.up_conv = FoldedHConvTranspose3(in_features, half, FOLD, **kw)
        self.bn1 = FoldedBatchNorm3(half, PF, device=kw.get("device"))
        self.ops = FoldedLUConvStack(out_features, n_convs, self.groups,
                                     FOLD, out_groups=self.groups, **kw)

    def forward(self, x, skip_f):
        skip_f = self.drop(skip_f)
        up = F.elu(self.bn1(self.up_conv(x)))
        xcat = torch.cat([up, skip_f], dim=1)
        return F.elu(self.ops(xcat) + xcat)


class OutputTransitionFolded(nn.Module):
    """:class:`~.vnet.OutputTransition` on a folded input in grouped
    ``in_groups`` order; returns UNFOLDED logits."""

    def __init__(self, in_groups, n_cls, **kw):
        super().__init__()
        self.conv1 = FoldedHConv3(in_groups, n_cls, 5, FOLD, **kw)
        self.bn1 = FoldedBatchNorm3(n_cls, PF, device=kw.get("device"))
        self.conv2 = FoldedHConv3((n_cls,), n_cls, 1, FOLD, **kw)

    def forward(self, xf):
        out = self.conv2(F.elu(self.bn1(self.conv1(xf))))
        return s2d3d.unfold3(out, FOLD)


def _add_encoder(owner, in_channels, **kw):
    owner.in_tr = FoldedInputTransition(in_channels, **kw)
    owner.down_tr32 = DownTransitionFromFolded(16, 32, 1, **kw)
    owner.down_tr64 = DownTransitionOpsFolded(32, 64, 2, **kw)
    owner.down_tr128 = DownTransition(64, 128, 3, **kw)
    owner.down_tr256 = DownTransition(128, 256, 2, **kw)


def _encode(owner, x):
    """[out256, out128, out64, out32, out16 FOLDED]."""
    out16f = owner.in_tr(x)
    out32 = owner.down_tr32(out16f)
    out64 = owner.down_tr64(out32)
    out128 = owner.down_tr128(out64)
    return [owner.down_tr256(out128), out128, out64, out32, out16f]


def _add_decoder(owner, dropout_generator, **kw):
    dk = dict(dropout_generator=dropout_generator, **kw)
    owner.up_tr256 = UpTransition(256, 256, 2, **dk)
    owner.up_tr128 = UpTransition(256, 128, 2, **dk)
    owner.up_tr64 = UpTransitionOpsFolded(128, 64, 1, **dk)
    owner.up_tr32 = UpTransitionFolded(64, 32, 1, **dk)


def _decode(owner, levels):
    """The UpTransitions: folded 32-channel features in grouped (16, 16)
    order."""
    out256, out128, out64, out32, out16f = levels
    out = owner.up_tr256(out256, out128)
    out = owner.up_tr128(out, out64)
    out = owner.up_tr64(out, out32)
    return owner.up_tr32(out, out16f)


def _finish(model, hebb, dtype):
    model.hebb = hebb
    bind_paths(model, hebb)
    set_compute_dtype(model, dtype)


GROUPS = (16, 16)


class VNetS2D(nn.Module):
    """``vnet_s2d``: :class:`~.vnet.VNet` with the full-resolution level
    folded."""

    def __init__(self, in_channels: int, n_cls: int,
                 hebb: Optional[HebbSpec] = None, init_type: str = "kaiming",
                 device=None, generator=None, dropout_generator=None,
                 dtype=None):
        super().__init__()
        kw = dict(init_type=init_type, device=device, generator=generator)
        _add_encoder(self, in_channels, **kw)
        _add_decoder(self, dropout_generator, **kw)
        self.out_tr = OutputTransitionFolded(GROUPS, n_cls, **kw)
        _finish(self, hebb, dtype)

    def forward(self, x):
        return self.out_tr(_decode(self, _encode(self, x)))


class VNetDecoderFolded(nn.Module):
    """The shared decode path of VNetCCTS2D: the four UpTransitions and
    ``out_tr``; takes out16 FOLDED, returns unfolded logits."""

    def __init__(self, n_cls, dropout_generator=None, **kw):
        super().__init__()
        _add_decoder(self, dropout_generator, **kw)
        self.out_tr = OutputTransitionFolded(GROUPS, n_cls, **kw)

    def forward(self, levels):
        return self.out_tr(_decode(self, levels))


class VNetCCTS2D(nn.Module):
    """``vnet_cct_s2d``: :class:`~.vnet.VNetCCT` with the full-resolution
    level folded.  The perturbations are drawn and applied on the
    UNFOLDED levels (out16 unfolded, perturbed, refolded).
    ``batched_aux`` and ``remat`` / ``remat_policy`` are VNetCCT's (the
    ``_batched`` and ``_rc`` names); the plain name recomputes nothing.
    Returns (main, aux1, aux2, aux3)."""

    def __init__(self, in_channels: int, n_cls: int,
                 hebb: Optional[HebbSpec] = None, init_type: str = "kaiming",
                 device=None, generator=None, dropout_generator=None,
                 perturb_generator=None, dtype=None,
                 batched_aux: bool = False, remat: bool = False,
                 remat_policy: Optional[str] = None):
        super().__init__()
        kw = dict(init_type=init_type, device=device, generator=generator)
        _add_encoder(self, in_channels, **kw)
        self.main_decoder = VNetDecoderFolded(n_cls, dropout_generator,
                                              **kw)
        self.perturb_generator = perturb_generator
        self.batched_aux = batched_aux
        self.remat = remat
        self.remat_policy = remat_policy
        _finish(self, hebb, dtype)

    def decode(self, levels):
        decoder = (checkpointed(self.main_decoder, self.remat_policy)
                   if self.remat else self.main_decoder)
        return decoder(levels)

    def draw_perturbations(self, levels):
        """{kind: [draw per UNFOLDED level]} for one training forward."""
        return {kind: [draw_perturbation(kind, f, self.perturb_generator)
                       for f in levels] for kind in CCT_PERTURB_KINDS}

    def forward(self, x):
        levels = _encode(self, x)
        if not self.training:
            main = self.main_decoder(levels)
            return main, main, main, main
        unfolded = levels[:4] + [s2d3d.unfold3(levels[4], FOLD)]
        draws = self.draw_perturbations(unfolded)

        def perturb_one(kind):
            p = perturb_features(unfolded, kind, draws=draws[kind])
            return p[:4] + [s2d3d.fold3(p[4], FOLD)]
        return cct_aux_outputs(levels, perturb_one, self.decode,
                               self.batched_aux)


class VNetDTCS2D(nn.Module):
    """``vnet_dtc_s2d``: :class:`~.vnet.VNetDTC` with the full-resolution
    level folded; the tanh SDF head ``out_sdf`` and the segmentation head
    ``out_seg``; returns (sdf, seg)."""

    def __init__(self, in_channels: int, n_cls: int,
                 hebb: Optional[HebbSpec] = None, init_type: str = "kaiming",
                 device=None, generator=None, dropout_generator=None,
                 dtype=None):
        super().__init__()
        kw = dict(init_type=init_type, device=device, generator=generator)
        _add_encoder(self, in_channels, **kw)
        _add_decoder(self, dropout_generator, **kw)
        self.out_sdf = OutputTransitionFolded(GROUPS, n_cls, **kw)
        self.out_seg = OutputTransitionFolded(GROUPS, n_cls, **kw)
        _finish(self, hebb, dtype)

    def forward(self, x):
        dec = _decode(self, _encode(self, x))
        return torch.tanh(self.out_sdf(dec)), self.out_seg(dec)
