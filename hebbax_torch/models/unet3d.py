"""3D UNet family (``hebbax/models/unet3d.py`` ``UNet3D``, ``UNet3DDTC``,
``UNet3DCCT``), NCDHW, with the same module names as hebbax so the
parameter map to the flax tree is mechanical.

Classic 3D U-Net: double conv3-BN-ReLU blocks, maxpool2 downs,
ConvTranspose3d(k=2, s=2) ups with the skip concatenated as ``[up, skip]``,
a 1x1x1 head ``conv``; init_features=64 (a 1024-channel bottleneck) for
``unet3d``, 32 for ``unet3d_min``.  It has 22 Hebbian sites: 18 3x3x3
convs and the 4 transpose convs (the head is the pretraining's exclude).

The variants share the encoder and decoder and differ in their heads:
UNet3DDTC adds a tanh signed-distance head ``out_sdf`` beside the
segmentation head ``out_seg``; UNet3DCCT runs one shared ``main_decoder``
and head on the clean encoder levels and on three perturbed copies.

Every conv is an HConv / HConvTranspose; a HebbSpec passed to the model
makes the non-excluded ones Hebbian.  ``generator`` (CPU) draws the
initial parameters, so a seed gives the same model on every device;
``perturb_generator`` (on the model's device) UNet3DCCT's perturbations,
``latent_generator`` UNet3DVAE's latent.

The unsupervised baselines: UNet3DVAE puts 1x1x1 ``mu`` / ``var`` on the
bottleneck and decodes the reparameterized latent into a segmentation head
``conv`` and a reconstruction head ``reconstr``; UNet3DSuperpix adds a
2-class head ``out_superpix`` beside ``conv``.
"""

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..hebb.layers import HConv, HConvTranspose, bind_paths, set_compute_dtype
from ..hebb.spec import HebbSpec
from ..parallel import draw_rows
from .common import (CCT_PERTURB_KINDS, BatchNorm3d, cct_aux_outputs,
                     checkpointed, draw_perturbation, max_pool,
                     perturb_features)


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
                 dropout_generator=None, dtype=None):
        super().__init__()
        del dropout_generator           # no dropout in this network
        kw = dict(init_type=init_type, device=device, generator=generator)
        self.encoder = Encoder3D(in_channels, init_features, **kw)
        self.decoder = Decoder3D(init_features, **kw)
        self.conv = HConv(init_features, n_cls, kernel_size=(1, 1, 1), **kw)
        self.hebb = hebb
        bind_paths(self, hebb)
        set_compute_dtype(self, dtype)

    def forward(self, x):
        feats, bottleneck = self.encoder(x)
        return self.conv(self.decoder(bottleneck, feats))


class UNet3DDTC(nn.Module):
    """Dual-task heads over the shared trunk: a tanh signed-distance head
    ``out_sdf`` and the segmentation head ``out_seg``; returns
    (sdf, seg)."""

    def __init__(self, in_channels: int, n_cls: int,
                 init_features: int = 64, hebb: Optional[HebbSpec] = None,
                 init_type: str = "kaiming", device=None, generator=None,
                 dropout_generator=None, dtype=None):
        super().__init__()
        del dropout_generator           # no dropout in this network
        kw = dict(init_type=init_type, device=device, generator=generator)
        self.encoder = Encoder3D(in_channels, init_features, **kw)
        self.decoder = Decoder3D(init_features, **kw)
        hk = dict(kernel_size=(1, 1, 1), **kw)
        self.out_sdf = HConv(init_features, n_cls, **hk)
        self.out_seg = HConv(init_features, n_cls, **hk)
        self.hebb = hebb
        bind_paths(self, hebb)
        set_compute_dtype(self, dtype)

    def forward(self, x):
        feats, bottleneck = self.encoder(x)
        dec = self.decoder(bottleneck, feats)
        return torch.tanh(self.out_sdf(dec)), self.out_seg(dec)


class UNet3DCCT(nn.Module):
    """One shared decoder (``main_decoder`` + the 1x1x1 head ``conv``) run
    on the clean encoder levels and on 3 perturbed copies (noise, dropout,
    feature dropout) of all five levels, the bottleneck included.  Returns
    (main, aux1, aux2, aux3).

    A training forward always perturbs, drawing from ``perturb_generator``
    through :meth:`draw_perturbations` (an instance may replace that
    method to inject draws).  An eval forward skips the perturbed passes
    and returns the main output four times: only the primary output is
    read in eval.  Four serial decoder passes per training forward, so
    every batch norm of the shared decoder takes four momentum updates.

    ``batched_aux`` (hebbax's ``*_batched`` names): one 4N-batched decoder
    pass instead (:func:`~hebbax_torch.models.common.cct_aux_outputs`).
    ``remat`` (the ``*_rc`` names): ``main_decoder`` is recomputed in the
    backward under :func:`~hebbax_torch.models.common.remat_policy`
    ``remat_policy``, with the grads, outputs and statistics unchanged.
    hebbax remats every folded CCT network (fully, unless ``"convs"``) to
    fit a 16 GB TPU; the port's plain names keep everything.
    """

    def __init__(self, in_channels: int, n_cls: int,
                 init_features: int = 64, hebb: Optional[HebbSpec] = None,
                 init_type: str = "kaiming", device=None, generator=None,
                 dropout_generator=None, perturb_generator=None, dtype=None,
                 batched_aux: bool = False, remat: bool = False,
                 remat_policy: Optional[str] = None):
        super().__init__()
        del dropout_generator           # no dropout in this network
        kw = dict(init_type=init_type, device=device, generator=generator)
        self.encoder = Encoder3D(in_channels, init_features, **kw)
        self.main_decoder = Decoder3D(init_features, **kw)
        self.conv = HConv(init_features, n_cls, kernel_size=(1, 1, 1), **kw)
        self.perturb_generator = perturb_generator
        self.batched_aux = batched_aux
        self.remat = remat
        self.remat_policy = remat_policy
        self.hebb = hebb
        bind_paths(self, hebb)
        set_compute_dtype(self, dtype)

    def decode(self, levels):
        """levels: the four skip features, then the bottleneck."""
        decoder = (checkpointed(self.main_decoder, self.remat_policy)
                   if self.remat else self.main_decoder)
        return self.conv(decoder(levels[-1], levels[:4]))

    def draw_perturbations(self, levels):
        """{kind: [draw per level]} for one training forward."""
        return {kind: [draw_perturbation(kind, f, self.perturb_generator)
                       for f in levels] for kind in CCT_PERTURB_KINDS}

    def forward(self, x):
        feats, bottleneck = self.encoder(x)
        levels = feats + [bottleneck]
        if not self.training:
            main = self.decode(levels)
            return main, main, main, main
        draws = self.draw_perturbations(levels)
        return cct_aux_outputs(
            levels, lambda kind: perturb_features(levels, kind,
                                                  draws=draws[kind]),
            self.decode, self.batched_aux)


class UNet3DVAE(nn.Module):
    """1x1x1 ``mu`` / ``var`` (16f -> 16f) on the bottleneck, the
    reparameterized latent ``eps * exp(0.5 * log_var) + mu`` into the
    decoder in place of the bottleneck, then the 1x1x1 heads ``conv``
    (segmentation) and ``reconstr`` (in_channels).  Returns {'output',
    'mu', 'log_var', 'reconstr'}.

    eps is drawn from ``latent_generator`` on every forward, eval
    included, through :meth:`draw_latent` (an instance may replace it, or
    a caller pass ``eps``); without a generator eps is 0, as hebbax's is
    without a ``latent`` rng.
    """

    def __init__(self, in_channels: int, n_cls: int,
                 init_features: int = 64, hebb: Optional[HebbSpec] = None,
                 init_type: str = "kaiming", device=None, generator=None,
                 dropout_generator=None, latent_generator=None, dtype=None):
        super().__init__()
        del dropout_generator           # no dropout in this network
        kw = dict(init_type=init_type, device=device, generator=generator)
        f = init_features
        hk = dict(kernel_size=(1, 1, 1), **kw)
        self.encoder = Encoder3D(in_channels, f, **kw)
        self.mu = HConv(f * 16, f * 16, **hk)
        self.var = HConv(f * 16, f * 16, **hk)
        self.decoder = Decoder3D(f, **kw)
        self.conv = HConv(f, n_cls, **hk)
        self.reconstr = HConv(f, in_channels, **hk)
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
        feats, bottleneck = self.encoder(x)
        mu = self.mu(bottleneck)
        log_var = self.var(bottleneck)
        std = torch.exp(0.5 * log_var)
        if eps is None:
            eps = self.draw_latent(std)
        dec = self.decoder(eps * std + mu, feats)
        return {"output": self.conv(dec), "mu": mu, "log_var": log_var,
                "reconstr": self.reconstr(dec)}


class UNet3DSuperpix(nn.Module):
    """UNet3D with a 2-class 1x1x1 head ``out_superpix`` beside the
    segmentation head ``conv``; returns (seg, superpix)."""

    def __init__(self, in_channels: int, n_cls: int,
                 init_features: int = 64, hebb: Optional[HebbSpec] = None,
                 init_type: str = "kaiming", device=None, generator=None,
                 dropout_generator=None, dtype=None):
        super().__init__()
        del dropout_generator           # no dropout in this network
        kw = dict(init_type=init_type, device=device, generator=generator)
        hk = dict(kernel_size=(1, 1, 1), **kw)
        self.encoder = Encoder3D(in_channels, init_features, **kw)
        self.decoder = Decoder3D(init_features, **kw)
        self.conv = HConv(init_features, n_cls, **hk)
        self.out_superpix = HConv(init_features, 2, **hk)
        self.hebb = hebb
        bind_paths(self, hebb)
        set_compute_dtype(self, dtype)

    def forward(self, x):
        feats, bottleneck = self.encoder(x)
        dec = self.decoder(bottleneck, feats)
        return self.conv(dec), self.out_superpix(dec)
