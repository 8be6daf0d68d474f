"""Frozen ViT encoder + trainable transpose-conv decoder
(``hebbax/models/raddino.py``), NCHW.

* :class:`ViTEncoder`: ViT-B/14 (768 wide, 12 layers, 12 heads, CLS
  token, pre-LN, tanh-GELU MLP), 224^2 -> (B, 1 + 16*16, 768) tokens.
  Like hebbax's, its blocks have no LayerScale (DINOv2's do).
* :class:`RadDinoDecoder`: ConvT(768->256, k3, s1) ReLU BN ->
  ConvT(256->128, k3, s2) ReLU BN -> ConvT(128->64, k7, s3) ReLU BN ->
  nearest resize to out_size-2 -> ConvT(64->C, k3, s1), all VALID.
* :func:`load_hf_rad_dino_params`: the ``microsoft/rad-dino`` weights are
  not in the repository, so the encoder keeps its random init.

flax's numerics, kept here: LayerNorm eps 1e-6; ``nn.gelu`` is the tanh
approximation; attention is ``MultiHeadDotProductAttention``, whose
``query`` / ``key`` / ``value`` kernels are ``(dim, heads, head_dim)`` and
``out`` ``(heads, head_dim, dim)`` (stored here as ``(heads, head_dim,
dim)`` and ``(dim, heads, head_dim)``, output axes first), the query
scaled by 1/sqrt(head_dim) (``F.scaled_dot_product_attention``'s
default); batch norm scale initialised to ones, eps 1e-5.

flax's ``nn.ConvTranspose`` (``transpose_kernel=False``) is torch's
``conv_transpose2d`` with the kernel flipped spatially:
:class:`FlaxConvTranspose2d` holds torch's orientation and the bridge
flips the kernel when it crosses (its ``flax_flipped`` marks it).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import BatchNorm2d, lecun_normal_, resize_nearest_torch
from .ddpm import dense

LN_EPS = 1e-6


class DenseGeneral(nn.Module):
    """flax ``nn.DenseGeneral`` of the attention: ``split`` maps (..., dim)
    to (..., heads, head_dim) with a (heads, head_dim, dim) weight; else
    (..., heads, head_dim) to (..., dim) with a (dim, heads, head_dim)
    weight."""

    def __init__(self, dim, heads, split, device=None, generator=None):
        super().__init__()
        hd = dim // heads
        self.split = split
        shape = (heads, hd, dim) if split else (dim, heads, hd)
        self.weight = nn.Parameter(torch.empty(shape, device=device))
        lecun_normal_(self.weight, dim, generator)
        self.bias = nn.Parameter(torch.zeros(
            shape[:2] if split else (dim,), device=device))

    def forward(self, x):
        if self.split:
            return torch.einsum("bld,hkd->blhk", x, self.weight) + self.bias
        return torch.einsum("blhk,dhk->bld", x, self.weight) + self.bias


class Attention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (self-attention)."""

    def __init__(self, dim, heads, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.query = DenseGeneral(dim, heads, True, **kw)
        self.key = DenseGeneral(dim, heads, True, **kw)
        self.value = DenseGeneral(dim, heads, True, **kw)
        self.out = DenseGeneral(dim, heads, False, **kw)

    def forward(self, x):
        q, k, v = [m(x).transpose(1, 2) for m in
                   (self.query, self.key, self.value)]     # (B, H, L, hd)
        y = F.scaled_dot_product_attention(q, k, v)
        return self.out(y.transpose(1, 2))


class ViTBlock(nn.Module):
    """Pre-LN block: x + attn(LN(x)), then x + fc2(gelu(fc1(LN(x))))."""

    def __init__(self, dim=768, heads=12, mlp_ratio=4, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.attn = Attention(dim, heads, **kw)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS, device=device)
        self.fc1 = dense(dim, dim * mlp_ratio, **kw)
        self.fc2 = dense(dim * mlp_ratio, dim, **kw)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        y = self.fc2(F.gelu(self.fc1(self.norm2(x)), approximate="tanh"))
        return x + y


class ViTEncoder(nn.Module):
    """ViT-B/14: (B, 3, S, S) -> (B, 1 + (S/14)^2, dim) tokens."""

    def __init__(self, dim=768, depth=12, patch=14, heads=12,
                 image_size=224, in_channels=3, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.dim, self.depth, self.patch = dim, depth, patch
        grid = image_size // patch
        self.patch_embed = nn.Conv2d(in_channels, dim, patch, stride=patch,
                                     device=device)
        lecun_normal_(self.patch_embed.weight, in_channels * patch * patch,
                      generator)
        nn.init.zeros_(self.patch_embed.bias)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim, device=device))
        pos = torch.empty(1, grid * grid + 1, dim).normal_(
            0.0, 0.02, generator=generator)
        self.pos_embed = nn.Parameter(pos.to(device))
        for i in range(depth):
            setattr(self, f"block{i}", ViTBlock(dim, heads, **kw))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS, device=device)

    def forward(self, x):
        b = x.shape[0]
        x = self.patch_embed(x).flatten(2).transpose(1, 2)   # (B, g*g, C)
        x = torch.cat([self.cls_token.expand(b, -1, -1), x], 1)
        x = x + self.pos_embed
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        return self.norm(x)


def reshape_patch_embeddings(tokens, image_size=224, patch_size=14):
    """Drop CLS; tokens -> the (B, C, g, g) grid."""
    g = image_size // patch_size
    t = tokens[:, 1:]
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[-1], g, g)


class FlaxConvTranspose2d(nn.Module):
    """flax ``nn.ConvTranspose(padding='VALID')`` with bias: output side
    (n - 1) * stride + k.  The weight is torch's ``(I, O, kh, kw)`` in
    torch's orientation, i.e. flax's kernel flipped spatially; the bridge
    flips it when it crosses (``flax_flipped``)."""

    flax_flipped = True

    def __init__(self, in_ch, out_ch, k, stride, device=None,
                 generator=None):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, k, k,
                                               device=device))
        # flax's fan-in of a (kh, kw, I, O) transpose kernel is I*kh*kw
        lecun_normal_(self.weight, in_ch * k * k, generator)
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device))

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight, self.bias,
                                  stride=self.stride)


class FlaxBatchNorm2d(BatchNorm2d):
    """flax ``nn.BatchNorm(momentum=0.9)``: scale ones, eps 1e-5."""

    gain_init = None


class RadDinoDecoder(nn.Module):
    """The decoder over the (B, dim, g, g) patch grid; ``out_size`` is the
    final side (224 in the sweep; the nearest resize goes to out_size-2
    so the VALID k3 out conv lands on out_size)."""

    def __init__(self, n_cls: int, out_size: int = 224, dim: int = 768,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.out_size = out_size
        self.deconv1 = FlaxConvTranspose2d(dim, 256, 3, 1, **kw)
        self.bn1 = FlaxBatchNorm2d(256, device=device)
        self.deconv2 = FlaxConvTranspose2d(256, 128, 3, 2, **kw)
        self.bn2 = FlaxBatchNorm2d(128, device=device)
        self.deconv3 = FlaxConvTranspose2d(128, 64, 7, 3, **kw)
        self.bn3 = FlaxBatchNorm2d(64, device=device)
        self.out = FlaxConvTranspose2d(64, max(n_cls, 2), 3, 1, **kw)

    def forward(self, x):
        x = self.bn1(F.relu(self.deconv1(x)))
        x = self.bn2(F.relu(self.deconv2(x)))
        x = self.bn3(F.relu(self.deconv3(x)))
        x = resize_nearest_torch(x, (self.out_size - 2, self.out_size - 2))
        return self.out(x)


OFFLINE_WARNING = (
    "WARNING: microsoft/rad-dino weights unavailable (offline?) — the "
    "frozen ViT encoder runs with RANDOM init; decoder metrics will not be "
    "comparable to the reference's pretrained-encoder results")


def load_hf_rad_dino_params(encoder):
    """The HF ``microsoft/rad-dino`` weights are not in the repository, so
    ``encoder`` keeps its random init: returns ``(encoder, False)``."""
    return encoder, False
