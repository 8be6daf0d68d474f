"""Shared model ops (``hebbax/models/common.py``), channels-first: 2D and
3D pooling, the align_corners bilinear and floor-indexed nearest resizes,
flax-semantics batch norm (2D and 3D), and the CCT feature perturbations.

Each perturbation is split in two: ``draw_perturbation`` takes its random
draw from an explicit ``torch.Generator``, and ``feature_noise`` /
``feature_dropout_elementwise`` / ``feature_dropout_attention`` apply a
given draw, so a caller can pass draws in as tensors (the tests pass
hebbax's ``jax.random`` draws).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

CCT_PERTURB_KINDS = ("noise", "dropout", "feature_dropout")
CCT_DROPOUT_P = 0.3             # element dropout rate
CCT_NOISE_RANGE = 0.3           # multiplicative noise ~ U(-r, r)
CCT_FRAC_RANGE = (0.7, 0.9)     # attention threshold fraction ~ U(lo, hi)


def max_pool(x):
    """MaxPool2d / MaxPool3d(kernel_size=2) over the 2 or 3 spatial dims."""
    if min(x.shape[2:]) < 2:
        raise ValueError(
            f"max_pool collapses a spatial dim of {tuple(x.shape)} to "
            f"zero — 4-level UNets need >= 16 px per axis")
    return (F.max_pool3d if x.dim() == 5 else F.max_pool2d)(x, 2)


def resize_linear_align_corners(x, out_spatial):
    """Bilinear resize with align_corners=True (torch Upsample parity)."""
    if tuple(x.shape[2:]) == tuple(out_spatial):
        return x
    return F.interpolate(x, size=tuple(out_spatial), mode="bilinear",
                         align_corners=True)


def resize_nearest_torch(x, out_spatial):
    """Nearest resize with torch's floor indexing, src = floor(i*in/out),
    taken in integers (a repeat for whole multiples)."""
    for d, n_out in enumerate(out_spatial):
        axis = 2 + d
        n_in = x.shape[axis]
        if n_in == n_out:
            continue
        if n_out % n_in == 0:
            x = torch.repeat_interleave(x, n_out // n_in, dim=axis)
        else:
            idx = torch.arange(n_out, device=x.device) * n_in // n_out
            x = torch.index_select(x, axis, idx)
    return x


# -- CCT feature perturbations ---------------------------------------------

def draw_perturbation(kind, x, generator=None):
    """The random draw of one perturbation of the feature map ``x``
    (N, C, H, W): ``noise`` one (C, H, W) tensor shared across the batch,
    ``dropout`` an elementwise boolean keep mask, ``feature_dropout`` one
    scalar fraction."""
    if kind == "noise":
        return torch.empty(x.shape[1:], dtype=x.dtype,
                           device=x.device).uniform_(
            -CCT_NOISE_RANGE, CCT_NOISE_RANGE, generator=generator)
    if kind == "dropout":
        return torch.empty_like(x).bernoulli_(
            1.0 - CCT_DROPOUT_P, generator=generator).bool()
    if kind == "feature_dropout":
        return torch.empty((), dtype=x.dtype, device=x.device).uniform_(
            *CCT_FRAC_RANGE, generator=generator)
    raise ValueError(f"unknown CCT perturbation {kind!r}")


def feature_dropout_elementwise(x, keep, p=CCT_DROPOUT_P):
    """Functional dropout with the drawn keep mask."""
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def feature_noise(x, noise):
    """x * noise + x, the (C, H, W) noise shared across the batch."""
    return x * noise[None] + x


def feature_dropout_attention(x, frac):
    """Zero the positions whose channel-mean activation reaches ``frac``
    of its per-sample maximum."""
    attention = torch.mean(x, dim=1, keepdim=True)
    max_val = torch.amax(attention.reshape(x.shape[0], -1), dim=1)
    threshold = (max_val * frac).reshape(-1, 1, 1, 1)
    return x * (attention < threshold).to(x.dtype)


_PERTURB = {"noise": feature_noise, "dropout": feature_dropout_elementwise,
            "feature_dropout": feature_dropout_attention}


def perturb_features(feats, kind, generator=None, draws=None):
    """Apply one CCT perturbation to a list of feature maps, with
    ``draws`` (one per map) or fresh draws from ``generator``."""
    if draws is None:
        draws = [draw_perturbation(kind, f, generator) for f in feats]
    return [_PERTURB[kind](f, d) for f, d in zip(feats, draws)]


def cct_aux_outputs(clean_levels, perturb_one, decode, batched=False):
    """The CCT protocol: the clean decode, then one decode per
    perturbation kind, in ``CCT_PERTURB_KINDS`` order.

    perturb_one(kind) -> the perturbed list of levels; decode(levels) ->
    logits.  Four serial passes, so every batch norm of the shared decoder
    takes four momentum updates per training forward.  ``batched`` (one
    4N-batched decode, which changes training BN numerics) is a TPU
    variant that is not ported."""
    if batched:
        raise NotImplementedError(
            "the 4N-batched CCT decode (unet_cct_s2d_batched) is not "
            "ported yet")
    pert = [perturb_one(kind) for kind in CCT_PERTURB_KINDS]
    return (decode(clean_levels), *[decode(p) for p in pert])


class BatchNorm2d(nn.Module):
    """Batch norm with flax ``nn.BatchNorm`` semantics and torch defaults,
    over the channel dim 1 of a 4-D (or, in :class:`BatchNorm3d`, 5-D)
    input.

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
        if self.gain_init is None:
            scale = torch.ones(features)
        else:
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
        var, mean = torch.var_mean(x, dim=(0,) + tuple(range(2, x.dim())),
                                   unbiased=False)
        with torch.no_grad():
            self.running_mean.lerp_(mean.detach(), self.momentum)
            self.running_var.lerp_(var.detach(), self.momentum)
        inv = torch.rsqrt(var + self.eps)
        view = (1, -1) + (1,) * (x.dim() - 2)
        return ((x - mean.view(view)) * (inv * self.weight).view(view)
                + self.bias.view(view))


class BatchNorm3d(BatchNorm2d):
    """:class:`BatchNorm2d`'s semantics over a 5-D input, with the scale
    initialised to ones: torch ``BatchNorm3d`` keeps its default, since the
    reference's init_weights rescales only ``BatchNorm2d``."""

    gain_init = None
