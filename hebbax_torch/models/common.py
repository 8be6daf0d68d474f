"""Shared model ops (``hebbax/models/common.py``), channels-first: flax's
lecun-normal init, 2D and 3D pooling, the align_corners bilinear /
trilinear and floor-indexed nearest resizes, instance norm,
flax-semantics batch norm (2D and 3D), channel-wise 3D dropout, and the
CCT feature perturbations (any rank).

Each perturbation is split in two: ``draw_perturbation`` takes its random
draw from an explicit ``torch.Generator``, and ``feature_noise`` /
``feature_dropout_elementwise`` / ``feature_dropout_attention`` apply a
given draw, so a caller can pass draws in as tensors (the tests pass
hebbax's ``jax.random`` draws).

:func:`remat_policy` and :func:`checkpointed` recompute a CCT shared
decoder in the backward (hebbax's ``nn.remat``); the batch norms, Hebbian
convs and dropouts of a recomputed forward replay their first run
(:mod:`hebbax_torch.utils.remat`).
"""

import functools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops.dropout import Dropout
from ..parallel import batch_var_mean, draw_rows
from ..utils import remat

CCT_PERTURB_KINDS = ("noise", "dropout", "feature_dropout")
CCT_DROPOUT_P = 0.3             # element dropout rate
CCT_NOISE_RANGE = 0.3           # multiplicative noise ~ U(-r, r)
CCT_FRAC_RANGE = (0.7, 0.9)     # attention threshold fraction ~ U(lo, hi)


_CONV_OPS = (torch.ops.aten.convolution.default,)


def _save_convs(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _CONV_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_policy(name):
    """The recompute policy of a rematted CCT shared decoder
    (``hebbax/models/common.py`` ``remat_policy``), as the ``context_fn``
    of ``torch.utils.checkpoint.checkpoint``.

    ``None``: full recompute — only the region's inputs are stored and the
    whole decoder runs again in the backward (returns None: checkpoint's
    default).  ``"convs"``: every convolution's output (``aten.convolution``,
    transpose convs included) is saved, so the backward recomputes only
    the elementwise tail (batch norm, activation, add, concat, resize).
    The gradients are the same either way."""
    if name is None:
        return None
    if name == "convs":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _save_convs)
    raise ValueError(f"unknown remat policy {name!r}")


def checkpointed(fn, policy=None):
    """``fn`` recomputed in the backward under :func:`remat_policy`
    ``policy`` (non-reentrant ``torch.utils.checkpoint``).  Each call gets
    a :class:`~hebbax_torch.utils.remat.Tape`, so its recomputation
    replays the first run's batch statistics and dropout masks, moves no
    running statistics, records no Hebbian delta and makes no
    collective call."""
    context_fn = remat_policy(policy)
    kw = {} if context_fn is None else {"context_fn": context_fn}

    def run(*args):
        tape = remat.Tape()

        def body(*a):
            with tape.run():
                return fn(*a)
        return checkpoint(body, *args, use_reentrant=False, **kw)
    return run


# std of a unit normal truncated to [-2, 2]: flax divides by it so the
# truncated draw keeps the variance asked for
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight, fan_in, generator=None):
    """flax's default kernel init into ``weight``: a normal truncated at 2
    standard deviations, variance 1/fan_in, drawn on the CPU from
    ``generator``."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    w = torch.empty(weight.shape)
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    with torch.no_grad():
        weight.copy_(w)
    return weight


def max_pool(x):
    """MaxPool2d / MaxPool3d(kernel_size=2) over the 2 or 3 spatial dims."""
    if min(x.shape[2:]) < 2:
        raise ValueError(
            f"max_pool collapses a spatial dim of {tuple(x.shape)} to "
            f"zero — 4-level UNets need >= 16 px per axis")
    return (F.max_pool3d if x.dim() == 5 else F.max_pool2d)(x, 2)


def _linear_interp_matrix(n_in, n_out):
    """(n_out, n_in) float32 matrix of 1-D linear interpolation with
    align_corners=True (hebbax's ``_linear_interp_matrix``)."""
    m = torch.zeros((n_out, n_in), dtype=torch.float32)
    if n_in == 1 or n_out == 1:
        m[:, 0] = 1.0
        return m
    pos = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    lo = np.minimum(np.floor(pos).astype(np.int64), n_in - 2)
    w = torch.from_numpy((pos - lo).astype(np.float32))
    rows, lo = torch.arange(n_out), torch.from_numpy(lo)
    m[rows, lo] = 1.0 - w
    m[rows, lo + 1] = w
    return m


def resize_linear_align_corners(x, out_spatial):
    """Bilinear (4-D input) or trilinear (5-D) resize with
    align_corners=True (torch Upsample parity).  A float32 input takes
    ``F.interpolate``; another dtype (bfloat16) resizes one axis at a time
    as a matmul with the interpolation matrix cast to x's dtype, as hebbax
    does, so the weights and every axis's result round to the dtype."""
    if tuple(x.shape[2:]) == tuple(out_spatial):
        return x
    if x.dtype == torch.float32:
        return F.interpolate(x, size=tuple(out_spatial),
                             mode="trilinear" if x.dim() == 5
                             else "bilinear", align_corners=True)
    for d, n_out in enumerate(out_spatial):
        axis = 2 + d
        n_in = x.shape[axis]
        if n_in == n_out:
            continue
        m = _linear_interp_matrix(n_in, n_out).to(x.dtype).to(x.device)
        x = torch.movedim(torch.matmul(torch.movedim(x, axis, -1), m.T),
                          -1, axis)
    return x


def instance_norm(x, eps=1e-5):
    """torch InstanceNorm2d / 3d defaults: per sample and channel over the
    spatial dims, biased variance, no affine, no running statistics.  As
    ``jnp.mean`` / ``jnp.var`` do in hebbax's ``instance_norm``, a
    bfloat16 input's mean and variance are reduced in float32 and rounded
    to bfloat16, and the normalization runs in bfloat16."""
    var, mean = torch.var_mean(
        x.to(torch.promote_types(x.dtype, torch.float32)),
        dim=tuple(range(2, x.dim())), unbiased=False, keepdim=True)
    mean, var = mean.to(x.dtype), var.to(x.dtype)
    return (x - mean) * torch.rsqrt(var + eps)


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
    (N, C, *spatial): ``noise`` one (C, *spatial) tensor shared across the
    batch,
    ``dropout`` an elementwise boolean keep mask, ``feature_dropout`` one
    scalar fraction."""
    if kind == "noise":
        return torch.empty(x.shape[1:], dtype=x.dtype,
                           device=x.device).uniform_(
            -CCT_NOISE_RANGE, CCT_NOISE_RANGE, generator=generator)
    if kind == "dropout":
        # the global batch's mask under data parallelism, this rank's rows
        return draw_rows(lambda shape: torch.empty(
            shape, dtype=x.dtype, device=x.device).bernoulli_(
            1.0 - CCT_DROPOUT_P, generator=generator).bool(), x.shape)
    if kind == "feature_dropout":
        return torch.empty((), dtype=x.dtype, device=x.device).uniform_(
            *CCT_FRAC_RANGE, generator=generator)
    raise ValueError(f"unknown CCT perturbation {kind!r}")


def feature_dropout_elementwise(x, keep, p=CCT_DROPOUT_P):
    """Functional dropout with the drawn keep mask."""
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def feature_noise(x, noise):
    """x * noise + x, the (C, *spatial) noise shared across the batch."""
    return x * noise[None] + x


def feature_dropout_attention(x, frac):
    """Zero the positions whose channel-mean activation reaches ``frac``
    of its per-sample maximum."""
    attention = torch.mean(x, dim=1, keepdim=True)
    max_val = torch.amax(attention.reshape(x.shape[0], -1), dim=1)
    threshold = (max_val * frac).reshape((-1,) + (1,) * (x.dim() - 1))
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
    perturbation kind, in ``CCT_PERTURB_KINDS`` order; the perturbations
    are drawn first, in that order.

    perturb_one(kind) -> the perturbed list of levels; decode(levels) ->
    logits.  ``batched=False``: four serial passes, so every batch norm of
    the shared decoder takes four momentum updates per training forward
    and every Hebbian site four deltas.  ``batched=True`` (hebbax's
    ``*_batched`` networks): each level's clean and 3 perturbed copies
    concatenated on the batch axis, ONE decode of 4N, sliced back into 4:
    a training forward's batch statistics are those of the 4N batch (one
    momentum update, one delta per site); exact in eval, which has no
    perturbed pass."""
    pert = [perturb_one(kind) for kind in CCT_PERTURB_KINDS]
    if not batched:
        return (decode(clean_levels), *[decode(p) for p in pert])
    n = clean_levels[0].shape[0]
    out = decode([torch.cat([c] + [p[lv] for p in pert])
                  for lv, c in enumerate(clean_levels)])
    return tuple(out[i * n:(i + 1) * n] for i in range(4))


class Dropout3d(Dropout):
    """torch ``Dropout3d``: one keep bit per (sample, channel), drawn from
    the caller's generator, the kept channels scaled by 1/(1-p) (hebbax's
    ``nn.Dropout(p, broadcast_dims=(1, 2, 3))``).  Its stream differs from
    hebbax's, as :class:`~hebbax_torch.ops.dropout.Dropout`'s does."""

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = remat.stash(lambda: draw_rows(lambda shape: torch.empty(
            shape, dtype=x.dtype, device=x.device).bernoulli_(
            1.0 - self.p, generator=self.generator),
            x.shape[:2] + (1,) * (x.dim() - 2)))
        return x * keep * (1.0 / (1.0 - self.p))


class BatchNorm2d(nn.Module):
    """Batch norm with flax ``nn.BatchNorm`` semantics and torch defaults,
    over the channel dim 1 of a 4-D (or, in :class:`BatchNorm3d`, 5-D)
    input.

    eps 1e-5; running statistics move by 0.1 per training forward (flax
    momentum 0.9); ``running_var`` takes the BIASED batch variance, as
    flax does (stock ``nn.BatchNorm2d`` takes the unbiased one); the scale
    initialises to N(1, 0.02) (the reference's 2D init_weights), drawn on
    the CPU from ``generator``.  A subclass may set ``gain_init = None``
    (scale ones), another ``eps``, or ``use_bias = False`` (a scale-only
    norm: flax's ``use_bias=False``, no ``bias`` entry).

    As flax's (``force_float32_reductions``), the batch statistics and the
    normalization are computed in float32 whatever x's dtype, and only
    the result is cast: to ``compute_dtype`` when set (flax's ``dtype=``),
    else to the promotion of x's dtype with float32.

    Under data parallelism the batch statistics are the global batch's
    (:func:`hebbax_torch.parallel.batch_var_mean`, differentiable), as
    flax's under SPMD, so the running statistics move alike on every rank.
    In a recomputed forward (:func:`checkpointed`) the batch statistics
    are the first run's, to the bit, and the running ones do not move.
    """

    eps = 1e-5
    momentum = 0.1
    gain_init = 0.02
    use_bias = True
    compute_dtype = None

    def __init__(self, features: int, device=None, generator=None):
        super().__init__()
        if self.gain_init is None:
            scale = torch.ones(features)
        else:
            scale = 1.0 + self.gain_init * torch.randn(features,
                                                       generator=generator)
        self.weight = nn.Parameter(scale.to(device))
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if self.use_bias else None)
        self.register_buffer("running_mean",
                             torch.zeros(features, device=device))
        self.register_buffer("running_var",
                             torch.ones(features, device=device))

    def forward(self, x):
        # float32 at least (a float64 input stays float64)
        wide = torch.promote_types(x.dtype, torch.float32)
        out_dtype = self.compute_dtype or wide
        x = x.to(wide)
        if not self.training:
            y = F.batch_norm(x, self.running_mean, self.running_var,
                             self.weight, self.bias, False, 0.0, self.eps)
            return y.to(out_dtype)
        # over the global batch under data parallelism; a recomputed
        # forward takes its first run's statistics and leaves the running
        # ones alone
        var, mean = batch_var_mean(x, (0,) + tuple(range(2, x.dim())))
        var, mean = remat.pin(var), remat.pin(mean)
        if not remat.replaying():
            with torch.no_grad(), remat.untracked():
                self.running_mean.lerp_(mean.detach(), self.momentum)
                self.running_var.lerp_(var.detach(), self.momentum)
        inv = torch.rsqrt(var + self.eps)
        view = (1, -1) + (1,) * (x.dim() - 2)
        y = (x - mean.view(view)) * (inv * self.weight).view(view)
        y = y if self.bias is None else y + self.bias.view(view)
        return y.to(out_dtype)


class BatchNorm3d(BatchNorm2d):
    """:class:`BatchNorm2d`'s semantics over a 5-D input, with the scale
    initialised to ones: torch ``BatchNorm3d`` keeps its default, since the
    reference's init_weights rescales only ``BatchNorm2d``."""

    gain_init = None
