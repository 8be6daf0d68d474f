"""Segmentation and consistency losses (``hebbax/ops/losses.py``),
channels-first logits ``(N, C, *spatial)`` (2D or 3D) and integer masks
``(N, *spatial)`` with ``ignore_index=-1`` marking invalid pixels.  The
segmentation losses upcast the logits and reduce in float32, as hebbax's
do; the consistency losses keep the logits' dtype.

Under data parallelism (:mod:`hebbax_torch.parallel`) every denominator is
the global batch's, as hebbax's under SPMD: a rank's partial sums go
through :func:`~hebbax_torch.parallel.gsum`, so each rank holds the global
loss (Sigma w for :func:`weighted_mean`, the effective sample count for
dice, the valid pixels for CE / BCE / bcebound).  A per-rank mean
followed by averaged gradients would be wrong whenever the ranks' valid
counts differ, as padding makes them."""

import math

import torch
import torch.nn.functional as F

from ..parallel import gmean, gsum


def weighted_mean(x, w=None):
    """Mean of ``x`` over all elements, with optional per-sample weights
    ``w`` (N,): with a 0/1 validity vector it is the mean over the valid
    samples only."""
    if w is None:
        return gmean(x)
    wb = w.reshape((-1,) + (1,) * (x.dim() - 1))
    denom = gsum(torch.sum(w)) * float(math.prod(x.shape[1:]))
    return gsum(torch.sum(x * wb)) / torch.clamp(denom, min=1.0)


def softmax_mse_loss(input_logits, target_logits):
    """Elementwise squared difference of the channel softmaxes; no
    gradient flows into the target."""
    a = torch.softmax(input_logits, dim=1)
    b = torch.softmax(target_logits, dim=1).detach()
    return (a - b) ** 2


def entropy_loss(probs, num_classes=2, weight=None):
    """Mean pixel entropy of a softmax map (channel axis 1), normalized by
    log(C)."""
    ent = -torch.sum(probs * torch.log(probs + 1e-6), dim=1)
    return weighted_mean(ent, weight) / math.log(num_classes)


def _one_hot_valid(target, num_classes, ignore_index=-1):
    valid = (target != ignore_index).float()
    onehot = F.one_hot(target.clamp(min=0).long(), num_classes)
    return onehot.movedim(-1, 1).float(), valid


def dice_loss(logits, target, num_classes=None, smooth=1.0, p=2,
              ignore_index=-1):
    """Soft multi-class dice with smooth=1, p=2, batch-mean reduction over
    samples that have at least one valid pixel."""
    if num_classes is None:
        num_classes = logits.shape[1]
    logits = logits.float()
    probs = torch.softmax(logits, dim=1)
    onehot, valid = _one_hot_valid(target, num_classes, ignore_index)
    n = logits.shape[0]
    probs = probs.reshape(n, num_classes, -1)
    onehot = onehot.reshape(n, num_classes, -1)
    valid = valid.reshape(n, 1, -1)
    num = 2.0 * torch.sum(probs * onehot * valid, dim=2) + smooth
    den = torch.sum((probs ** p + onehot ** p) * valid, dim=2) + smooth
    sample_valid = (torch.sum(valid, dim=2) > 0).float()      # (N, 1)
    n_eff = torch.clamp(gsum(torch.sum(sample_valid)), min=1.0)
    per_class = gsum(torch.sum((1.0 - num / den) * sample_valid,
                               dim=0)) / n_eff
    return torch.mean(per_class)


def cross_entropy_loss(logits, target, ignore_index=-1):
    """Pixel-mean CE over valid pixels (ignore_index masked out)."""
    num_classes = logits.shape[1]
    valid = (target != ignore_index).float()
    logp = torch.log_softmax(logits.float(), dim=1)
    onehot, _ = _one_hot_valid(target, num_classes, ignore_index)
    nll = -torch.sum(onehot * logp, dim=1) * valid
    return gsum(torch.sum(nll)) / torch.clamp(gsum(torch.sum(valid)),
                                              min=1.0)


def kl_loss(mean, std):
    """|E[m^2]| + |E[s^2]| - |E[log s^2]| - 1 (VAE KL surrogate)."""
    return (gmean(mean * mean) + gmean(std * std)
            - gmean(torch.log(std * std)) - 1.0)


def elbo_metric(vae_outputs, targets, beta=1.0, weight=None):
    """MSE reconstruction + beta * KLD, the VAE pretraining objective; the
    KLD sums over the channel (latent) axis, dim 1, and averages over the
    batch and space.  weight: optional per-sample 0/1 validity vector."""
    mu, log_var = vae_outputs["mu"], vae_outputs["log_var"]
    reconstr_loss = weighted_mean((vae_outputs["reconstr"] - targets) ** 2,
                                  weight)
    kld = weighted_mean(
        -0.5 * torch.sum(1 + log_var - mu ** 2 - torch.exp(log_var), dim=1),
        weight)
    return reconstr_loss + beta * kld


def bce_loss(logits, target, ignore_index=-1):
    """Binary cross-entropy on sigmoid(logits) against a target of the
    same shape, over the valid elements (``target != ignore_index``), eps
    1e-7 inside the logs (hebbax's ``bce``)."""
    probs = torch.sigmoid(logits.float())
    valid = (target != ignore_index).float()
    t = torch.clamp(target.float(), min=0.0)
    eps = 1e-7
    bce = (t * torch.log(probs + eps)
           + (1 - t) * torch.log(1 - probs + eps)) * valid
    return -gsum(torch.sum(bce)) / torch.clamp(gsum(torch.sum(valid)),
                                               min=1.0)


def bce_bound_loss(logits, target, num_classes=2, ignore_index=-1):
    """Per-class BCE on the clipped softmax, each class's positive term
    weighted by log(V / (positives + 1)), V the valid pixels; the class
    mean (hebbax's ``bce_bound_loss``)."""
    probs = torch.softmax(logits.float(), dim=1)
    onehot, valid = _one_hot_valid(target, num_classes, ignore_index)
    n_valid = torch.clamp(gsum(torch.sum(valid)), min=1.0)
    losses = []
    for i in range(num_classes):
        p = torch.clamp(probs[:, i], 1e-3, 1 - 1e-3)
        t = onehot[:, i] * valid
        tt = torch.log(n_valid / (gsum(torch.sum(t)) + 1))
        bce = (tt * t * torch.log(p) + (1 - t) * torch.log(1 - p)) * valid
        losses.append(-gsum(torch.sum(bce)) / n_valid)
    return torch.mean(torch.stack(losses))


def aux_weighted(loss_fn, outputs, target, aux_weight):
    """The main output's loss + aux_weight * each auxiliary output's."""
    loss = loss_fn(outputs[0], target)
    for out in outputs[1:]:
        loss = loss + aux_weight * loss_fn(out, target)
    return loss


def segmentation_loss(loss="dice", aux=False, num_classes=None):
    """Loss factory (hebbax's ``segmentation_loss``): dice, cross-entropy,
    bce or bcebound; ``aux`` adds the auxiliary outputs at weight 0.4
    (0.2 for cross-entropy)."""
    if loss in ("dice", "DICE"):
        base, aw = dice_loss, 0.4
    elif loss in ("crossentropy", "CE"):
        base, aw = cross_entropy_loss, 0.2
    elif loss == "bce":
        base, aw = bce_loss, 0.4
    elif loss == "bcebound":
        def base(logits, target):
            return bce_bound_loss(logits, target, num_classes or 2)
        aw = 0.4
    else:
        raise ValueError(f"loss {loss!r} not supported")
    if aux:
        return lambda outputs, target: aux_weighted(base, outputs, target,
                                                    aw)
    return base
