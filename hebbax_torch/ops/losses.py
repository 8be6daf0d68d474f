"""Segmentation and consistency losses (``hebbax/ops/losses.py``),
channels-first logits ``(N, C, H, W)`` and integer masks ``(N, H, W)``
with ``ignore_index=-1`` marking invalid pixels.  Losses reduce in
float32."""

import math

import torch
import torch.nn.functional as F


def weighted_mean(x, w=None):
    """Mean of ``x`` over all elements, with optional per-sample weights
    ``w`` (N,): with a 0/1 validity vector it is the mean over the valid
    samples only."""
    if w is None:
        return torch.mean(x)
    wb = w.reshape((-1,) + (1,) * (x.dim() - 1))
    denom = torch.sum(w) * float(math.prod(x.shape[1:]))
    return torch.sum(x * wb) / torch.clamp(denom, min=1.0)


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
    return onehot.permute(0, 3, 1, 2).float(), valid


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
    n_eff = torch.clamp(torch.sum(sample_valid), min=1.0)
    per_class = torch.sum((1.0 - num / den) * sample_valid, dim=0) / n_eff
    return torch.mean(per_class)


def cross_entropy_loss(logits, target, ignore_index=-1):
    """Pixel-mean CE over valid pixels (ignore_index masked out)."""
    num_classes = logits.shape[1]
    valid = (target != ignore_index).float()
    logp = torch.log_softmax(logits.float(), dim=1)
    onehot, _ = _one_hot_valid(target, num_classes, ignore_index)
    nll = -torch.sum(onehot * logp, dim=1) * valid
    return torch.sum(nll) / torch.clamp(torch.sum(valid), min=1.0)


def kl_loss(mean, std):
    """|E[m^2]| + |E[s^2]| - |E[log s^2]| - 1 (VAE KL surrogate)."""
    return (torch.mean(mean * mean) + torch.mean(std * std)
            - torch.mean(torch.log(std * std)) - 1.0)


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


def segmentation_loss(loss="dice"):
    """Loss factory: dice or cross-entropy (the aux-weighted variants wait
    for the multi-output networks)."""
    if loss in ("dice", "DICE"):
        return dice_loss
    if loss in ("crossentropy", "CE"):
        return cross_entropy_loss
    raise NotImplementedError(f"loss {loss!r} is not ported yet")
