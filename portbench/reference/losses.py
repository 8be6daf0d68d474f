"""Soft dice (smooth 1, squared terms, mean over the samples and the
classes) and the normalised entropy of a softmax map, in float32."""

import math

import torch
import torch.nn.functional as F


def dice(logits, target):
    c = logits.shape[1]
    p = torch.softmax(logits.float(), dim=1).flatten(2)
    t = F.one_hot(target.long(), c).movedim(-1, 1).float().flatten(2)
    num = 2.0 * (p * t).sum(2) + 1.0
    den = (p * p + t * t).sum(2) + 1.0
    return (1.0 - num / den).mean()


def entropy(logits):
    p = torch.softmax(logits, dim=1)
    ent = -(p * torch.log(p + 1e-6)).sum(1)
    return ent.mean() / math.log(logits.shape[1])
