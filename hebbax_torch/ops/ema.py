"""Exponential moving average of a model's parameters
(``hebbax/ops/ema.py``): ``alpha = min(1 - 1/(step+1), decay)``,
``ema = alpha*ema + (1-alpha)*param``.  Buffers (BN statistics) are not
averaged: the EMA model keeps the statistics of its own forwards."""

import torch


def update_ema(ema_model, model, decay, global_step):
    """Move ``ema_model``'s parameters towards ``model``'s, in place."""
    alpha = min(1.0 - 1.0 / (global_step + 1.0), decay)
    with torch.no_grad():
        for e, p in zip(ema_model.parameters(), model.parameters()):
            e.mul_(alpha).add_(p, alpha=1.0 - alpha)
    return ema_model
