"""Learning-rate schedule and optimizers (``hebbax/config/schedules.py``).

The reference steps ``GradualWarmupScheduler(StepLR)`` once per epoch; the
effective learning rate of 0-indexed epoch ``e`` is

    lr(e) = base * e / warmup                         for e <= warmup
    lr(e) = base * gamma ** ((e - warmup - 1) // step)  for e >  warmup

so epoch 0 trains at lr 0 (a scheduler-priming artifact kept for parity).
hebbax derives the epoch from the optimizer step count
(``count // steps_per_epoch``); :class:`WarmupStepLR` does the same and the
train step writes the value into every parameter group before
``optimizer.step()``.
"""

import torch


def warmup_step_lr(epoch, base_lr, warmup=20, step_size=50, gamma=0.5):
    """Per-epoch learning rate as a plain float."""
    if epoch <= warmup:
        return base_lr * epoch / warmup
    return base_lr * gamma ** ((epoch - warmup - 1) // step_size)


class WarmupStepLR:
    """Learning rate as a function of the optimizer step count."""

    def __init__(self, base_lr, warmup=20, step_size=50, gamma=0.5,
                 steps_per_epoch=1):
        self.base_lr = base_lr
        self.warmup = warmup
        self.step_size = step_size
        self.gamma = gamma
        self.steps_per_epoch = max(1, steps_per_epoch)

    def __call__(self, count):
        return warmup_step_lr(count // self.steps_per_epoch, self.base_lr,
                              self.warmup, self.step_size, self.gamma)


def make_optimizer(name, params, momentum=0.9, weight_decay=0.0):
    """Adam, or SGD with momentum and torch (L2-before-momentum) weight
    decay — the same update as hebbax's optax chain.  The learning rate is
    set per step from the schedule, so it starts at 0 here."""
    params = list(params)
    if name == "adam":
        return torch.optim.Adam(params, lr=0.0)
    if name == "sgd":
        return torch.optim.SGD(params, lr=0.0, momentum=momentum,
                               weight_decay=weight_decay)
    raise ValueError(f"Optimizer {name!r} not implemented")
