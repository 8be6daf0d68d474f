"""SGD with momentum and L2 weight decay added to the gradient before the
momentum, written out, and the warm-up / step learning rate of an
epoch."""


def epoch_lr(epoch, base, warmup, step_size, gamma):
    """Epoch 0 at 0, a linear warm-up to ``base`` at epoch ``warmup``,
    then halving (``gamma``) every ``step_size`` epochs."""
    if epoch <= warmup:
        return base * epoch / warmup
    return base * gamma ** ((epoch - warmup - 1) // step_size)


class SGD:
    def __init__(self, momentum, weight_decay):
        self.mu, self.wd = momentum, weight_decay
        self.buf = {}

    def step(self, params, grads, lr):
        for name, g in grads.items():
            d = g + self.wd * params[name]
            b = d if name not in self.buf else self.buf[name] * self.mu + d
            self.buf[name] = b
            params[name] = params[name] - lr * b

    def state(self, name):
        """The momentum buffer: the first gradient plus weight decay after
        one step."""
        return self.buf[name]

