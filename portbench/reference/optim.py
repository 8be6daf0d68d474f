"""SGD with momentum and L2 weight decay added to the gradient before the
momentum, Adam, written out, and the warm-up / step learning rate of an
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



class Adam:
    """Adam with bias correction and no weight decay, as ``torch.optim``
    writes it; the port's ``build_optimizer`` keeps its betas and eps
    (0.9, 0.999, 1e-8) and gives Adam no decay."""

    def __init__(self, b1=0.9, b2=0.999, eps=1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m, self.v, self.t = {}, {}, 0

    def step(self, params, grads, lr):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for name, g in grads.items():
            m = (1 - self.b1) * g
            v = (1 - self.b2) * g * g
            if name in self.m:
                m = m + self.b1 * self.m[name]
                v = v + self.b2 * self.v[name]
            self.m[name], self.v[name] = m, v
            params[name] = params[name] - lr * (m / c1) / (
                (v / c2).sqrt() + self.eps)

    def state(self, name):
        """The first moment: a tenth of the first gradient after one
        step."""
        return self.m[name]
