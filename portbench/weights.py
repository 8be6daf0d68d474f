"""The weights both sides start from, made on the device from the seed in
one draw: a conv kernel He-normal over its fan-in (dim 1 times the kernel
taps, torch's convention for convs and transpose convs alike), a bias
0.01 N(0, 1), a norm's scale 1 + 0.02 N(0, 1)."""

import math

import numpy as np
import torch

WEIGHT_TAG = 0x5EED


def weight_seed(seed):
    return int(np.random.SeedSequence([int(seed), WEIGHT_TAG]).generate_state(
        1, np.uint64)[0] >> 1)


def make_weights(named_shapes, seed, device):
    """{name: tensor} for ``named_shapes`` [(name, shape)], in that order
    from one ``torch.randn`` on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(weight_seed(seed))
    total = sum(math.prod(s) for _, s in named_shapes)
    z = torch.randn(total, generator=g, device=device)
    out, off = {}, 0
    for name, shape in named_shapes:
        n = math.prod(shape)
        v = z[off:off + n].view(shape)
        off += n
        if len(shape) >= 2:
            v = v * math.sqrt(2.0 / (shape[1] * math.prod(shape[2:])))
        elif name.endswith(".bias"):
            v = v * 0.01
        else:
            v = v * 0.02 + 1.0
        out[name] = v
    return out
