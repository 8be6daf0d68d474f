"""The port's SWTA delta held against hebbax.

The same numpy-seeded w, x, y go through ``hebbax.hebb.rules.
swta_conv_delta`` (XLA), hebbax's Pallas kernel ``swta_delta_pallas`` in
interpret mode, and the port's plain version ``hebbax_torch.hebb.rules.
swta_conv_delta``.  The port takes the UNPADDED NCHW input and pads by
k//2 itself; hebbax's Pallas kernel takes a pre-padded channels-last input,
so it gets the same input zero-padded.

Tolerance rtol 1e-5 / atol 1e-6, as tests/test_pallas_kernels.py: float32
softmax and sums over at most a few hundred products, taken in another
order by each framework.  The O=256 cases add atol 1e-5 * max|delta|:
with K=50 the softmax logits k*y span ~300 there, so the float32 rounding
of k*y alone moves each r by up to ~300 * 2**-24 ~ 2e-5 of itself, and
implementations that round it differently (XLA, the Pallas interpreter,
torch) disagree by that much.

The dispatcher and the CUDA kernel are tested in test_torch_kernels.py,
which imports no JAX so that it also runs on the card's machine.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hebbax.hebb.pallas_kernels as pk
from hebbax.hebb import rules as jrules
from hebbax_torch.hebb import rules as trules

torch.set_num_threads(2)


# (n, h, w, i, o, k): the shapes of tests/test_pallas_kernels.py, plus a
# padded 3x3 and a 1x1 site with I=3 and O=256
SHAPES = [(2, 4, 4, 3, 5, 3), (1, 8, 8, 4, 4, 1), (2, 4, 6, 2, 3, 3),
          (2, 8, 8, 3, 256, 3), (2, 8, 8, 3, 256, 1)]


def _inputs(shape, seed=0):
    n, h, wd, i, o, k = shape
    rng = np.random.RandomState(seed)
    w = rng.randn(k, k, i, o).astype(np.float32) * 0.1     # (kh, kw, I, O)
    x = rng.randn(n, h, wd, i).astype(np.float32)           # unpadded NHWC
    y = rng.randn(n, h, wd, o).astype(np.float32)
    return w, x, y


def _assert_close(got, ref, shape):
    ref = np.asarray(ref)
    atol = 1e-6 if shape[4] < 256 else 1e-5 * float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=atol)


def _port(w, x, y, k_temp):
    p = w.shape[0] // 2
    d = trules.swta_conv_delta(
        torch.from_numpy(np.transpose(w, (3, 2, 0, 1)).copy()),
        torch.from_numpy(np.transpose(x, (0, 3, 1, 2)).copy()),
        torch.from_numpy(np.transpose(y, (0, 3, 1, 2)).copy()),
        k_temp, (p, p))
    return np.transpose(d.numpy(), (2, 3, 1, 0))            # -> (kh,kw,I,O)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_hebbax_rule(shape):
    w, x, y = _inputs(shape)
    p = shape[5] // 2
    ref = jrules.swta_conv_delta(jnp.asarray(w), jnp.asarray(x),
                                 jnp.asarray(y), 50.0, (1, 1),
                                 padding=((p, p), (p, p)))
    _assert_close(_port(w, x, y, 50.0), ref, shape)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret(shape):
    w, x, y = _inputs(shape, seed=1)
    p = shape[5] // 2
    xp = np.pad(x, ((0, 0), (p, p), (p, p), (0, 0)))
    ref = pk.swta_delta_pallas(jnp.asarray(w), jnp.asarray(xp),
                               jnp.asarray(y), 50.0, interpret=True)
    _assert_close(_port(w, x, y, 50.0), ref, shape)
