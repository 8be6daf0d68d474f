"""The port's UNet2D held against hebbax's on carried weights.

hebbax's UNet2D is initialised from a PRNG key and its variables go
through ``hebbax_torch.bridge.from_flax`` into the port's model, so both
run the same weights on the same numpy-seeded 2x32x32 input.  Dropout is
off in both: hebbax's ``FastDropout`` is replaced by an identity module
(monkeypatch) and the port's dropout layers get p=0.

Tolerance: rtol 1e-4 / atol 1e-5 on eval logits and BN statistics —
float32 convolutions (XLA vs oneDNN) and batch norm (flax's E[x^2]-E[x]^2
variance vs torch's two-pass one) round differently through 22 conv
layers.  Train-mode logits get atol 1e-4: batch norm on the 2x2x2
bottleneck normalizes over 8 values and amplifies that rounding (seen:
2e-5 on logits of order 1).  The Hebbian deltas are sums over up to
2*32*32 pixels of products whose inputs carry that drift, and with K=50
the softmax amplifies a logit difference by K; they are held at 1e-3 of
each site's largest delta.
"""

from typing import Optional

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn
from flax import traverse_util

import hebbax.models.unet2d as junet
from hebbax.hebb.spec import HebbSpec as JSpec
from hebbax_torch.bridge import from_flax
from hebbax_torch.hebb.spec import HebbSpec
from hebbax_torch.hebb.surgery import pop_deltas
from hebbax_torch.models.unet2d import UNet2D
from hebbax_torch.ops.dropout import Dropout

torch.set_num_threads(2)


class _NoDropout(fnn.Module):
    rate: float
    deterministic: Optional[bool] = None

    @fnn.compact
    def __call__(self, x, deterministic=None):
        return x


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(junet, "FastDropout", _NoDropout)


def _spec_pair(hebb):
    if not hebb:
        return None, None
    kw = dict(mode="swta_t", k=50.0, w_nrm=True, alpha=1.0,
              exclude=("out_conv",))
    return JSpec(**kw), HebbSpec(**kw)


def make_pair(hebb=False, seed=0, shape=(2, 32, 32)):
    """(hebbax model, its variables, port model with the same weights,
    numpy NHWC input)."""
    jspec, tspec = _spec_pair(hebb)
    jm = junet.UNet2D(in_channels=3, n_cls=2, hebb=jspec)
    x = np.random.default_rng(seed).standard_normal(
        shape + (3,)).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                        train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    tm = UNet2D(3, 2, hebb=tspec, device="cpu")
    tm.load_state_dict(from_flax(variables["params"],
                                 variables["batch_stats"]))
    for m in tm.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return jm, variables, tm, x


def to_nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a,
                                                              (0, 3, 1, 2))))


def to_nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _stats_close(jstats, tm):
    flat = traverse_util.flatten_dict(jstats)
    sd = tm.state_dict()
    assert len(flat) == len([k for k in sd if k.endswith(("running_mean",
                                                          "running_var"))])
    for path, v in flat.items():
        name = ".".join(path[:-1]) + (".running_mean" if path[-1] == "mean"
                                      else ".running_var")
        np.testing.assert_allclose(sd[name].numpy(), np.asarray(v),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_param_tree_maps_one_to_one():
    _, variables, tm, _ = make_pair()
    n_flax = (len(traverse_util.flatten_dict(variables["params"]))
              + len(traverse_util.flatten_dict(variables["batch_stats"])))
    assert n_flax == len(tm.state_dict())
    assert sum(np.asarray(v).size for v in jax.tree_util.tree_leaves(
        variables["params"])) == sum(p.numel() for p in tm.parameters())


@pytest.mark.parametrize("hebb", [False, True])
def test_eval_forward_matches(no_dropout, hebb):
    jm, variables, tm, x = make_pair(hebb=hebb)
    ref = jm.apply(variables, jnp.asarray(x), train=False)
    tm.eval()
    with torch.no_grad():
        got = tm(to_nchw(x))
    np.testing.assert_allclose(to_nhwc(got), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("hebb", [False, True])
def test_train_forward_outputs_and_bn_stats_match(no_dropout, hebb):
    jm, variables, tm, x = make_pair(hebb=hebb, seed=1)
    ref, mut = jm.apply(variables, jnp.asarray(x), train=True,
                        mutable=["batch_stats", "hebb"],
                        rngs={"dropout": jax.random.PRNGKey(5)})
    tm.train()
    with torch.no_grad():
        got = tm(to_nchw(x))
    np.testing.assert_allclose(to_nhwc(got), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    # running_var takes the BIASED batch variance, as flax does
    _stats_close(mut["batch_stats"], tm)


def test_train_forward_deltas_match(no_dropout):
    jm, variables, tm, x = make_pair(hebb=True, seed=2)
    _, mut = jm.apply(variables, jnp.asarray(x), train=True,
                      mutable=["batch_stats", "hebb"],
                      rngs={"dropout": jax.random.PRNGKey(5)})
    tm.train()
    with torch.no_grad():
        tm(to_nchw(x))
    got = pop_deltas(tm)
    ref = {".".join(p[:-1]) + ".weight": np.transpose(np.asarray(v),
                                                      (3, 2, 0, 1))
           for p, v in traverse_util.flatten_dict(mut["hebb"]).items()}
    assert len(got) == len(ref) == 22     # 18 3x3 + 4 1x1, head excluded
    assert set(got) == set(ref)
    assert not any(n.startswith("out_conv") for n in got)
    for name, d in got.items():
        scale = float(np.abs(ref[name]).max())
        np.testing.assert_allclose(d.numpy(), ref[name], rtol=0,
                                   atol=1e-3 * scale, err_msg=name)
    assert pop_deltas(tm) == {}


def test_deltas_accumulate_over_forwards(no_dropout):
    _, _, tm, x = make_pair(hebb=True, seed=3)
    tm.train()
    with torch.no_grad():
        tm(to_nchw(x))
        once = pop_deltas(tm)
        tm(to_nchw(x))
        tm(to_nchw(x))
    twice = pop_deltas(tm)
    name = "encoder.in_conv.conv1.weight"
    # the second and third forwards see moved BN statistics only in eval;
    # in train mode both use batch statistics, so the sum is 2x
    torch.testing.assert_close(twice[name], 2 * once[name], rtol=1e-5,
                               atol=1e-4)
