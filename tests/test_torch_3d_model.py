"""The port's UNet3D held against hebbax's on carried weights, and
``unet3d`` snapshots across the two packages.

hebbax's UNet3D (init_features=4) is initialised from a PRNG key and its
variables go through ``hebbax_torch.bridge.from_flax`` — told which
modules are transpose convs — into the port's model, so both run the same
weights on the same numpy-seeded 2x32^3 input.  The network has no
dropout.

Tolerances: eval logits atol 1e-4 and BN statistics rtol 1e-4 / atol
1e-5 (float32 convolutions, XLA vs oneDNN, through 23 layers); training
deltas within 1e-4 of each site's largest |delta| (sums over up to
2*32^3 voxels; K=50 amplifies a logit difference in the softmax, and
train-mode BN normalizes the 2^3 bottleneck over 16 values).  Snapshots
are exact.
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp
from flax import traverse_util

from hebbax.hebb.spec import HebbSpec as JSpec
from hebbax.models.unet3d import UNet3D as JUNet3D
from hebbax.utils import checkpoint as jckpt
from hebbax_torch import bridge
from hebbax_torch.hebb.layers import (HConv, HConvTranspose,
                                      transposed_paths)
from hebbax_torch.hebb.spec import HebbSpec
from hebbax_torch.hebb.surgery import pop_deltas
from hebbax_torch.models import get_network, network_meta
from hebbax_torch.models.unet3d import UNet3D
from hebbax_torch.utils import checkpoint as tckpt

torch.set_num_threads(2)

SPEC = dict(mode="swta_t", k=50.0, w_nrm=True, alpha=1.0, exclude=("conv",))
TO_NCDHW, TO_NDHWC = (0, 4, 1, 2, 3), (0, 2, 3, 4, 1)


def make_pair(hebb=False, seed=0, shape=(2, 32, 32, 32), features=4):
    """(hebbax model, its numpy variables, the port's model with the same
    weights, numpy NDHWC input)."""
    jm = JUNet3D(in_channels=1, n_cls=2, init_features=features,
                 hebb=JSpec(**SPEC) if hebb else None)
    x = np.random.default_rng(seed).standard_normal(
        shape + (1,)).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                        train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    tm = UNet3D(1, 2, init_features=features,
                hebb=HebbSpec(**SPEC) if hebb else None)
    tm.load_state_dict(bridge.from_flax(variables["params"],
                                        variables["batch_stats"],
                                        transposed_paths(tm)))
    return jm, dict(variables), tm, x


def to_t(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, TO_NCDHW)))


def to_j(t):
    return np.transpose(t.detach().numpy(), TO_NDHWC)


def test_param_tree_maps_one_to_one():
    _, variables, tm, _ = make_pair()
    flat = {**traverse_util.flatten_dict(variables["params"]),
            **traverse_util.flatten_dict(variables["batch_stats"])}
    assert len(flat) == len(tm.state_dict())
    names = {".".join(p[:-1]) for p in flat}
    assert {"encoder.encoder1.conv1", "decoder.upconv4",
            "decoder.decoder1.norm2", "conv"} <= names
    for path, v in flat.items():
        mod = ".".join(path[:-1])
        t_name = mod + {"kernel": ".weight", "scale": ".weight",
                        "bias": ".bias", "mean": ".running_mean",
                        "var": ".running_var"}[path[-1]]
        t_shape = tuple(tm.state_dict()[t_name].shape)
        if path[-1] == "kernel":
            k, io = v.shape[:3], v.shape[3:]
            io = io if "upconv" in mod else io[::-1]
            assert t_shape == io + k, t_name
        else:
            assert t_shape == v.shape, t_name
    # torch BatchNorm3d keeps its ones init (only 2D rescales)
    assert torch.equal(UNet3D(1, 2, init_features=4).decoder.decoder1
                       .norm2.weight, torch.ones(4))


@pytest.mark.parametrize("hebb", [False, True])
def test_eval_forward_matches(hebb):
    jm, variables, tm, x = make_pair(hebb=hebb)
    ref = jm.apply(variables, jnp.asarray(x), train=False)
    tm.eval()
    with torch.no_grad():
        got = tm(to_t(x))
    np.testing.assert_allclose(to_j(got), np.asarray(ref), rtol=0,
                               atol=1e-4)


def test_train_forward_deltas_and_bn_stats_match():
    jm, variables, tm, x = make_pair(hebb=True, seed=2)
    ref, mut = jm.apply(variables, jnp.asarray(x), train=True,
                        mutable=["batch_stats", "hebb"])
    tm.train()
    with torch.no_grad():
        out = tm(to_t(x))
    np.testing.assert_allclose(to_j(out), np.asarray(ref), rtol=0,
                               atol=1e-4)
    sd = tm.state_dict()
    for path, v in traverse_util.flatten_dict(mut["batch_stats"]).items():
        name = ".".join(path[:-1]) + (".running_mean" if path[-1] == "mean"
                                      else ".running_var")
        np.testing.assert_allclose(sd[name].numpy(), np.asarray(v),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    got = pop_deltas(tm)
    ref_d = {}
    for p, v in traverse_util.flatten_dict(mut["hebb"]).items():
        mod = ".".join(p[:-1])
        perm = (3, 4, 0, 1, 2) if "upconv" in mod else (4, 3, 0, 1, 2)
        ref_d[mod + ".weight"] = np.transpose(np.asarray(v), perm)
    # 18 3x3x3 convs + 4 transpose convs; the head is excluded
    assert len(got) == len(ref_d) == 22 and set(got) == set(ref_d)
    assert sum("upconv" in n for n in got) == 4
    for name, d in got.items():
        scale = float(np.abs(ref_d[name]).max())
        np.testing.assert_allclose(d.numpy(), ref_d[name], rtol=0,
                                   atol=1e-4 * scale, err_msg=name)


def test_registry_names():
    for name, f in (("unet3d", 64), ("unet3d_s2d", 64), ("unet3d_min", 32)):
        assert network_meta(name) == {"nd": 3, "outputs": "single",
                                      "rngs": ()}
        m = get_network(name, 1, 2, device="meta")
        assert m.conv.weight.shape == (2, f, 1, 1, 1)
        assert m.encoder.bottleneck.conv2.weight.shape[0] == 16 * f
    with pytest.raises(KeyError, match="unet3d_cct"):
        get_network("unet3d_cct", 1, 2)


# -- snapshots ---------------------------------------------------------------

META = dict(threshold=0.38, hebb_params=HebbSpec(**SPEC).to_dict(),
            layers_excluded=["conv"])


def test_hebbax_snapshot_loads_into_the_port(tmp_path):
    _, variables, _, _ = make_pair(seed=3)
    path = jckpt.save_snapshot(variables, str(tmp_path), **META)
    model = UNet3D(1, 2, init_features=4)
    sd, meta = tckpt.load_state_dict(path, transposed_paths(model))
    model.load_state_dict(sd)         # strict: same names, same shapes
    assert meta["threshold"] == 0.38
    k = variables["params"]["decoder"]["upconv2"]["kernel"]
    np.testing.assert_array_equal(
        model.decoder.upconv2.weight.detach().numpy(),
        np.transpose(k, (3, 4, 0, 1, 2)))
    with pytest.raises(ValueError, match="transposed_paths"):
        tckpt.load_state_dict(path)


def test_port_snapshot_loads_into_hebbax(tmp_path):
    _, variables, tm, _ = make_pair(seed=4)
    p1 = jckpt.save_snapshot(variables, str(tmp_path / "a"), **META)
    p2 = tckpt.save_snapshot(tm.state_dict(), str(tmp_path / "b"),
                             transposed=transposed_paths(tm), **META)
    with open(p1, "rb") as f1, open(p2, "rb") as f2:
        assert f1.read() == f2.read()
    back, _ = jckpt.load_snapshot(p2)
    flat_b = traverse_util.flatten_dict(back)
    flat_v = traverse_util.flatten_dict(variables)
    assert set(flat_b) == set(flat_v)
    for k, v in flat_v.items():
        np.testing.assert_array_equal(flat_b[k], v)


class _Toy(nn.Module):
    """An I == O transpose conv beside an I == O conv: their 5-D weights
    have one shape, so only the module type can tell their layouts."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.up = HConvTranspose(3, 3, (2, 2, 2), stride=2, generator=g)
        self.conv = HConv(3, 3, (2, 2, 2), generator=g)


def test_the_module_type_decides_the_kernel_layout(tmp_path):
    toy = _Toy()
    tp = transposed_paths(toy)
    assert tp == {"up"}
    assert toy.up.weight.shape == toy.conv.weight.shape
    path = tckpt.save_snapshot(toy.state_dict(), str(tmp_path),
                               transposed=tp)
    variables, _ = jckpt.load_snapshot(path)
    w_up = toy.up.weight.detach().numpy()
    w_conv = toy.conv.weight.detach().numpy()
    np.testing.assert_array_equal(variables["params"]["up"]["kernel"],
                                  np.transpose(w_up, (2, 3, 4, 0, 1)))
    np.testing.assert_array_equal(variables["params"]["conv"]["kernel"],
                                  np.transpose(w_conv, (2, 3, 4, 1, 0)))
    sd, _ = tckpt.load_state_dict(path, tp)
    assert torch.equal(sd["up.weight"], toy.up.weight.detach())
    assert torch.equal(sd["conv.weight"], toy.conv.weight.detach())
    # a map that took the shape's word would load `up` transposed
    wrong, _ = tckpt.load_state_dict(path, set())
    assert not torch.equal(wrong["up.weight"], toy.up.weight.detach())
