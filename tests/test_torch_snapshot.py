"""Snapshots cross between hebbax and the port in both directions.

* hebbax ``save_snapshot`` -> the port's ``load_state_dict``: every
  tensor equal to the hebbax variable under the bridge's layout map, and
  it loads strictly into the port's UNet2D;
* the port's ``save_snapshot`` -> hebbax ``load_snapshot``: the same tree
  structure and shapes as hebbax's own init, every array bit-equal, and
  hebbax's model runs on it;
* the port's msgpack subset against the ``msgpack`` package (both ways),
  and its paletted PNG writer against PIL.

Everything here is exact: no arithmetic happens, only layout changes.
"""

import io

import msgpack
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util
from PIL import Image

from hebbax.models.unet2d import UNet2D as JUNet
from hebbax.utils import checkpoint as jckpt
from hebbax_torch import bridge
from hebbax_torch.models.unet2d import UNet2D
from hebbax_torch.utils import checkpoint as tckpt
from hebbax_torch.utils.images import encode_paletted_png

torch.set_num_threads(2)

META = dict(hebb_params={"mode": "swta_t", "k": 50.0, "w_nrm": True,
                         "alpha": 1.0, "patchwise": True, "contrast": 1.0,
                         "uniformity": False},
            layers_excluded=["out_conv"])


@pytest.fixture(scope="module")
def jvars():
    m = JUNet(in_channels=3, n_cls=2)
    v = m.init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)),
               train=False)
    return jax.tree_util.tree_map(np.asarray, v)


def test_hebbax_snapshot_loads_into_port(jvars, tmp_path):
    path = jckpt.save_snapshot(jvars, str(tmp_path), threshold=0.34,
                               save_best=True, **META)
    sd, meta = tckpt.load_state_dict(path)
    assert meta["threshold"] == pytest.approx(0.34)
    assert meta["hebb_params"] == META["hebb_params"]
    assert meta["excluded_layers"] == ["out_conv"]
    k = jvars["params"]["encoder"]["in_conv"]["conv1"]["kernel"]
    assert torch.equal(sd["encoder.in_conv.conv1.weight"],
                       torch.from_numpy(np.transpose(k, (3, 2, 0, 1)).copy()))
    s = jvars["batch_stats"]["main_decoder"]["up4"]["conv"]["bn2"]["var"]
    assert torch.equal(sd["main_decoder.up4.conv.bn2.running_var"],
                       torch.from_numpy(s.copy()))
    model = UNet2D(3, 2, device="cpu")
    model.load_state_dict(sd)      # strict: same names, same shapes


def test_port_snapshot_loads_into_hebbax(jvars, tmp_path):
    model = UNet2D(3, 2, device="cpu")
    sd = model.state_dict()
    path = tckpt.save_snapshot(sd, str(tmp_path), threshold=None,
                               save_best=False, **META)
    variables, meta = jckpt.load_snapshot(path)
    assert meta["threshold"] is None
    assert meta["excluded_layers"] == ["out_conv"]
    ref = traverse_util.flatten_dict(jvars)
    got = traverse_util.flatten_dict(variables)
    assert set(got) == set(ref)
    for p in ref:
        assert got[p].shape == ref[p].shape and got[p].dtype == np.float32
    k = got[("params", "out_conv", "conv_out", "kernel")]
    np.testing.assert_array_equal(
        k, np.transpose(sd["out_conv.conv_out.weight"].numpy(),
                        (2, 3, 1, 0)))
    out = JUNet(in_channels=3, n_cls=2).apply(
        variables, jnp.zeros((1, 32, 32, 3)), train=False)
    assert out.shape == (1, 32, 32, 2)


def test_port_snapshot_bytes_equal_hebbax(jvars, tmp_path):
    sd = bridge.from_flax(jvars["params"], jvars["batch_stats"])
    p1 = jckpt.save_snapshot(jvars, str(tmp_path / "a"), threshold=0.5,
                             **META)
    p2 = tckpt.save_snapshot(sd, str(tmp_path / "b"), threshold=0.5,
                             **META)
    with open(p1, "rb") as f1, open(p2, "rb") as f2:
        assert f1.read() == f2.read()


def test_round_trip_through_both_packages(jvars, tmp_path):
    p1 = jckpt.save_snapshot(jvars, str(tmp_path / "a"), **META)
    sd, meta = tckpt.load_state_dict(p1)
    p2 = tckpt.save_snapshot(sd, str(tmp_path / "b"),
                             hebb_params=meta["hebb_params"],
                             layers_excluded=meta["excluded_layers"])
    back, _ = jckpt.load_snapshot(p2)
    ref = traverse_util.flatten_dict(jvars)
    got = traverse_util.flatten_dict(back)
    assert set(got) == set(ref)
    for p in ref:
        np.testing.assert_array_equal(got[p], ref[p])


def test_bridge_round_trip(jvars):
    sd = bridge.from_flax(jvars["params"], jvars["batch_stats"])
    params, stats = bridge.to_flax(sd)
    for tree, ref in ((params, jvars["params"]),
                      (stats, jvars["batch_stats"])):
        f, r = traverse_util.flatten_dict(tree), traverse_util.flatten_dict(
            ref)
        assert set(f) == set(r)
        for p in r:
            np.testing.assert_array_equal(f[p], r[p])


def test_bridge_refuses_unknown_leaves():
    with pytest.raises(ValueError):
        bridge.from_flax({"conv": {"mystery": np.zeros(3)}})
    with pytest.raises(ValueError):
        bridge.to_flax({"bn.num_batches_tracked": torch.tensor(1)})


_SAMPLES = [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 63,
    -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1,
    -2 ** 63, 0.5, -1e300, True, False, None, "", "a" * 31, "b" * 32,
    "c" * 255, "d" * 256, "e" * 70000, "ünïcode", b"", b"x" * 255,
    b"y" * 256, b"z" * 70000, list(range(15)), list(range(16)),
    list(range(70000)), {str(i): i for i in range(15)},
    {str(i): [i, str(i)] for i in range(16)},
    {"nested": {"deeper": {"list": [1, "two", 3.0, None]}}},
]


@pytest.mark.parametrize("obj", _SAMPLES,
                         ids=[str(i) for i in range(len(_SAMPLES))])
def test_msgpack_codec_matches_package(obj):
    ours = tckpt.packb(obj)
    assert ours == msgpack.packb(obj, use_bin_type=True)
    assert tckpt.unpackb(msgpack.packb(obj, use_bin_type=True)) == obj


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "uint8",
                                   "int64", "bool"])
@pytest.mark.parametrize("shape", [(), (0,), (3,), (2, 3, 4), (1, 1, 1, 5)])
def test_ndarray_leaves_match_flax(dtype, shape):
    from flax import serialization
    rng = np.random.default_rng(0)
    a = (rng.standard_normal(shape) * 10).astype(dtype)
    tree = {"n": {"v": a.copy()}, "w": a}     # flax writes sorted keys
    ours = tckpt.packb(tree)
    assert ours == serialization.msgpack_serialize(tree)
    back = tckpt.unpackb(serialization.msgpack_serialize(tree))
    for got in (back["w"], back["n"]["v"]):
        assert got.dtype == a.dtype and got.shape == a.shape
        np.testing.assert_array_equal(got, a)


def test_codec_refuses_garbage():
    with pytest.raises(ValueError):
        tckpt.unpackb(b"\xc1")
    with pytest.raises(ValueError):
        tckpt.unpackb(tckpt.packb([1, 2]) + b"\x00")
    with pytest.raises(ValueError):
        tckpt.unpackb(b"\xdc\x00\x05\x01")       # truncated array


def test_snapshot_rejects_other_files(tmp_path):
    p = tmp_path / "x.ckpt"
    p.write_bytes(b"NOTACKPT" + b"\x00" * 16)
    with pytest.raises(ValueError):
        tckpt.load_snapshot(str(p))


@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (64, 33)])
def test_paletted_png_decodes_with_pil(shape):
    rng = np.random.default_rng(1)
    pred = rng.integers(0, 2, shape).astype(np.uint8)
    palette = [0, 0, 0, 255, 255, 255]
    img = Image.open(io.BytesIO(encode_paletted_png(pred, palette)))
    assert img.mode == "P"
    np.testing.assert_array_equal(np.array(img), pred)
    assert img.getpalette()[:6] == palette
    rgb = np.array(img.convert("RGB"))
    np.testing.assert_array_equal(rgb[..., 0], pred * 255)
