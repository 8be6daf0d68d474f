"""The port's spatial sharding (``hebbax_torch.parallel.spatial``) on 4 and
2 gloo CPU ranks, held against hebbax's ``spatial_sharding`` (its forward
over ``make_mesh(N)`` of the 8-device virtual CPU mesh, H / D sharded with
``P(None, 'data')``), hebbax's replicated forward and the port's own
unsharded forward on the same weights:

* 4 ranks: ``halo_exchange`` of widths 1, 2 and 3 (longer than a 2-row
  shard) on 4-D and 5-D tensors; ``unet`` eval at 2x3x64x64, H over 4
  (the line of ``MULTICHIP_r05.json`` that ``test_torch_parallel.py``
  leaves out), and ``unet_urpc`` (its nearest resizes by whole
  multiples), ``unet_cct`` and ``unet_superpix`` against the port alone;
  align-corners resizes by 2, 4 and 8 (bilinear, trilinear, and the
  bfloat16 matmul form); every refusal;
* 2 ranks: the same halos; ``unet3d_min`` at 1x1x32x16x16, D over 2;
  ``unet3d_urpc`` (all four outputs: instance norm, factor-8 resizes) and
  ``vnet`` (5^3 convs, 2-row halos, k = s = 2 convs) at 32x16x16, and
  ``unet3d``, ``unet3d_dtc``, ``unet3d_cct``, ``unet3d_superpix``,
  ``vnet_dtc`` and ``vnet_cct`` there against the port alone; the
  resizes; every refusal.

Weights come from hebbax through ``hebbax_torch.bridge.from_flax``, but
VNet's go the other way (``to_flax`` of the port's init, as
``test_torch_vnet.py`` does: hebbax's own init runs op by op for half a
minute), and the port-only networks take the port's init from seed 0.
Each spawn has a 60 s process-group timeout, a join deadline and one
thread per rank, and runs all its cases.

Tolerances, of max(1, max|output|), measured on the CPU.  Every network
has a float64 twin (network and input cast; its resizes take the matmul
form, the instance norm the same global two-pass statistics), held to
its unsharded forward within 1e-12 (measured at most 8.6e-14, in
``unet3d_urpc``).  In float32, sharded against unsharded in the port:
the 2D networks 2e-6 (``unet`` 1.12e-6, ``unet_urpc`` 8.7e-7,
``unet_cct`` 6.4e-7, ``unet_superpix`` 7.5e-7): a shard's bilinear resize
mixes its rows with the whole resize's weights but rounds about one ulp
away from the whole call (the resize itself: within 1e-6, measured
1.0e-7; trilinear and the bfloat16 matmul form are equal to the bit).
In the 3D networks a conv of the 1-voxel bottleneck shard (2x1x1 whole)
takes another BLAS path than the 2-voxel whole, and ``unet3d_urpc``'s
instance norm over those two voxels amplifies that rounding: 1e-5
(``unet3d_min`` 5.8e-7, ``vnet`` 9.8e-7, ``unet3d`` / ``_cct`` /
``_superpix`` 8.6e-7, ``unet3d_dtc`` 2.4e-6, ``vnet_dtc`` 7.5e-6,
``vnet_cct`` 9.8e-7) or, for ``unet3d_urpc``, the repo's 3D gate 1e-4
(measured 1.5e-5).  The port against hebbax: 1e-5, hebbax's own bound
for sharded against replicated (``unet`` 1.7e-6, ``unet3d_min`` 7.7e-7,
``vnet`` 1.8e-6), but 1e-4 for ``unet3d_urpc``, whose unsharded port
forward is already 3.7e-5 from hebbax's at this size (the sharded one
2.6e-5; ``test_torch_3d_semi_nets`` holds it to 1e-4 too).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hebbax.models import get_network as j_get_network
from hebbax.models import primary_logits as j_primary
from hebbax.parallel import make_mesh, replicated
from hebbax.parallel import spatial_sharding as j_spatial_sharding
from hebbax_torch import bridge, parallel
from hebbax_torch.hebb.layers import transposed_paths
from hebbax_torch.models import get_network
from hebbax_torch.utils.seeding import make_generator

import torch_spatial_cases as cases

torch.set_num_threads(2)

TIMEOUT_S = 60
DEADLINE_S = 300
# of max(1, max|out|): sharded vs unsharded (float32 and float64) and the
# port vs hebbax, by network (the module docstring)
PORT_TOL = {"unet": 2e-6, "unet_urpc": 2e-6, "unet_cct": 2e-6,
            "unet_superpix": 2e-6, "unet3d_min": 1e-5, "unet3d": 1e-5,
            "unet3d_dtc": 1e-5, "unet3d_cct": 1e-5, "unet3d_superpix": 1e-5,
            "vnet": 1e-5, "vnet_dtc": 1e-5, "vnet_cct": 1e-5,
            "unet3d_urpc": 1e-4}
F64_TOL = 1e-12
# an align-corners resize of the sharded axis: sharded vs unsharded
RESIZE_TOL = 1e-6
HEBBAX_TOL = {"unet": 1e-5, "unet3d_min": 1e-5, "vnet": 1e-5,
              "unet3d_urpc": 1e-4}
FACTORS = (2, 4, 8)
# the other networks the mode runs, held against the port's own unsharded
# forward of seed 0's weights: 2D at H/4, 3D at D/2
PORT_ONLY = {4: ("unet_urpc", "unet_cct", "unet_superpix"),
             2: ("unet3d", "unet3d_dtc", "unet3d_cct", "unet3d_superpix",
                 "vnet_dtc", "vnet_cct")}


def _nchw(a):
    return np.ascontiguousarray(np.moveaxis(a, -1, 1))


def _rel(got, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - ref).max()) / max(
        1.0, float(np.abs(ref).max()))


def hebbax_pair(name, in_channels, x, n_ranks, sharded):
    """(the forward case carrying hebbax's init, {'replicated': hebbax's
    outputs, 'sharded': its ``spatial_sharding`` forward's or None}), NC*
    numpy outputs."""
    jm = j_get_network(name, in_channels, 2)
    variables = jm.init({"params": jax.random.PRNGKey(0)},
                        jnp.asarray(x[:1]), train=False)
    tm = get_network(name, in_channels, 2)
    state = bridge.from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]),
        jax.tree_util.tree_map(np.asarray, variables.get("batch_stats")),
        transposed_paths(tm))
    fwd = jax.jit(lambda v, img: jm.apply(v, img, train=False))
    ref = {"replicated": fwd(variables, jnp.asarray(x)), "sharded": None}
    if sharded:
        mesh = make_mesh(n_ranks)
        got = fwd(jax.device_put(variables, replicated(mesh)),
                  jax.device_put(jnp.asarray(x),
                                 j_spatial_sharding(mesh)))
        ref["sharded"] = got
    case = {"kind": "forward", "name": name, "in_channels": in_channels,
            "x": _nchw(x), "state": {k: v.numpy() for k, v in state.items()}}
    return case, ref


def vnet_pair(x):
    """VNet: the port's init from seed 0 carried to hebbax (``to_flax``)."""
    tm = get_network("vnet", 1, 2, generator=make_generator(0))
    params, stats = jax.tree_util.tree_map(np.array, bridge.to_flax(
        tm.state_dict(), transposed_paths(tm)))
    jm = j_get_network("vnet", 1, 2)
    ref = jax.jit(lambda v, img: jm.apply(v, img, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    case = {"kind": "forward", "name": "vnet", "in_channels": 1, "seed": 0,
            "x": _nchw(x)}
    return case, {"replicated": ref, "sharded": None}


def _outputs(ref):
    if ref is None:
        return None
    return [_nchw(np.asarray(o)) for o in (
        ref if isinstance(ref, (tuple, list)) else [ref])]


def _image(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def halo_cases():
    return {f"halo_{nd}d": {
        "kind": "halo", "x": _image(7 + nd, shape),
        "widths": [(1, 1), (2, 2), (0, 3), (3, 1)]}
        for nd, shape in ((2, (2, 3, 8, 5)), (3, (1, 2, 8, 3, 4)))}


def resize_cases():
    out = {}
    for f in FACTORS:
        out[f"resize_2d_x{f}"] = {"kind": "resize", "x": _image(f, (
            2, 3, 8, 5)), "size": (8 * f, 7)}
        out[f"resize_3d_x{f}"] = {"kind": "resize", "x": _image(f + 1, (
            1, 2, 8, 3, 4)), "size": (8 * f, 5, 4)}
    out["resize_bf16_x4"] = {"kind": "resize", "bf16": True,
                             "x": _image(5, (1, 2, 8, 3, 4)),
                             "size": (32, 6, 4)}
    return out


def group_4():
    x = _image(3, (2, 64, 64, 3))
    unet, ref = hebbax_pair("unet", 3, x, 4, sharded=True)
    todo = {"unet": unet, **{n: {"kind": "forward", "name": n,
                                 "in_channels": 3, "seed": 0,
                                 "x": _nchw(x)} for n in PORT_ONLY[4]}}
    for k in list(todo):
        todo[k + "_f64"] = dict(todo[k], double=True)
    return ({**todo, **halo_cases(), **resize_cases(),
             "refusals": {"kind": "refusal"}},
            {"unet": ref})


def group_2():
    x = _image(5, (1, 32, 16, 16, 1))
    built = {"unet3d_min": hebbax_pair("unet3d_min", 1, x, 2, sharded=True),
             "unet3d_urpc": hebbax_pair("unet3d_urpc", 1, x, 2,
                                        sharded=False),
             "vnet": vnet_pair(x)}
    todo = {k: v[0] for k, v in built.items()}
    todo.update({n: {"kind": "forward", "name": n, "in_channels": 1,
                     "seed": 0, "x": _nchw(x)} for n in PORT_ONLY[2]})
    for k in list(todo):
        todo[k + "_f64"] = dict(todo[k], double=True)
    return ({**todo, **halo_cases(), **resize_cases(),
             "refusals": {"kind": "refusal"}},
            {k: v[1] for k, v in built.items()})


def run_group(todo, n_ranks):
    names = list(todo)
    ranks = parallel.run_ranks(cases.run_cases, n_ranks,
                               ([todo[k] for k in names],),
                               timeout=TIMEOUT_S, deadline=DEADLINE_S,
                               threads=1, data_parallel=False)
    return {k: [r[i] for r in ranks] for i, k in enumerate(names)}


@pytest.fixture(scope="module")
def groups():
    out = {}
    for n, make in ((4, group_4), (2, group_2)):
        todo, refs = make()
        out[n] = (todo, refs, run_group(todo, n))
    return out


def _same_on_every_rank(per_rank, key):
    for other in per_rank[1:]:
        for a, b in zip(per_rank[0][key], other[key]):
            np.testing.assert_array_equal(a, b)


# -- halos ------------------------------------------------------------------

@pytest.mark.parametrize("n", [4, 2])
@pytest.mark.parametrize("nd", [2, 3])
def test_halo_exchange_reads_neighbours_and_zero_edges(groups, n, nd):
    """Rank r's halo (lo, hi) is rows [r*L - lo, (r+1)*L + hi) of the
    global tensor zero-padded on the axis: a width past a shard reads two
    ranks over."""
    todo, _, got = groups[n]
    case = todo[f"halo_{nd}d"]
    x = case["x"]
    local = x.shape[2] // n
    for lo, hi in case["widths"]:
        pad = [(0, 0)] * x.ndim
        pad[2] = (lo, hi)
        padded = np.pad(x, pad)
        for r, res in enumerate(got[f"halo_{nd}d"]):
            want = padded[:, :, r * local:(r + 1) * local + lo + hi]
            np.testing.assert_array_equal(res[f"{lo},{hi}"], want,
                                          err_msg=f"rank {r} ({lo}, {hi})")


# -- forwards ---------------------------------------------------------------

FORWARDS = [(4, "unet"), (2, "unet3d_min"), (2, "unet3d_urpc"), (2, "vnet")]


@pytest.mark.parametrize("n,name", FORWARDS + [
    (n, name) for n, names in PORT_ONLY.items() for name in names])
def test_sharded_forward_matches_the_unsharded_port(groups, n, name):
    """Every rank gathers the same outputs, each within PORT_TOL of the
    same rank's unsharded forward; every rank held L / N rows."""
    todo, _, got = groups[n]
    per_rank = got[name]
    _same_on_every_rank(per_rank, "sharded")
    for g, p in zip(per_rank[0]["sharded"], per_rank[0]["plain"]):
        assert _rel(g, p) <= PORT_TOL[name], (name, _rel(g, p))
    assert per_rank[0]["local_rows"] * n == todo[name]["x"].shape[2]


@pytest.mark.parametrize("name", ["unet3d_min", "unet3d_urpc", "vnet",
                                  *PORT_ONLY[2], "unet", *PORT_ONLY[4]])
def test_float64_sharding_is_exact_to_rounding(groups, name):
    """Every network's float64 twin: sharded against unsharded within
    F64_TOL, every output."""
    n = 4 if name == "unet" or name in PORT_ONLY[4] else 2
    outs = groups[n][2][name + "_f64"][0]
    assert all(g.dtype == np.float64 for g in outs["sharded"])
    for g, p in zip(outs["sharded"], outs["plain"]):
        assert _rel(g, p) <= F64_TOL, (name, _rel(g, p))


@pytest.mark.parametrize("n,name", FORWARDS)
def test_sharded_forward_matches_hebbax(groups, n, name):
    """The port's sharded outputs within HEBBAX_TOL of hebbax's replicated
    forward and, for ``unet`` (H/4) and ``unet3d_min`` (D/2), of hebbax's
    own ``spatial_sharding`` forward, which holds its replicated one to
    1e-5 as hebbax's test does."""
    _, refs, got = groups[n]
    sharded = got[name][0]["sharded"]
    ref = refs[name]
    for key in ("replicated", "sharded"):
        want = _outputs(ref[key])
        if want is None:
            continue
        assert len(want) == len(sharded)
        for g, w in zip(sharded, want):
            assert _rel(g, w) <= HEBBAX_TOL[name], (name, key, _rel(g, w))
    if name in ("unet", "unet3d_min"):
        assert ref["sharded"] is not None
        np.testing.assert_allclose(
            np.asarray(j_primary(name, ref["sharded"])),
            np.asarray(j_primary(name, ref["replicated"])),
            rtol=1e-5, atol=1e-5)


# -- resizes ----------------------------------------------------------------

@pytest.mark.parametrize("n", [4, 2])
@pytest.mark.parametrize("name", list(resize_cases()))
def test_sharded_resize_equals_the_whole_resize(groups, n, name):
    """An align-corners resize of the sharded axis by 2, 4 or 8 (the other
    axes resized too) gathers to the unsharded resize: output row i reads
    i*(n_in-1)/(n_out-1), not i/factor, so a local resize would be wrong
    away from rank 0.  Trilinear and the bfloat16 matmul form are equal to
    the bit, bilinear within RESIZE_TOL."""
    per_rank = groups[n][2][name]
    for res in per_rank:
        if name.startswith("resize_2d"):
            rel = _rel(res["sharded"], res["plain"])
            assert rel <= RESIZE_TOL, (name, rel)
        else:
            np.testing.assert_array_equal(res["sharded"], res["plain"])


# -- refusals ---------------------------------------------------------------

REFUSALS = {
    "not_divisible": ("ValueError", "not divisible by 2**4"),
    "train_mode": ("RuntimeError", "train mode"),
    "grad_enabled": ("RuntimeError", "torch.no_grad"),
    "flatten_head": ("NotImplementedError", "'flatten'"),
    "adaptive_pool": ("NotImplementedError", "'adaptive_avg_pool2d'"),
    "mean_over_axis": ("NotImplementedError", "'mean'"),
    "ann_vgg": ("NotImplementedError", "'avg_pool2d'"),
    "folded": ("NotImplementedError", "'reshape'"),
    "not_a_shard": ("ValueError", "not a shard"),
    "data_parallel": ("RuntimeError", "data_parallel=False"),
    "odd_pool": ("NotImplementedError", "max pool 3/3"),
}


@pytest.mark.parametrize("n", [4, 2])
@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_raise_naming_the_cause(groups, n, name):
    """Each refused input, mode or op raises on every rank, naming it."""
    kind, words = REFUSALS[name]
    for res in groups[n][2]["refusals"]:
        assert res[name] is not None, name
        assert res[name][0] == kind and words in res[name][1], res[name]


def test_one_rank_without_a_process_group():
    """Without a process group the mode is one rank: halos are the zero
    padding, and ``unet``'s forward is the plain one to the bit."""
    model = get_network("unet", 3, 2, generator=make_generator(1)).eval()
    x = torch.from_numpy(_image(2, (1, 3, 32, 32)))
    with torch.no_grad():
        plain = model(x)
        xr = parallel.shard_spatial(x)
        with parallel.spatial_sharding():
            got = model(xr)
        h = parallel.halo_exchange(xr, 0, 2, 1)
    assert torch.equal(parallel.gather_spatial(got), plain)
    assert torch.equal(h[:, :, 2:-1], x) and not h[:, :, :2].any() \
        and not h[:, :, -1:].any()
