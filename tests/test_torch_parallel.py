"""The port's data parallelism (``hebbax_torch.parallel``) on 2 and 4
gloo CPU ranks, held against hebbax's ``--dp_devices N`` (its step over
``make_mesh(N)`` of the 8-device virtual CPU mesh, the batch sharded with
``P('data')``) and against the port's own single process on the same
padded batch.  The cases follow the lines of ``MULTICHIP_r05.json`` less
the spatial one:

* 4 ranks (this file): sup ``unet``, dice and CE, a batch of 7 padded to
  8; contrastive pretraining with partners across ranks (the global
  permutations hebbax draws); CCT on ``unet_cct`` (hebbax's perturbation
  draws); the dp slider against the plain slider; sup with dropout on;
* 2 ranks (``test_torch_parallel_steps.py``): the swta_t pretraining step
  (the delta merge), hpca, CPS, UAMT (hebbax's teacher and MC noise), DTC
  on a 16-feature ``UNet3DDTC`` at 16^3, and a float64 forward loss.

Weights are carried from hebbax through the bridge; batches are the same
numpy arrays; dropout is off except in the dropout case, which holds the
N-rank run to the single process with the network's own draws (every rank
draws the global batch's mask and keeps its rows).  Draws that hebbax
makes inside a jitted step are recorded from its single-device step with
the same key (``jax.random`` is counter-based, so its sharded step draws
the same numbers) and replayed into the port.

Tolerances.  The ranks agree with each other to the bit.  N ranks vs one
process of the port, where they differ only by the order of their sums:
each training step's float64 twin (``torch_parallel_cases.py``) at rtol
1e-6 on losses (measured 8e-8: they still reduce in float32) and rtol
1e-6 / atol 1e-6 on every parameter and statistic (measured 2.4e-15),
the Hebbian kernels' update (the merged float32 delta at lr 1) within
1e-5 of its scale (measured 1.2e-6); in float32 the 2x2 bottleneck's
train-mode batch norm turns the reordering into ~1e-4 of a one-step
update at lr 1, the amplification the XLA-vs-oneDNN parity tests see.
The float64 loss at 1e-9; the slider's float32 logits at 1e-6.  Port vs
hebbax: those of the existing parity tests (``test_torch_steps.py``,
``test_torch_hebb_steps.py``): losses rtol 1e-4, parameters and BN
statistics rtol 1e-4 / atol 1e-5 after one SGD step at lr 1e-2 (1e-3 for
CPS, as ``test_torch_semi_dual.py``, and for DTC, whose 16^3 input leaves
a one-voxel bottleneck); the Hebbian kernels' update at lr 1 within 1e-3
of its scale, the backprop head's within 2e-3 (measured 1.4e-3, the same
in the port's single process: XLA-vs-oneDNN rounding of the 2x2
bottleneck's train-mode batch norm, ROADMAP Queue 3); the slider 1e-5;
the float64 loss rtol 1e-7 (measured 1.5e-8, the same in the single
process: a float32 constant the port and hebbax round apart).

Each spawned group has a 60 s process-group timeout, a join deadline,
``torch.set_num_threads(1)`` per rank, and runs all of its cases in one
spawn.  ``test_torch_parallel_steps.py`` runs the 2-rank group.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import hebbax.engine.semi as jsemi
import hebbax.models.unet2d as junet
from hebbax.engine.sliding import slide_window_inference_device as j_slide
from hebbax.engine.state import TrainState as JState
from hebbax.engine.steps import make_sup_train_step as j_make_step
from hebbax.hebb.spec import HebbSpec as JSpec
from hebbax.hebb.surgery import pretrain_trainable_mask
from hebbax.models import get_network as j_get_network
from hebbax.models import primary_logits as j_primary
from hebbax.models.unet3d import UNet3DDTC as JUNet3DDTC
from hebbax.ops.losses import segmentation_loss as j_loss
from hebbax.parallel import (batch_sharding, make_mesh, replicate_state,
                             shard_batch)
from hebbax_torch import parallel
from hebbax_torch.bridge import from_flax
from hebbax_torch.hebb.layers import transposed_paths
from hebbax_torch.models.unet3d import UNet3DDTC

import torch_parallel_cases as cases
from test_torch_deep4 import DrawRecorder
from test_torch_hebb_steps import PermRecorder
from test_torch_semi_dual import uamt_noise_of
from test_torch_unet2d import _NoDropout

torch.set_num_threads(2)

TIMEOUT_S = 60
DEADLINE_S = 400
KEY = 5
UNSUP_W = 0.5
SUP_LR = 1e-2


def _j(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _init(jm, x, seed):
    v = _j(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x), train=False))
    return v["params"], v.get("batch_stats") or {}


def _copy(tree):
    return jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), tree)


def _jstate(params, stats, tx):
    p = _copy(params)
    return JState(params=p, batch_stats=_copy(stats) if stats else None,
                  opt_state=tx.init(p), step=0)


def _dual(p1, s1, p2, s2, tx1, tx2=None):
    a, b = _copy(p1), _copy(p2)
    return jsemi.DualState(
        params1=a, batch_stats1=_copy(s1), opt_state1=tx1.init(a),
        params2=b, batch_stats2=_copy(s2),
        opt_state2=None if tx2 is None else tx2.init(b), step=0)


def _sharded(mesh, *batches):
    sh = batch_sharding(mesh)
    return [shard_batch({k: jnp.asarray(v) for k, v in b.items()}, sh)
            for b in batches]


def _single(*batches):
    return [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]


def _sd(params, stats, port_model=None):
    tp = transposed_paths(port_model) if port_model is not None else None
    return {k: v.numpy() for k, v in from_flax(
        _j(params), _j(stats) if stats else None, tp).items()}


def _batch2d(rng, n, size=32, mask=True):
    b = {"image": rng.standard_normal((n, size, size, 3)).astype(
        np.float32)}
    if mask:
        b["mask"] = (rng.random((n, size, size)) < 0.4).astype(np.int32)
    return b


# -- the cases: hebbax's reference and the port's case --------------------

def sup_case(loss, n_ranks):
    rng = np.random.default_rng(1)
    batch = _batch2d(rng, 7)
    jm = junet.UNet2D(in_channels=3, n_cls=2)
    params, stats = _init(jm, batch["image"][:2], 2)
    tx = optax.sgd(SUP_LR)
    step = j_make_step(jm, "unet", j_loss(loss), tx)
    (b,) = _sharded(make_mesh(n_ranks), cases.padded(batch, n_ranks))
    s, out = step(replicate_state(_jstate(params, stats, tx),
                                  make_mesh(n_ranks)), b,
                  jax.random.PRNGKey(KEY))
    ref = {"loss": float(out["loss"]),
           "state": _sd(s.params, s.batch_stats)}
    case = dict(kind="sup", network="unet", loss=loss, lr=SUP_LR,
                n_ranks=n_ranks, batch=batch, state=(params, stats))
    return case, ref


def hebb_case(mode, n_ranks, n=3):
    rng = np.random.default_rng(3)
    batch = _batch2d(rng, n)
    spec = JSpec(mode=mode, k=50.0, w_nrm=True, alpha=1.0,
                 exclude=cases.HEBB_EXCLUDE)
    jm = junet.UNet2D(in_channels=3, n_cls=2, hebb=spec)
    params, stats = _init(jm, batch["image"][:2], 4)
    tx = optax.sgd(1.0)
    step = j_make_step(jm, "unet", j_loss("dice"), tx, hebb_alpha=1.0,
                       trainable_mask=pretrain_trainable_mask(
                           params, spec.exclude),
                       backprop_only=spec.exclude)
    glob = cases.padded(batch, n_ranks)
    perms = []
    if mode == "contrastive":
        mp = pytest.MonkeyPatch()
        try:
            rec = PermRecorder(mp)
            rec_step = j_make_step(jm, "unet", j_loss("dice"), tx,
                                   hebb_alpha=1.0, backprop_only=spec.exclude)
            rec_step(_jstate(params, stats, tx), *_single(glob),
                     jax.random.PRNGKey(KEY))
            jax.effects_barrier()
            perms = rec.perms
        finally:
            mp.undo()
        assert len(perms) == 22
    mesh = make_mesh(n_ranks)
    (b,) = _sharded(mesh, glob)
    s, out = step(replicate_state(_jstate(params, stats, tx), mesh), b,
                  jax.random.PRNGKey(KEY))
    ref = {"loss": float(out["loss"]), "state": _sd(s.params, s.batch_stats),
           "before": _sd(params, stats)}
    case = dict(kind="hebb", network="unet", mode=mode, n_ranks=n_ranks,
                batch=batch, perms=perms, state=(params, stats))
    return case, ref


def cps_case(n_ranks):
    rng = np.random.default_rng(5)
    sup, unsup = _batch2d(rng, 3), _batch2d(rng, 3, mask=False)
    jm = junet.UNet2D(in_channels=3, n_cls=2)
    p1, s1 = _init(jm, sup["image"][:2], 6)
    p2, s2 = _init(jm, sup["image"][:2], 7)
    lr = 1e-3
    tx1, tx2 = optax.sgd(lr), optax.sgd(lr)
    step = jsemi.make_cps_step(jm, jm, "unet", j_loss("dice"), tx1, tx2)
    mesh = make_mesh(n_ranks)
    bs, bu = _sharded(mesh, cases.padded(sup, n_ranks),
                      cases.padded(unsup, n_ranks))
    s, out = step(replicate_state(_dual(p1, s1, p2, s2, tx1, tx2), mesh),
                  bs, bu, jnp.float32(UNSUP_W), jax.random.PRNGKey(KEY))
    ref = {k: float(out[k]) for k in ("loss", "loss_sup", "loss_unsup")}
    ref["state1"] = _sd(s.params1, s.batch_stats1)
    ref["state2"] = _sd(s.params2, s.batch_stats2)
    case = dict(kind="cps", network="unet", lr=lr, n_ranks=n_ranks,
                sup=sup, unsup=unsup, unsup_weight=UNSUP_W,
                state=(p1, s1), state2=(p2, s2))
    return case, ref


def uamt_case(n_ranks):
    rng = np.random.default_rng(8)
    sup, unsup = _batch2d(rng, 3), _batch2d(rng, 3, mask=False)
    jm = junet.UNet2D(in_channels=3, n_cls=2)
    p, st = _init(jm, sup["image"][:2], 9)
    tx = optax.sgd(1e-2)
    epochs, epoch = 10, 3
    step = jsemi.make_uamt_step(jm, "unet", j_loss("dice"), tx, 2, epochs)
    glob_u = cases.padded(unsup, n_ranks)
    mesh = make_mesh(n_ranks)
    bs, bu = _sharded(mesh, cases.padded(sup, n_ranks), glob_u)
    key = jax.random.PRNGKey(KEY)
    s, out = step(replicate_state(_dual(p, st, p, st, tx), mesh), bs, bu,
                  jnp.float32(UNSUP_W), jnp.float32(epoch), key)
    ref = {k: float(out[k]) for k in ("loss", "loss_sup", "loss_unsup")}
    ref["state1"] = _sd(s.params1, s.batch_stats1)
    ref["state2"] = _sd(s.params2, s.batch_stats2)
    noise = uamt_noise_of(key, glob_u["image"].shape).numpy()
    case = dict(kind="uamt", network="unet", lr=1e-2, n_ranks=n_ranks,
                sup=sup, unsup=unsup, unsup_weight=UNSUP_W,
                num_epochs=epochs, epoch=epoch, noise=noise,
                state=(p, st))
    return case, ref


def cct_case(n_ranks):
    rng = np.random.default_rng(10)
    sup, unsup = _batch2d(rng, 4), _batch2d(rng, 4, mask=False)
    jm = junet.UNetCCT2D(in_channels=3, n_cls=2)
    p, st = _init(jm, sup["image"][:2], 11)
    tx = optax.sgd(1e-2)
    dice = j_loss("dice")
    glob_s, glob_u = (cases.padded(sup, n_ranks),
                      cases.padded(unsup, n_ranks))
    key = jax.random.PRNGKey(KEY)
    mp = pytest.MonkeyPatch()
    try:
        rec = DrawRecorder(mp)
        rec_step = jsemi.make_semi_step(jm, "unet_cct", dice, tx,
                                        jsemi.cct_unsup,
                                        jsemi.deep4_sup(dice))
        rec_step(_jstate(p, st, tx), *_single(glob_s, glob_u),
                 jnp.float32(UNSUP_W), key)
        jax.effects_barrier()
        records = list(rec.records)
    finally:
        mp.undo()
    assert len(records) == 6
    forwards = [[(kind, [d.numpy() for d in draws])
                 for kind, draws in records[i:i + 3]] for i in (0, 3)]
    forwards = [[(k, [torch.from_numpy(d) for d in ds]) for k, ds in f]
                for f in forwards]
    step = jsemi.make_semi_step(jm, "unet_cct", dice, tx, jsemi.cct_unsup,
                                jsemi.deep4_sup(dice))
    mesh = make_mesh(n_ranks)
    bs, bu = _sharded(mesh, glob_s, glob_u)
    s, out = step(replicate_state(_jstate(p, st, tx), mesh), bs, bu,
                  jnp.float32(UNSUP_W), key)
    ref = {k: float(out[k]) for k in ("loss", "loss_sup", "loss_unsup")}
    ref["state1"] = _sd(s.params, s.batch_stats)
    case = dict(kind="semi", algo="cct", network="unet_cct", lr=1e-2,
                n_ranks=n_ranks, sup=sup, unsup=unsup, unsup_weight=UNSUP_W,
                cct_draws=forwards, state=(p, st))
    return case, ref


def dtc_case(n_ranks):
    rng = np.random.default_rng(12)
    n, size = 3, 16
    sup = {"image": rng.random((n, size, size, size, 1)).astype(np.float32),
           "mask": rng.integers(0, 2, (n, size, size, size)).astype(
               np.int32),
           "mask_sdf": (rng.random((n, size, size, size)) * 2 - 1).astype(
               np.float32)}
    unsup = {"image": rng.random((n, size, size, size, 1)).astype(
        np.float32)}
    jm = JUNet3DDTC(1, 2, init_features=16)
    p, st = _init(jm, sup["image"][:1], 13)
    tx = optax.sgd(1e-3)
    dice = j_loss("dice")
    step = jsemi.make_semi_step(jm, "unet3d_dtc", dice, tx, jsemi.dtc_unsup,
                                jsemi.dtc_sup(dice, beta=0.3))
    mesh = make_mesh(n_ranks)
    bs, bu = _sharded(mesh, cases.padded(sup, n_ranks),
                      cases.padded(unsup, n_ranks))
    s, out = step(replicate_state(_jstate(p, st, tx), mesh), bs, bu,
                  jnp.float32(UNSUP_W), jax.random.PRNGKey(KEY))
    ref = {k: float(out[k]) for k in ("loss", "loss_sup", "loss_unsup")}
    ref["state1"] = _sd(s.params, s.batch_stats,
                        UNet3DDTC(1, 2, init_features=16))
    case = dict(kind="semi", algo="dtc", network="unet3d_dtc16", lr=1e-3,
                in_channels=1, n_ranks=n_ranks, sup=sup, unsup=unsup,
                unsup_weight=UNSUP_W, state=(p, st))
    return case, ref


def slider_case(n_ranks):
    rng = np.random.default_rng(14)
    vol = rng.random((24, 24, 20)).astype(np.float32)
    jm = j_get_network("unet3d_min", 1, 2)
    p, st = _init(jm, np.zeros((1, 16, 16, 16, 1), np.float32), 15)
    variables = {"params": p}
    if st:
        variables["batch_stats"] = st

    def fwd(patches, vs):
        return j_primary("unet3d_min", jm.apply(vs, patches, train=False))

    kw = dict(patch_size=(16, 16, 16), overlap=(8, 8, 8), n_cls=2,
              batch_size=n_ranks, fwd_args=(variables,))
    got = j_slide(fwd, vol, mesh=make_mesh(n_ranks), **kw)
    ref = {"logits": np.moveaxis(np.asarray(got), -1, 0)}
    case = dict(kind="slider", network="unet3d_min", in_channels=1,
                n_ranks=n_ranks, volume=vol, patch=(16, 16, 16),
                overlap=(8, 8, 8), batch_size=n_ranks, state=(p, st))
    return case, ref


def f64_case(n_ranks):
    rng = np.random.default_rng(16)
    batch = _batch2d(rng, 2 * n_ranks)
    jm = junet.UNet2D(in_channels=3, n_cls=2)
    p, st = _init(jm, batch["image"][:2], 17)
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), p)
        s64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), st)

        @jax.jit
        def loss64(params, stats, img, mask):
            logits = j_primary("unet", jm.apply(
                {"params": params, "batch_stats": stats}, img,
                train=False)).astype(jnp.float64)
            onehot = jax.nn.one_hot(mask, 2, dtype=jnp.float64)
            logp = jax.nn.log_softmax(logits, axis=-1)
            return -jnp.mean(jnp.sum(onehot * logp, axis=-1))

        mesh = make_mesh(n_ranks)
        rep = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
        shd = batch_sharding(mesh)
        ref = {"loss": float(loss64(
            jax.device_put(p64, rep), jax.device_put(s64, rep),
            jax.device_put(jnp.asarray(batch["image"], jnp.float64), shd),
            jax.device_put(jnp.asarray(batch["mask"]), shd)))}
    case = dict(kind="f64", network="unet", n_ranks=n_ranks, batch=batch,
                state=(p, st))
    return case, ref


def dropout_case(n_ranks):
    """sup ``unet`` with dropout on (port only: the streams differ from
    hebbax's by design)."""
    rng = np.random.default_rng(18)
    batch = _batch2d(rng, 5)
    jm = junet.UNet2D(in_channels=3, n_cls=2)
    params, stats = _init(jm, batch["image"][:2], 19)
    case = dict(kind="sup", network="unet", loss="dice", lr=1.0,
                n_ranks=n_ranks, batch=batch, state=(params, stats),
                dropout_seed=23)
    return case, None


GROUP = {"sup_dice": lambda: sup_case("dice", 4),
         "sup_ce": lambda: sup_case("crossentropy", 4),
         "contrastive": lambda: hebb_case("contrastive", 4, n=4),
         "cct": lambda: cct_case(4),
         "slider": lambda: slider_case(4),
         "dropout": lambda: dropout_case(4)}


def run_group(group, n_ranks):
    """{name: (case, hebbax's result, the port's single-process result,
    every rank's result)} for the cases of ``group``, all in one spawn of
    ``n_ranks`` ranks."""
    mp = pytest.MonkeyPatch()
    mp.setattr(junet, "FastDropout", _NoDropout)
    try:
        built = {name: make() for name, make in group.items()}
    finally:
        mp.undo()
    names = list(built)
    todo = [built[k][0] for k in names]
    single = cases.run_cases(todo)
    ranks = parallel.run_ranks(cases.run_cases, n_ranks, (todo,),
                               timeout=TIMEOUT_S, deadline=DEADLINE_S,
                               threads=1)
    return {k: (built[k][0], built[k][1], single[i], [r[i] for r in ranks])
            for i, k in enumerate(names)}


def _ranks_agree(per_rank):
    """Every rank holds the same losses and state, to the bit."""
    first = per_rank[0]
    for other in per_rank[1:]:
        for k, v in first.items():
            if k == "double":
                _ranks_agree([v, other[k]])
            elif isinstance(v, dict):
                for name, t in v.items():
                    np.testing.assert_array_equal(other[k][name], t,
                                                  err_msg=name)
            else:
                np.testing.assert_array_equal(other[k], v, err_msg=k)


def _update_close(got, ref, before, tol, keys):
    """Each tensor's update (state - before) within ``tol`` of its
    largest |value|."""
    for k in keys:
        want = np.asarray(ref[k], np.float64) - before[k]
        have = np.asarray(got[k], np.float64) - before[k]
        scale = float(np.abs(want).max()) or 1.0
        err = float(np.abs(have - want).max()) / scale
        assert err <= tol, (k, err)


def _hebbian_kernels(before):
    return [k for k in before if not k.startswith("out_conv.")
            and k.endswith(".weight") and before[k].ndim == 4]


def _exact(got, single, rtol, before=None):
    """N ranks vs one process of the port on the same padded batch; with
    ``before`` (a Hebbian step) the kernels' updates, the merged float32
    deltas, within 1e-5 of their scale."""
    kernels = _hebbian_kernels(before) if before is not None else ()
    for k, v in single.items():
        if k == "double":
            continue
        if isinstance(v, dict):
            _update_close(got[k], v, before, 1e-5, kernels)
            for n, t in v.items():
                if n not in kernels:
                    np.testing.assert_allclose(got[k][n], t, rtol=rtol,
                                               atol=1e-6, err_msg=n)
        else:
            np.testing.assert_allclose(got[k], v, rtol=rtol, atol=0,
                                       err_msg=k)


def check_case(case, ref, single, per_rank):
    """The module docstring's checks of one case."""
    _ranks_agree(per_rank)
    got = per_rank[0]
    if "double" in single:      # a training step: its float64 twin
        _exact(got["double"], single["double"], 1e-6,
               ref["before"] if case["kind"] == "hebb" else None)
    elif case["kind"] == "f64":
        _exact(got, single, 1e-9)
    else:                       # the slider
        np.testing.assert_allclose(got["logits"], single["logits"],
                                   rtol=1e-6, atol=1e-6)
    if ref is None:         # dropout: the port's own draws, no hebbax twin
        return
    # N ranks vs hebbax's --dp_devices N
    if case["kind"] == "f64":
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-7)
        return
    if case["kind"] == "slider":
        np.testing.assert_allclose(got["logits"], ref["logits"], rtol=1e-5,
                                   atol=1e-5)
        return
    for k in ("loss", "loss_sup", "loss_unsup"):
        if k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)
    if case["kind"] == "hebb":
        before = ref["before"]
        kernels = _hebbian_kernels(before)
        _update_close(got["state"], ref["state"], before, 1e-3, kernels)
        stats = [k for k in before if k.endswith(("running_mean",
                                                  "running_var"))]
        for k in stats:
            np.testing.assert_allclose(got["state"][k], ref["state"][k],
                                       rtol=1e-4, atol=1e-5, err_msg=k)
        head = [k for k in before if k.startswith("out_conv.")]
        _update_close(got["state"], ref["state"], before, 2e-3, head)
        return
    for key in ("state", "state1", "state2"):
        if key in ref:
            for n, t in ref[key].items():
                np.testing.assert_allclose(got[key][n], t, rtol=1e-4,
                                           atol=1e-5, err_msg=n)


@pytest.fixture(scope="module")
def runs():
    return run_group(GROUP, 4)


@pytest.mark.parametrize("name", list(GROUP))
def test_four_ranks_match_one_process_and_hebbax(runs, name):
    check_case(*runs[name])
