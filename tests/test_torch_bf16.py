"""``--dtype bfloat16`` in the port held against hebbax's ``dtype=`` on the
CPU: the same seeded numpy inputs and weights (carried by
``hebbax_torch.bridge``) through both packages at bfloat16.

What bf16 means in both: parameters and BN statistics stay float32; a
conv casts its (normalized) float32 weight and its input to bf16,
convolves and adds the bf16 bias after the conv; a batch norm takes its
statistics and normalizes in float32 and casts the result; the
segmentation losses upcast the logits.  So the two packages run the same
graph of bf16 roundings, and single operations agree to the bit or one
ulp (``test_component_*``); a network's output differs where XLA's and
oneDNN's convolutions round an element the other way (one bf16 ulp,
2^-8 relative) and that difference travels through the later layers.

Gates (set from the largest values measured on this CPU, given beside
each):

* forwards (eval and train mode, dropout off; CCT with hebbax's draws,
  the VAEs with eps = 0): max |port - hebbax| <= 3e-2 * max(1,
  max|hebbax|) in eval mode (measured 2.3e-2, ``unet_superpix``).  In
  train mode the batch norms normalize over the few values of the
  deepest levels (2x2 per image in 2D at 32x32, one voxel in 3D at
  16^3), which turns one-ulp differences into larger ones: max <= 2e-1
  of scale (measured 1.42e-1, ``unet3d_cct``'s third perturbed pass) and
  mean <= 1.5e-2 of scale (measured 9.4e-3).  Every such miss was below
  the port's own bf16-vs-float32 distance but one (``unet3d_vae``'s eval
  ``log_var``: 9.8e-4 against 8.7e-4).  The port's bf16 output differs
  from its float32 output by more than 1e-4 (the cast happens), and a
  train forward leaves every parameter and BN statistic float32;
* single operations: batch norm and the resize equal to the bit
  (measured), instance norm within two bf16 ulps (XLA fuses its three
  bf16 operations; measured: 2 ulps in up to 38% of the elements);
* the Hebbian deltas of one bf16 training forward (swta_t, K = 50; 2D at
  32x32, 3D at 32^3): each site's relative L2 miss <= 2e-1 (measured
  1.36e-1 at ``main_decoder.up2.conv1x1``).  K = 50 turns one bf16 ulp of
  y (4e-3 relative) into a change of a few percent in the softmax;
* two steps (the first at lr 0) of ``train_sup_2d`` / ``train_sup_3d`` /
  EM / UAMT: losses within 1e-2 relative (measured 4.4e-3), and the
  relative L2 miss of the parameters' travel over the whole model <= 5e-1
  (measured 0.37).  A bf16 gradient on these small batches is mostly
  rounding: hebbax's own bf16 gradient misses its float32 one by 0.3 to
  1.1 of each tensor's scale.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

import hebbax.engine.semi as jsemi
import hebbax.models.ddpm as jddpm
import hebbax.models.snn as jsnn
import hebbax.models.unet2d as junet
import hebbax.models.unet3d as j3d
import hebbax.models.urpc3d as jurpc
from hebbax.config.schedules import make_optimizer as j_make_optimizer
from hebbax.config.schedules import warmup_step_schedule
from hebbax.engine.state import TrainState as JState
from hebbax.engine.steps import make_sup_train_step as j_make_step
from hebbax.hebb.spec import HebbSpec as JSpec
from hebbax.models.common import batch_norm as j_batch_norm
from hebbax.models.common import instance_norm as j_instance_norm
from hebbax.models.common import resize_linear_align_corners as j_resize
from hebbax.ops.losses import dice_loss as j_dice
from hebbax_torch import bridge
from hebbax_torch.config.schedules import WarmupStepLR, make_optimizer
from hebbax_torch.engine import semi
from hebbax_torch.engine.state import TrainState
from hebbax_torch.engine.steps import make_sup_train_step
from hebbax_torch.hebb.layers import transposed_paths
from hebbax_torch.hebb.spec import HebbSpec
from hebbax_torch.hebb.surgery import pop_deltas
from hebbax_torch.models import common as tcommon
from hebbax_torch.models import ddpm as tddpm
from hebbax_torch.models import snn as tsnn
from hebbax_torch.models import unet2d as tunet
from hebbax_torch.models import unet3d as t3d
from hebbax_torch.models import urpc3d as turpc
from hebbax_torch.ops.dropout import Dropout
from hebbax_torch.ops.losses import dice_loss

import test_torch_deep4
from test_torch_3d_semi_nets import _LinenNoDropout
from test_torch_deep4 import DrawRecorder
from test_torch_semi_dual import uamt_noise_of
from test_torch_unet2d import _NoDropout
from test_torch_unsup2d import ddpm_variables

torch.set_num_threads(2)

BF16 = torch.bfloat16
F3D = 8                         # initial features of the 3D networks
EVAL_TOL, TRAIN_TOL, TRAIN_MEAN_TOL = 3e-2, 2e-1, 1.5e-2
DELTA_TOL = 2e-1

# name -> (hebbax class, port class, constructor keywords, input channels)
NETS = {
    "unet": (junet.UNet2D, tunet.UNet2D, {}, 3),
    "unet_urpc": (junet.UNetURPC2D, tunet.UNetURPC2D, {}, 3),
    "unet_cct": (junet.UNetCCT2D, tunet.UNetCCT2D, {}, 3),
    "unet_vae": (junet.UNetVAE2D, tunet.UNetVAE2D, {}, 3),
    "unet_superpix": (junet.UNetSuperpix2D, tunet.UNetSuperpix2D, {}, 3),
    "unet_ddpm": (jddpm.DDPMUNet, tddpm.DDPMUNet, {}, 3),
    "ann_vgg": (jsnn.ANNVGG, tsnn.ANNVGG, {}, 3),
    "unet3d_min": (j3d.UNet3D, t3d.UNet3D, {"init_features": 32}, 1),
    "unet3d_dtc": (j3d.UNet3DDTC, t3d.UNet3DDTC, {"init_features": F3D}, 1),
    "unet3d_cct": (j3d.UNet3DCCT, t3d.UNet3DCCT, {"init_features": F3D}, 1),
    "unet3d_urpc": (jurpc.UNet3DURPC, turpc.UNet3DURPC, {}, 1),
    "unet3d_vae": (j3d.UNet3DVAE, t3d.UNet3DVAE, {"init_features": F3D}, 1),
    "unet3d_superpix": (j3d.UNet3DSuperpix, t3d.UNet3DSuperpix,
                        {"init_features": F3D}, 1),
}


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(junet, "FastDropout", _NoDropout)
    monkeypatch.setattr(jurpc, "nn", _LinenNoDropout())


def bf16_port_draw(kind, d):
    """test_torch_semi_ops.port_draw for draws that may be bf16 (numpy
    holds them as ml_dtypes' bfloat16): the same layout, the dtype kept."""
    d = np.asarray(d)
    bf = d.dtype.name == "bfloat16"
    t = torch.from_numpy(np.array(d.astype(np.float32) if bf else d))
    if kind == "noise":
        t = t.movedim(-1, 0).contiguous()
    elif kind == "dropout":
        t = t.movedim(-1, 1).contiguous()
    return t.to(BF16) if bf else t


def to_t(x):
    """NHWC / NDHWC numpy -> channels-first tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def to_np(t):
    """A channels-first tensor (any float dtype) -> channels-last float32
    numpy."""
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


def jnp32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def flat_outputs(o):
    if isinstance(o, dict):
        return [o[k] for k in sorted(o)]
    if isinstance(o, (tuple, list)):
        return list(o)
    return [o]


def _port(name, variables, dtype, hebb=None):
    _, tcls, kw, in_ch = NETS[name]
    tm = tcls(in_ch, 2, hebb=hebb, device="cpu", dtype=dtype, **kw) \
        if name != "ann_vgg" else tcls(in_ch, 2, device="cpu", dtype=dtype)
    tm.load_state_dict(bridge.from_flax(variables["params"],
                                        variables.get("batch_stats"),
                                        transposed_paths(tm)))
    for m in tm.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return tm


def make_pair(name, seed=0, jspec=None, tspec=None, side=None):
    """(hebbax bf16 model, numpy variables, port bf16 model, port f32
    model, numpy input, extra call arguments)."""
    jcls, _, kw, in_ch = NETS[name]
    nd = 3 if "3d" in name else 2
    shape = (2,) + (side or 16,) * 3 if nd == 3 else (2, 32, 32)
    rng = np.random.default_rng(seed)
    if name == "ann_vgg":
        jm = jcls(in_channels=in_ch, n_cls=2, dtype=jnp.bfloat16)
    else:
        jm = jcls(in_channels=in_ch, n_cls=2, hebb=jspec,
                  dtype=jnp.bfloat16, **kw)
    key = jax.random.PRNGKey(seed)
    extra = {}
    if name == "unet_ddpm":
        x = rng.standard_normal(shape + (in_ch + 2,)).astype(np.float32)
        variables = ddpm_variables(jm, key)
        extra = {"t": np.array([3, 700], np.int32), "mode": "net"}
    else:
        x = rng.standard_normal(shape + (in_ch,)).astype(np.float32)
        variables = jm.init(key, jnp.asarray(x), train=False)
    variables = dict(jax.tree_util.tree_map(np.asarray, variables))
    return (jm, variables, _port(name, variables, BF16, tspec),
            _port(name, variables, None, tspec), x, extra)


def j_apply(jm, variables, x, extra, train, rngs=None):
    args = (jnp.asarray(x),)
    kw = {"train": train}
    if extra:
        args += (jnp.asarray(extra["t"]),)
        kw["mode"] = extra["mode"]
    if train:
        return jm.apply(variables, *args, mutable=["batch_stats", "hebb"],
                        rngs=rngs or {}, **kw)
    return jm.apply(variables, *args, **kw), None


def t_apply(tm, x, extra, train):
    tm.train(train)
    with torch.no_grad():
        if extra:
            return tm(to_t(x), torch.from_numpy(extra["t"]).long(),
                      mode=extra["mode"])
        return tm(to_t(x))


def _float32_state(tm):
    return all(t.dtype == torch.float32 for t in
               list(tm.parameters()) + list(tm.buffers()))


# -- the networks' forwards ---------------------------------------------------

@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", list(NETS))
def test_bf16_forward_matches(no_dropout, monkeypatch, name, train):
    """The forward gates of the module docstring."""
    jm, variables, tm, tm32, x, extra = make_pair(name, seed=3)
    cct = name in ("unet_cct", "unet3d_cct") and train
    if cct:
        monkeypatch.setattr(test_torch_deep4, "port_draw", bf16_port_draw)
        rec = DrawRecorder(monkeypatch,
                           module=junet if name == "unet_cct" else j3d)
    ref, _ = j_apply(jm, variables, x, extra, train,
                     {"perturb": jax.random.PRNGKey(6),
                      "dropout": jax.random.PRNGKey(5)})
    if cct:
        jax.effects_barrier()
        records = list(rec.records)
        DrawRecorder(records=list(records)).install(tm)
        DrawRecorder(records=list(records)).install(tm32)
    got = flat_outputs(t_apply(tm, x, extra, train))
    got32 = flat_outputs(t_apply(tm32, x, extra, train))
    ref = flat_outputs(ref)
    assert len(got) == len(ref)
    for i, (g, r, g32) in enumerate(zip(got, ref, got32)):
        assert str(g.dtype).split(".")[-1] == str(r.dtype), (i, g.dtype,
                                                            r.dtype)
        r = jnp32(r)
        scale = max(1.0, float(np.abs(r).max()))
        err = np.abs(to_np(g) - r)
        tol = TRAIN_TOL if train else EVAL_TOL
        assert err.max() <= tol * scale, (i, err.max() / scale)
        if train:
            assert err.mean() <= TRAIN_MEAN_TOL * scale, (i, err.mean()
                                                          / scale)
        cast = float((g.float() - g32.float()).abs().max())
        assert cast > 1e-4, (i, cast)
    if train:
        assert _float32_state(tm)


# -- single operations: one ulp 

def _ulp(ref):
    """One bf16 ulp of each element of ``ref`` (8 significant bits)."""
    mag = np.maximum(np.abs(ref), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _bf16_input(seed, shape, scale=2.0, shift=0.5):
    x = np.random.default_rng(seed).standard_normal(shape) * scale + shift
    return jnp32(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("nd", [2, 3])
def test_component_batch_norm(nd, train):
    """flax ``BatchNorm(dtype=bfloat16)`` (statistics and normalization
    in float32, the result cast) against the port's; measured: equal to
    the bit."""
    from flax import linen as fnn

    class BN(fnn.Module):
        @fnn.compact
        def __call__(self, x, train):
            return j_batch_norm(self, x, train, "bn", 0.02, jnp.bfloat16)

    x = _bf16_input(1, (2,) + (6,) * nd + (8,))
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    variables = BN().init(jax.random.PRNGKey(2), xj, False)
    if train:
        ref, mut = BN().apply(variables, xj, True, mutable=["batch_stats"])
    else:
        ref = BN().apply(variables, xj, False)
    tb = (tcommon.BatchNorm2d if nd == 2 else tcommon.BatchNorm3d)(8)
    tb.compute_dtype = BF16
    with torch.no_grad():
        tb.weight.copy_(torch.from_numpy(np.asarray(
            variables["params"]["bn"]["scale"])))
    tb.train(train)
    with torch.no_grad():
        got = tb(to_t(x).to(BF16))
    assert got.dtype == BF16 and str(ref.dtype) == "bfloat16"
    r = jnp32(ref)
    assert np.all(np.abs(to_np(got) - r) <= _ulp(r))
    if train:
        np.testing.assert_allclose(
            tb.running_var.numpy(),
            np.asarray(mut["batch_stats"]["bn"]["var"]), rtol=1e-6)
        assert tb.running_mean.dtype == torch.float32


@pytest.mark.parametrize("src,dst", [((5, 7), (9, 13)), ((4, 4), (8, 8)),
                                     ((3, 5, 4), (6, 10, 8))])
def test_component_resize(src, dst):
    """hebbax's per-axis matmul resize in bf16 (the interpolation matrix
    cast to bf16, a rounding after every axis) against the port's;
    measured: equal to the bit."""
    x = _bf16_input(3, (2,) + src + (3,), 1.0, 0.0)
    ref = jnp32(j_resize(jnp.asarray(x).astype(jnp.bfloat16), dst))
    got = tcommon.resize_linear_align_corners(to_t(x).to(BF16), dst)
    assert got.dtype == BF16
    assert np.all(np.abs(to_np(got) - ref) <= _ulp(ref))


@pytest.mark.parametrize("shape", [(2, 6, 7, 5, 4), (2, 9, 9, 3)])
def test_component_instance_norm(shape):
    """hebbax's instance norm on bf16 (``jnp.mean`` / ``jnp.var`` reduce
    in float32 and return bf16; the normalization runs in bf16) against
    the port's.  The statistics are equal to the bit; XLA fuses the
    normalization's three bf16 operations, so up to 38% of the
    elements differ, by two ulps at most (measured)."""
    x = _bf16_input(4, shape)
    ref = jnp32(j_instance_norm(jnp.asarray(x).astype(jnp.bfloat16)))
    got = tcommon.instance_norm(to_t(x).to(BF16))
    assert got.dtype == BF16
    assert np.all(np.abs(to_np(got) - ref) <= 2 * _ulp(ref))


# -- the bf16 Hebbian deltas 

EXCLUDE_3D = ("conv",)


@pytest.mark.parametrize("name,sites", [("unet", 22), ("unet3d_min", 22)])
def test_bf16_hebbian_deltas_match(no_dropout, count_deltas_bf16, name,
                                   sites):
    """One bf16 training forward of swta_t pretraining (K = 50, the head
    excluded): every site's delta, computed in float32 from the
    bf16-rounded x and y, within a relative L2 miss of 2e-1 of hebbax's
    (measured: 2D 1.36e-1, 3D 8.6e-2)."""
    kw = dict(mode="swta_t", k=50.0, w_nrm=True, alpha=1.0,
              exclude=("out_conv",) if name == "unet" else EXCLUDE_3D)
    jm, variables, tm, _, x, _ = make_pair(name, seed=5, jspec=JSpec(**kw),
                                           tspec=HebbSpec(**kw), side=32)
    _, mut = j_apply(jm, variables, x, {}, True,
                     {"dropout": jax.random.PRNGKey(5)})
    t_apply(tm, x, {}, True)
    got = pop_deltas(tm)
    assert len(count_deltas_bf16) == sites
    assert all(d.dtype == torch.float32 for d in got.values())
    tp = transposed_paths(tm)
    ref = {}
    for p, v in traverse_util.flatten_dict(mut["hebb"]).items():
        mod = ".".join(p[:-1])
        nd = v.ndim - 2
        perm = ((nd + 1, nd) if mod not in tp else (nd, nd + 1)) \
            + tuple(range(nd))
        ref[mod + ".weight"] = np.transpose(np.asarray(v), perm)
    assert set(got) == set(ref) and len(got) == sites
    for n, d in got.items():
        miss = (np.linalg.norm(d.numpy() - ref[n])
                / np.linalg.norm(ref[n]))
        assert miss <= DELTA_TOL, (n, miss)


@pytest.fixture
def count_deltas_bf16(monkeypatch):
    """The x and y each Hebbian site hands the delta: float32 copies."""
    from hebbax_torch.hebb import rules
    calls = []
    orig = rules.compute_delta

    def counted(spec, w, x, y, *a, **k):
        assert w.dtype == x.dtype == y.dtype == torch.float32
        calls.append(1)
        return orig(spec, w, x, y, *a, **k)

    monkeypatch.setattr(rules, "compute_delta", counted)
    return calls


# -- bf16 steps 

LR = 1e-2
N_STEPS = 2     # warmup 1: step 0 trains at lr 0, step 1 at LR
STEP_LOSS_RTOL, STEP_TRAVEL_TOL = 1e-2, 5e-1


def _j_sgd():
    return j_make_optimizer("sgd", warmup_step_schedule(
        LR, warmup=1, step_size=50, gamma=0.5, steps_per_epoch=1),
        momentum=0.9, weight_decay=5e-5)


def _t_sgd(tm):
    return (make_optimizer("sgd", tm.parameters(), momentum=0.9,
                           weight_decay=5e-5),
            WarmupStepLR(LR, warmup=1, step_size=50, gamma=0.5,
                         steps_per_epoch=1))


def _batches(seed, name):
    rng = np.random.default_rng(seed)
    shape = (2,) + (32,) * 3 if "3d" in name else (2, 32, 32)
    ch = NETS[name][3]
    return [(rng.standard_normal(shape + (ch,)).astype(np.float32),
             (rng.random(shape) < 0.4).astype(np.int32),
             rng.standard_normal(shape + (ch,)).astype(np.float32))
            for _ in range(N_STEPS)]


def _travel_miss(before, jparams, tm):
    """The port's parameter travel (after - before) against hebbax's, as
    the relative L2 norm of the miss over every parameter together;
    parameters stay float32."""
    sd = tm.state_dict()
    tp = transposed_paths(tm)
    miss, ref = 0.0, 0.0
    for path, v in traverse_util.flatten_dict(jparams).items():
        mod = ".".join(path[:-1])
        v = np.asarray(v)
        if path[-1] == "kernel":
            nd = v.ndim - 2
            perm = ((nd + 1, nd) if mod not in tp else (nd, nd + 1)) \
                + tuple(range(nd))
            name, v = mod + ".weight", np.transpose(v, perm)
        else:
            name = mod + (".weight" if path[-1] == "scale" else ".bias")
        assert sd[name].dtype == torch.float32
        travel_j = v - before[name]
        miss += float(np.sum((sd[name].numpy() - before[name]
                              - travel_j) ** 2))
        ref += float(np.sum(travel_j ** 2))
    assert ref > 0.0
    return math.sqrt(miss / ref)


@pytest.mark.parametrize("name", ["unet", "unet3d_min"])
def test_bf16_sup_steps_match(no_dropout, name):
    """``train_sup_2d`` / ``train_sup_3d``'s step at bf16 (dice, SGD):
    the losses (measured within 6.4e-4 relative) and the parameters'
    travel (relative L2 miss measured at 0.29 in 2D)."""
    jm, variables, tm, _, _, _ = make_pair(name, seed=7, side=32)
    before = {k: v.detach().clone().numpy()
              for k, v in tm.state_dict().items()}
    tx = _j_sgd()
    jstep = j_make_step(jm, name, j_dice, tx)
    jstate = JState(params=variables["params"],
                    batch_stats=variables["batch_stats"],
                    opt_state=tx.init(variables["params"]), step=0)
    opt, sched = _t_sgd(tm)
    state = TrainState(model=tm, optimizer=opt, schedule=sched)
    tstep = make_sup_train_step(tm, name, dice_loss)
    for i, (x, m, _) in enumerate(_batches(8, name)):
        jstate, jo = jstep(jstate, {"image": jnp.asarray(x),
                                    "mask": jnp.asarray(m)},
                           jax.random.PRNGKey(i))
        state, to = tstep(state, {"image": to_t(x),
                                  "mask": torch.from_numpy(m).long()})
        assert to["logits"].dtype == BF16
        np.testing.assert_allclose(float(to["loss"]), float(jo["loss"]),
                                   rtol=STEP_LOSS_RTOL)
    assert _travel_miss(before, jstate.params, tm) <= STEP_TRAVEL_TOL


@pytest.mark.parametrize("algo", ["em", "uamt"])
def test_bf16_semi_steps_match(no_dropout, algo):
    """EM and UAMT steps on ``unet`` at bf16 (unsup weight 0.7, UAMT with
    hebbax's noises): every loss (measured within 4.4e-3 relative) and
    the parameters' travel, UAMT's teacher included (measured 0.37)."""
    jm, v1, tm, _, _, _ = make_pair("unet", seed=9)
    before = {k: v.detach().clone().numpy()
              for k, v in tm.state_dict().items()}
    tx = _j_sgd()
    opt, sched = _t_sgd(tm)
    batches = _batches(10, "unet")
    keys = ("loss", "loss_sup", "loss_unsup")
    if algo == "em":
        jstep = jsemi.make_semi_step(jm, "unet", j_dice, tx,
                                     jsemi.em_unsup(2))
        jstate = JState(params=v1["params"], batch_stats=v1["batch_stats"],
                        opt_state=tx.init(v1["params"]), step=0)
        state = TrainState(model=tm, optimizer=opt, schedule=sched)
        tstep = semi.make_semi_step(tm, "unet", dice_loss,
                                    semi.em_unsup(2))
        extra_j, extra_t = (lambda i: ()), (lambda i: ())
    else:
        _, v2, teacher, _, _, _ = make_pair("unet", seed=10)
        jstep = jsemi.make_uamt_step(jm, "unet", j_dice, tx, 2, 3,
                                     ema_decay=0.99, mc_T=8)
        jstate = jsemi.DualState(
            params1=v1["params"], batch_stats1=v1["batch_stats"],
            opt_state1=tx.init(v1["params"]), params2=v2["params"],
            batch_stats2=v2["batch_stats"], step=0)
        state = semi.DualState(model1=tm, optimizer1=opt, schedule1=sched,
                               model2=teacher)
        tstep = semi.make_uamt_step(tm, teacher, "unet", dice_loss, 3,
                                    ema_decay=0.99, mc_T=8)
        extra_j = lambda i: (jnp.float32(i),)                  # noqa: E731
        extra_t = lambda i: (i, uamt_noise_of(                 # noqa: E731
            jax.random.PRNGKey(i), (2, 32, 32, 3)))
        before2 = {k: v.detach().clone().numpy()
                   for k, v in teacher.state_dict().items()}
    for i, (xs, ms, xu) in enumerate(batches):
        jstate, jo = jstep(jstate, {"image": jnp.asarray(xs),
                                    "mask": jnp.asarray(ms)},
                           {"image": jnp.asarray(xu)},
                           jnp.float32(0.7), *extra_j(i),
                           jax.random.PRNGKey(i))
        state, to = tstep(state, {"image": to_t(xs),
                                  "mask": torch.from_numpy(ms).long()},
                          {"image": to_t(xu)}, 0.7, *extra_t(i))
        for k in keys:
            assert to[k].dtype == torch.float32, k
            np.testing.assert_allclose(float(to[k]), float(jo[k]),
                                       rtol=STEP_LOSS_RTOL, err_msg=k)
    if algo == "em":
        assert _travel_miss(before, jstate.params, tm) <= STEP_TRAVEL_TOL
    else:
        assert _travel_miss(before, jstate.params1, tm) <= STEP_TRAVEL_TOL
        assert (_travel_miss(before2, jstate.params2, teacher)
                <= STEP_TRAVEL_TOL)


# -- snapshots 

def test_bf16_snapshot_is_float32_and_loads_in_both(tmp_path):
    """A bf16 ``train_sup_2d`` run's snapshot holds float32 arrays and
    goes to ``test_2d`` in both packages, with the same metrics (rtol
    1e-6, as ``tests/test_torch_cli.py``: both test in float32)."""
    import importlib.util
    import os

    from hebbax.cli.test_2d import main as hebbax_test
    from hebbax.utils.checkpoint import load_snapshot as j_load
    from hebbax_torch.cli import common as tcli
    from hebbax_torch.cli import test_2d as ttest
    from hebbax_torch.cli import train_sup_2d
    from hebbax_torch.config.datasets import dataset_cfg

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "make_synth_data", os.path.join(repo, "scripts",
                                        "make_synth_data.py"))
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    root = str(tmp_path / "GlaS")
    synth.make_2d(root, 6, 2, 32, seed=0)
    args = train_sup_2d.add_args(tcli.base_parser_2d()).parse_args(
        ["--device", "cpu", "--path_dataset", root, "--path_root_exp",
         str(tmp_path / "runs"), "-b", "2", "-e", "2", "-w", "1",
         "--validate_iter", "1", "--num_workers", "1", "--debug", "",
         "-n", "unet", "--regime", "100", "--dtype", "bfloat16"])
    loaders = tcli.make_loaders_2d(args, dataset_cfg("GlaS"))
    for ld in loaders.values():
        ld.dataset.size = (32, 32)
    trainer = train_sup_2d.build(args, loaders)
    assert all(m.compute_dtype == BF16 for m in trainer.state.model.modules()
               if hasattr(m, "compute_dtype"))
    trainer.run()
    snap = os.path.join(trainer.paths.checkpoints, "best_JI.ckpt")
    jv, _ = j_load(snap)
    for leaf in jax.tree_util.tree_leaves(jv):
        assert np.asarray(leaf).dtype == np.float32
    argv = ["--path_dataset", root, "--dataset_name", "GlaS", "--path_exp",
            trainer.paths.run, "-n", "unet", "-b", "2", "--num_workers",
            "1"]
    got = ttest.main(["--device", "cpu"] + argv)
    ref = hebbax_test(argv)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)
