"""Two semi-supervised steps of the single-model 3D algorithms held
against hebbax's jitted ``make_semi_step`` on carried weights and the same
5-D batches: EM on ``unet3d``, URPC on ``unet3d_urpc``, CCT on
``unet3d_cct`` (each with the fine-tune spec a Hebbian snapshot gives:
swta_t, alpha 0, weight-normalized forward, the sweep's heads excluded)
and DTC on ``unet3d_dtc`` (kaiming, no spec, as the sweep runs it), plus
two Hebbian pretraining steps of ``unet3d_urpc`` against hebbax's
``make_sup_train_step``.

Batch 2 at 32^3; the UNet3D variants at 4 initial features (see
test_torch_3d_semi_nets.py), URPC at its full width with its channel
dropout off in both; CCT's perturbation draws are hebbax's, replayed by
test_torch_deep4.py's ``DrawRecorder`` (6 per step: the unsup forward's 3,
then the sup forward's).  DTC's sup batch carries ``mask_sdf`` from the
port's ``mask_to_sdf``.  The semi steps run SGD with momentum 0.9 and
weight decay 5e-5, the pretraining Adam, on the warmup+StepLR schedule
(warmup 1, one step per epoch), so step 0 trains at lr 0 and step 1 at
1e-2 (1e-3 for Adam).

Tolerances, from test_torch_3d_steps.py: losses rtol 1e-4 (loss,
loss_sup, loss_unsup per step); parameters and BN statistics rtol 1e-4 /
atol 1e-5; after Adam at most 1% of a tensor's elements may miss that
bound, by no more than twice the step's full travel (2 x lr 1e-3): where
an element's Adam moments are float32 noise in both packages (seen:
``conv4.conv1.weight[110, 6, 1, 1, 0]`` of the URPC pretraining, exp_avg
2.5e-7 / exp_avg_sq 7.4e-15 here, mu -1.4e-8 / nu 2.9e-17 in hebbax), the
normalised update can take opposite signs, -6.7e-4 against +5.7e-4, a
miss of 1.24e-3 that one travel does not bound.  (The deltas
of a pretraining forward are held in test_torch_3d_semi_nets.py.)  One
compile of hebbax's step per algorithm (module scope).
"""

import numpy as np
import pytest
import torch
from flax import traverse_util

import jax
import jax.numpy as jnp

import hebbax.engine.semi as jsemi
import hebbax.models.unet3d as j3d
import hebbax.models.urpc3d as jurpc
from hebbax.config.schedules import make_optimizer as j_make_optimizer
from hebbax.config.schedules import warmup_step_schedule
from hebbax.engine.state import TrainState as JState
from hebbax.engine.steps import make_sup_train_step as j_make_step
from hebbax.hebb.surgery import pretrain_trainable_mask
from hebbax.ops.losses import dice_loss as j_dice
from hebbax_torch.config.schedules import WarmupStepLR, make_optimizer
from hebbax_torch.engine import semi
from hebbax_torch.engine.loop import to_device_batch_3d
from hebbax_torch.engine.state import TrainState
from hebbax_torch.engine.steps import make_sup_train_step
from hebbax_torch.hebb.layers import transposed_paths
from hebbax_torch.hebb.surgery import pretrain_trainable_names
from hebbax_torch.ops.distance import mask_to_sdf
from hebbax_torch.ops.losses import dice_loss

from test_torch_3d_semi_nets import (EXCLUDE, SITES, _LinenNoDropout,
                                     make_net_pair_3d)
from test_torch_deep4 import DrawRecorder, count_deltas  # noqa: F401
from test_torch_semi_steps import LOSS_KEYS, UNSUP_W, assert_losses_close

torch.set_num_threads(2)

N_STEPS = 2
LR = 1e-2
DICE = {jsemi: j_dice, semi: dice_loss}
# algo -> (network, Hebbian fine-tune spec?, (unsup_fn, sup_fn) of a
# package)
ALGOS = {
    "em": ("unet3d", True, lambda m: (m.em_unsup(2), None)),
    "urpc": ("unet3d_urpc", True,
             lambda m: (m.urpc_unsup, m.deep4_sup(DICE[m]))),
    "cct": ("unet3d_cct", True,
            lambda m: (m.cct_unsup, m.deep4_sup(DICE[m]))),
    "dtc": ("unet3d_dtc", False,
            lambda m: (m.dtc_unsup, m.dtc_sup(DICE[m], beta=0.3,
                                              num_classes=2))),
}


def semi_batches_3d(seed, n=N_STEPS):
    """(sup host batch, unsup host batch) pairs as the patch queues yield
    them: (B, X, Y, Z) images, int masks and float32 SDF maps."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        xs = rng.standard_normal((2, 32, 32, 32)).astype(np.float32)
        grid = np.indices((32, 32, 32)) - 16
        masks = []
        for _ in range(2):
            c = rng.integers(-6, 7, 3)
            r = rng.integers(5, 10)
            masks.append((((grid - c[:, None, None, None]) ** 2).sum(0)
                          < r * r).astype(np.int32))
        ms = np.stack(masks)
        sdf = np.stack([mask_to_sdf(m) for m in ms]).astype(np.float32)
        xu = rng.standard_normal((2, 32, 32, 32)).astype(np.float32)
        out.append(({"image": xs, "mask": ms, "mask_sdf": sdf},
                    {"image": xu}))
    return out


def j_batch_3d(b):
    out = {"image": jnp.asarray(b["image"][..., None])}
    for k in ("mask", "mask_sdf"):
        if k in b:
            out[k] = jnp.asarray(b[k])
    return out


def j_opt(name, lr):
    sched = warmup_step_schedule(lr, warmup=1, step_size=50, gamma=0.5,
                                 steps_per_epoch=1)
    if name == "adam":
        return j_make_optimizer("adam", sched)
    return j_make_optimizer("sgd", sched, momentum=0.9, weight_decay=5e-5)


def t_opt(name, params, lr):
    kw = {} if name == "adam" else dict(momentum=0.9, weight_decay=5e-5)
    return (make_optimizer(name, params, **kw),
            WarmupStepLR(lr, warmup=1, step_size=50, gamma=0.5,
                         steps_per_epoch=1))


def compare_state(jparams, jstats, tm, adam=False):
    """The port's parameters and BN statistics against hebbax's trees."""
    sd = tm.state_dict()
    tp = transposed_paths(tm)
    for path, v in traverse_util.flatten_dict(jparams).items():
        mod = ".".join(path[:-1])
        v = np.asarray(v)
        if path[-1] == "kernel":
            perm = (3, 4, 0, 1, 2) if mod in tp else (4, 3, 0, 1, 2)
            name, v = mod + ".weight", np.transpose(v, perm)
        else:
            name = mod + (".weight" if path[-1] == "scale" else ".bias")
        got = sd[name].numpy()
        if adam:
            far = np.abs(got - v) > 1e-5 + 1e-4 * np.abs(v)
            assert far.mean() <= 1e-2, (name, int(far.sum()))
            # two travels: a noise-level element may move either way
            np.testing.assert_allclose(got, v, rtol=0, atol=2e-3,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(got, v, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
    flat = traverse_util.flatten_dict(jstats or {})
    assert len(flat) == sum(k.endswith(("running_mean", "running_var"))
                            for k in sd)
    for path, v in flat.items():
        name = ".".join(path[:-1]) + (".running_mean" if path[-1] == "mean"
                                      else ".running_var")
        np.testing.assert_allclose(sd[name].numpy(), np.asarray(v),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.fixture(scope="module")
def hebbax_runs():
    """{algo: (hebbax's final state, per-step losses, recorded CCT
    draws)}, hebbax's step compiled once per algorithm."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jurpc, "nn", _LinenNoDropout())
    out = {}
    try:
        for algo, (name, hebb, fns) in ALGOS.items():
            rec = DrawRecorder(mp, module=j3d)
            jm, variables, _, _ = make_net_pair_3d(name, hebb=hebb, seed=11,
                                                   alpha=0.0)
            tx = j_opt("sgd", LR)
            step = jsemi.make_semi_step(jm, name, j_dice, tx, *fns(jsemi))
            state = JState(params=variables["params"],
                           batch_stats=variables.get("batch_stats"),
                           opt_state=tx.init(variables["params"]), step=0)
            losses = []
            for i, (bs, bu) in enumerate(semi_batches_3d(21)):
                state, o = step(state, j_batch_3d(bs), j_batch_3d(bu),
                                jnp.float32(UNSUP_W), jax.random.PRNGKey(i))
                losses.append({k: float(o[k]) for k in LOSS_KEYS})
            jax.effects_barrier()
            out[algo] = (state, losses, list(rec.records))
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("algo", list(ALGOS))
def test_semi_steps_match(hebbax_runs, algo):
    name, hebb, fns = ALGOS[algo]
    _, _, tm, _ = make_net_pair_3d(name, hebb=hebb, seed=11, alpha=0.0)
    jstate, lj, records = hebbax_runs[algo]
    if algo == "cct":
        assert len(records) == 6 * N_STEPS
        DrawRecorder(records=records).install(tm)
    opt, sched = t_opt("sgd", tm.parameters(), LR)
    state = TrainState(model=tm, optimizer=opt, schedule=sched)
    step = semi.make_semi_step(tm, name, dice_loss, *fns(semi))
    w0 = {n: p.detach().clone() for n, p in tm.named_parameters()}
    lt = []
    for bs, bu in semi_batches_3d(21):
        state, o = step(state, to_device_batch_3d(bs, "cpu"),
                        to_device_batch_3d(bu, "cpu"), UNSUP_W)
        lt.append({k: float(o[k]) for k in LOSS_KEYS})
        assert o["logits"].shape == (2, 2, 32, 32, 32)
    assert state.step == N_STEPS
    assert all(o["loss_unsup"] != 0.0 for o in lt)
    assert_losses_close(lt, lj)
    compare_state(jstate.params, jstate.batch_stats, tm)
    moved = [n for n, p in tm.named_parameters()
             if not torch.equal(p, w0[n])]
    assert len(moved) > len(w0) // 2


def test_urpc_pretrain_steps_match(monkeypatch, count_deltas):
    """``pretrain_hebbian_unsup_3d -n unet3d_urpc``'s step: deep
    supervision over the four heads, backprop only over them, alpha 1,
    18 Hebbian deltas per step through instance-normed convs."""
    monkeypatch.setattr(jurpc, "nn", _LinenNoDropout())
    jm, variables, tm, _ = make_net_pair_3d("unet3d_urpc", hebb=True,
                                            seed=5)
    batches = [b for b, _ in semi_batches_3d(7)]
    tx = j_opt("adam", 1e-3)
    jstep = j_make_step(jm, "unet3d_urpc", j_dice, tx, deep_supervision=True,
                        hebb_alpha=1.0,
                        trainable_mask=pretrain_trainable_mask(
                            variables["params"], EXCLUDE),
                        backprop_only=EXCLUDE)
    jstate = JState(params=variables["params"], batch_stats=None,
                    opt_state=tx.init(variables["params"]), step=0)
    lj = []
    for i, b in enumerate(batches):
        jstate, out = jstep(jstate, j_batch_3d(b), jax.random.PRNGKey(i))
        lj.append(float(out["loss"]))

    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    names = set(pretrain_trainable_names(tm, EXCLUDE))
    opt, sched = t_opt("adam", [p for n, p in tm.named_parameters()
                                if n in names], 1e-3)
    state = TrainState(model=tm, optimizer=opt, schedule=sched)
    step = make_sup_train_step(tm, "unet3d_urpc", dice_loss,
                               deep_supervision=True, hebb_alpha=1.0,
                               backprop_only=EXCLUDE)
    lt = []
    for b in batches:
        state, out = step(state, to_device_batch_3d(b, "cpu"))
        lt.append(float(out["loss"]))
    # every delta goes through the dispatcher to the composed 3D rule
    assert len(count_deltas) == SITES["unet3d_urpc"] * len(batches)
    np.testing.assert_allclose(lt, lj, rtol=1e-4)
    compare_state(jstate.params, None, tm, adam=True)
    after = dict(tm.named_parameters())
    # Hebbian kernels moved by -delta; converted biases frozen; heads
    # trained by backprop
    for n in ("conv1.conv1.weight", "up_concat1.conv.conv1.weight",
              *(f"dsv{i}.weight" for i in range(1, 5))):
        assert not torch.equal(after[n], before[n]), n
    assert torch.equal(after["conv1.conv1.bias"], before["conv1.conv1.bias"])
