"""A few semi-supervised steps of the single-model algorithms (EM on
``unet``, URPC on ``unet_urpc``, CCT on ``unet_cct``) held against
hebbax's jitted ``make_semi_step`` on carried weights and the same
batches.

Model 1 has the fine-tune spec a Hebbian snapshot gives (swta_t, alpha 0:
weight-normalized forward, no deltas, heads excluded); dropout is off;
CCT's perturbation draws are hebbax's, replayed by test_torch_deep4.py's
``DrawRecorder`` (6 per step: the unsup forward's 3, then the sup
forward's).  SGD with momentum 0.9 and weight decay 5e-5 on the
warmup+StepLR schedule (warmup 1, one step per epoch), so step 0 trains
at lr 0 and the later steps at 1e-2.

Tolerances, from test_torch_steps.py: losses rtol 1e-4 (loss, loss_sup and
loss_unsup per step); parameters and BN statistics rtol 1e-4 / atol
1e-5.  One compile of hebbax's step per algorithm (module scope).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hebbax.engine.semi as jsemi
import hebbax.models.unet2d as junet
from hebbax.config.schedules import make_optimizer as j_make_optimizer
from hebbax.config.schedules import warmup_step_schedule
from hebbax.engine.state import TrainState as JState
from hebbax.ops.losses import dice_loss as j_dice
from hebbax_torch.config.schedules import WarmupStepLR, make_optimizer
from hebbax_torch.engine import semi
from hebbax_torch.engine.state import TrainState
from hebbax_torch.ops.losses import dice_loss

from test_torch_deep4 import DrawRecorder, make_net_pair
from test_torch_steps import _compare
from test_torch_unet2d import _NoDropout, to_nchw

torch.set_num_threads(2)

N_STEPS = 3
LR = 1e-2
UNSUP_W = 0.7
ALGOS = {"em": ("unet", lambda m: (m.em_unsup(2), None)),
         "urpc": ("unet_urpc", lambda m: (m.urpc_unsup,
                                          m.deep4_sup(DICE[m]))),
         "cct": ("unet_cct", lambda m: (m.cct_unsup,
                                        m.deep4_sup(DICE[m])))}
DICE = {jsemi: j_dice, semi: dice_loss}


def semi_batches(seed, n=N_STEPS):
    """(sup image, sup mask, unsup image) numpy NHWC triples."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((2, 32, 32, 3)).astype(np.float32),
             (rng.random((2, 32, 32)) < 0.4).astype(np.int32),
             rng.standard_normal((2, 32, 32, 3)).astype(np.float32))
            for _ in range(n)]


def j_sgd(lr=LR):
    return j_make_optimizer("sgd", warmup_step_schedule(
        lr, warmup=1, step_size=50, gamma=0.5, steps_per_epoch=1),
        momentum=0.9, weight_decay=5e-5)


def t_sgd(model, lr=LR):
    return (make_optimizer("sgd", model.parameters(), momentum=0.9,
                           weight_decay=5e-5),
            WarmupStepLR(lr, warmup=1, step_size=50, gamma=0.5,
                         steps_per_epoch=1))


def j_batch(x, m=None):
    b = {"image": jnp.asarray(x)}
    if m is not None:
        b["mask"] = jnp.asarray(m)
    return b


def t_batch(x, m=None):
    b = {"image": to_nchw(x)}
    if m is not None:
        b["mask"] = torch.from_numpy(m).long()
    return b


LOSS_KEYS = ("loss", "loss_sup", "loss_unsup")


def assert_losses_close(got, ref):
    for k in LOSS_KEYS:
        np.testing.assert_allclose([o[k] for o in got], [o[k] for o in ref],
                                   rtol=1e-4, err_msg=k)


@pytest.fixture(scope="module")
def hebbax_runs():
    """{algo: (variables, hebbax's final state, per-step losses, recorded
    CCT draws)}, hebbax's steps compiled once per algorithm."""
    mp = pytest.MonkeyPatch()
    mp.setattr(junet, "FastDropout", _NoDropout)
    out = {}
    try:
        for algo, (name, fns) in ALGOS.items():
            rec = DrawRecorder(mp)
            jm, variables, _, _ = make_net_pair(name, hebb=True, seed=11,
                                                alpha=0.0)
            tx = j_sgd()
            step = jsemi.make_semi_step(jm, name, j_dice, tx, *fns(jsemi))
            state = JState(params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]), step=0)
            losses = []
            for i, (xs, ms, xu) in enumerate(semi_batches(21)):
                state, o = step(state, j_batch(xs, ms), j_batch(xu),
                                jnp.float32(UNSUP_W), jax.random.PRNGKey(i))
                losses.append({k: float(o[k]) for k in LOSS_KEYS})
            jax.effects_barrier()
            out[algo] = (variables, state, losses, list(rec.records))
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("algo", list(ALGOS))
def test_semi_steps_match(hebbax_runs, algo):
    name, fns = ALGOS[algo]
    _, _, tm, _ = make_net_pair(name, hebb=True, seed=11, alpha=0.0)
    variables, jstate, lj, records = hebbax_runs[algo]
    if algo == "cct":
        assert len(records) == 6 * N_STEPS
        DrawRecorder(records=records).install(tm)
    opt, sched = t_sgd(tm)
    state = TrainState(model=tm, optimizer=opt, schedule=sched)
    step = semi.make_semi_step(tm, name, dice_loss, *fns(semi))
    lt = []
    for xs, ms, xu in semi_batches(21):
        state, o = step(state, t_batch(xs, ms), t_batch(xu), UNSUP_W)
        lt.append({k: float(o[k]) for k in LOSS_KEYS})
        assert o["logits"].shape == (2, 2, 32, 32)
    assert state.step == N_STEPS
    assert all(o["loss_unsup"] != 0.0 for o in lt)
    assert_losses_close(lt, lj)
    _compare(jstate, tm, [o["loss"] for o in lj], [o["loss"] for o in lt],
             adam=False)
