"""A few steps of the dual-model semi-supervised algorithms held against
hebbax's jitted steps on carried weights and the same batches:

* UAMT (``make_uamt_step``) on ``unet``: model 1 with the fine-tune spec
  (swta_t, alpha 0, weight-normalized forward), the teacher the same
  network carrying another init, as hebbax's teacher is model 1's module
  carrying ``params2``.  The teacher's noise and its 8 MC noises are
  hebbax's, taken from the step key with hebbax's own splits
  (:func:`uamt_noise_of`) and passed to the port's step; the epoch goes
  0, 1, 2 of 3, so the EMA runs at alpha 0 (a copy), 1/2 and 2/3 and the
  uncertainty threshold moves.
* CPS (``make_cps_step``): model 1 with the fine-tune spec, model 2 a
  plain ``unet`` (hebbax builds it with ``hebb=None``), one SGD each.
  Both packages' argmax pseudo-labels are recorded through the criterion
  (an ordered ``jax.debug.callback`` in hebbax's jitted step) and must be
  equal: the seeds are chosen so no near-tie flips between XLA and torch
  rounding.

SGD with momentum 0.9 and weight decay 5e-5, warmup 1 (step 0 at lr 0),
then lr 1e-2 for UAMT and 1e-3 for CPS: CPS's model 2 has no weight
norm, so the grads of its first convs (differences of nearly equal pixel
sums under train-mode BN) are large, and at 1e-2 their float32 rounding
moved 1 of 432 elements by 1.6e-5 after two steps.  Tolerances, from test_torch_steps.py: losses rtol 1e-4 (loss, loss_sup,
loss_unsup per step); parameters and BN statistics of both models
(UAMT's teacher included) rtol 1e-4 / atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hebbax.engine.semi as jsemi
import hebbax.models.unet2d as junet
from hebbax.ops.losses import dice_loss as j_dice
from hebbax_torch.bridge import from_flax
from hebbax_torch.engine import semi
from hebbax_torch.hebb.spec import HebbSpec
from hebbax_torch.models.unet2d import UNet2D
from hebbax_torch.ops.dropout import Dropout
from hebbax_torch.ops.losses import dice_loss

from test_torch_deep4 import make_net_pair
from test_torch_semi_ops import nchw
from test_torch_semi_steps import (LOSS_KEYS, N_STEPS, UNSUP_W,
                                   assert_losses_close, j_batch, j_sgd,
                                   semi_batches, t_batch, t_sgd)
from test_torch_steps import _compare
from test_torch_unet2d import _NoDropout

torch.set_num_threads(2)

N_EPOCHS = 3
MC_T = 8
CPS_LR = 1e-3


def uamt_noise_of(key, shape):
    """hebbax's UAMT noises for one step key: the teacher's, then the MC
    ones, as a (1 + 8, N, C, H, W) tensor."""
    k_noise, k_mc, _, _, _ = jax.random.split(key, 5)
    keys = [k_noise] + list(jax.random.split(k_mc, MC_T))
    return torch.stack([nchw(jnp.clip(
        0.1 * jax.random.normal(k, shape), -0.2, 0.2)) for k in keys])


def _port_copy(variables, hebb):
    """A port ``unet`` (with the fine-tune spec when ``hebb``) carrying
    flax ``variables``, dropout off."""
    spec = (HebbSpec(mode="swta_t", k=50.0, w_nrm=True, alpha=0.0,
                     exclude=("out_conv",)) if hebb else None)
    tm = UNet2D(3, 2, hebb=spec, device="cpu")
    tm.load_state_dict(from_flax(variables["params"],
                                 variables["batch_stats"]))
    for m in tm.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return tm


def _run_hebbax(step, state, batches, extra):
    losses = []
    for i, (xs, ms, xu) in enumerate(batches):
        state, o = step(state, j_batch(xs, ms), j_batch(xu),
                        jnp.float32(UNSUP_W), *extra(i),
                        jax.random.PRNGKey(i))
        losses.append({k: float(o[k]) for k in LOSS_KEYS})
    jax.effects_barrier()
    return state, losses


@pytest.fixture(scope="module")
def hebbax_runs():
    """Both algorithms' hebbax runs, one compile each."""
    mp = pytest.MonkeyPatch()
    mp.setattr(junet, "FastDropout", _NoDropout)
    out = {}
    try:
        jm, v1, _, _ = make_net_pair("unet", hebb=True, seed=31, alpha=0.0)
        _, v2, _, _ = make_net_pair("unet", hebb=False, seed=32)
        tx = j_sgd()
        step = jsemi.make_uamt_step(jm, "unet", j_dice, tx, 2, N_EPOCHS,
                                    ema_decay=0.99, mc_T=MC_T)
        state = jsemi.DualState(
            params1=v1["params"], batch_stats1=v1["batch_stats"],
            opt_state1=tx.init(v1["params"]), params2=v2["params"],
            batch_stats2=v2["batch_stats"], step=0)
        state, losses = _run_hebbax(step, state, semi_batches(41),
                                    lambda i: (jnp.float32(i),))
        out["uamt"] = (v1, v2, state, losses)

        jm2, w2, _, _ = make_net_pair("unet", hebb=False, seed=72)
        jm1, w1, _, _ = make_net_pair("unet", hebb=True, seed=71, alpha=0.0)
        targets = []

        def crit(logits, target):
            jax.debug.callback(lambda t: targets.append(np.asarray(t)),
                               target, ordered=True)
            return j_dice(logits, target)

        tx1, tx2 = j_sgd(CPS_LR), j_sgd(CPS_LR)
        step = jsemi.make_cps_step(jm1, jm2, "unet", crit, tx1, tx2)
        state = jsemi.DualState(
            params1=w1["params"], batch_stats1=w1["batch_stats"],
            opt_state1=tx1.init(w1["params"]), params2=w2["params"],
            batch_stats2=w2["batch_stats"],
            opt_state2=tx2.init(w2["params"]), step=0)
        state, losses = _run_hebbax(step, state, semi_batches(81),
                                    lambda i: ())
        out["cps"] = (w1, w2, state, losses, targets)
    finally:
        mp.undo()
    return out


class _Split:
    """One side of a DualState in hebbax's single-state field names, for
    test_torch_steps._compare."""

    def __init__(self, state, which):
        self.params = getattr(state, f"params{which}")
        self.batch_stats = getattr(state, f"batch_stats{which}")


def test_uamt_steps_match(hebbax_runs):
    v1, v2, jstate, lj = hebbax_runs["uamt"]
    model = _port_copy(v1, hebb=True)
    teacher = _port_copy(v2, hebb=True)    # model 1's spec, params2
    assert teacher.encoder.in_conv.conv1.spec.w_nrm
    opt, sched = t_sgd(model)
    state = semi.DualState(model1=model, optimizer1=opt, schedule1=sched,
                           model2=teacher)
    step = semi.make_uamt_step(model, teacher, "unet", dice_loss, N_EPOCHS,
                               ema_decay=0.99, mc_T=MC_T)
    lt = []
    for i, (xs, ms, xu) in enumerate(semi_batches(41)):
        noise = uamt_noise_of(jax.random.PRNGKey(i), xu.shape)
        state, o = step(state, t_batch(xs, ms), t_batch(xu), UNSUP_W, i,
                        noise=noise)
        lt.append({k: float(o[k]) for k in LOSS_KEYS})
    assert all(o["loss_unsup"] > 0.0 for o in lt)
    assert_losses_close(lt, lj)
    _compare(_Split(jstate, 1), model, [o["loss"] for o in lj],
             [o["loss"] for o in lt], adam=False)
    # the teacher: EMA parameters, BN statistics of its own 9 forwards
    _compare(_Split(jstate, 2), teacher, [], [], adam=False)


def test_cps_steps_match_and_pseudo_labels_agree(hebbax_runs):
    w1, w2, jstate, lj, j_targets = hebbax_runs["cps"]
    model1 = _port_copy(w1, hebb=True)
    model2 = _port_copy(w2, hebb=False)
    assert model2.encoder.in_conv.conv1.spec is None     # no w_nrm
    w0 = [m.encoder.in_conv.conv1.weight.detach().clone()
          for m in (model1, model2)]
    targets = []

    def crit(logits, target):
        targets.append(target.numpy().copy())
        return dice_loss(logits, target)

    opt1, s1 = t_sgd(model1, CPS_LR)
    opt2, s2 = t_sgd(model2, CPS_LR)
    state = semi.DualState(model1=model1, optimizer1=opt1, schedule1=s1,
                           model2=model2, optimizer2=opt2, schedule2=s2)
    step = semi.make_cps_step(model1, model2, "unet", crit)
    lt = []
    for xs, ms, xu in semi_batches(81):
        state, o = step(state, t_batch(xs, ms), t_batch(xu), UNSUP_W)
        lt.append({k: float(o[k]) for k in LOSS_KEYS})
        assert o["logits2"].shape == (2, 2, 32, 32)
    # per step: pl2 (model 1's target), pl1, then the mask twice
    assert len(targets) == len(j_targets) == 4 * N_STEPS
    for i, (got, ref) in enumerate(zip(targets, j_targets)):
        np.testing.assert_array_equal(got, ref, err_msg=f"target {i}")
    assert not np.array_equal(targets[0], targets[1])
    assert_losses_close(lt, lj)
    _compare(_Split(jstate, 1), model1, [o["loss"] for o in lj],
             [o["loss"] for o in lt], adam=False)
    _compare(_Split(jstate, 2), model2, [], [], adam=False)
    for m, w in zip((model1, model2), w0):                # both trained
        assert not torch.equal(m.encoder.in_conv.conv1.weight, w)
