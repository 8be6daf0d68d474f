"""Two steps of the dual-model 3D semi-supervised algorithms held against
hebbax's jitted steps on carried weights and the same 5-D batches, as
test_torch_semi_dual.py does in 2D:

* UAMT (``make_uamt_step``) on ``unet3d`` (4 initial features): model 1
  with the fine-tune spec (swta_t, alpha 0), the teacher the same network
  carrying another init; the teacher's noise and its 8 MC noises are
  hebbax's, taken from the step key with hebbax's own splits
  (test_torch_semi_dual.py's ``uamt_noise_of``) and passed to the port's
  step; the epoch goes 0, 1 of 2, so the EMA runs at alpha 0 (a copy) and
  1/2 and the uncertainty threshold moves.
* CPS (``make_cps_step``): model 1 with the fine-tune spec, model 2 a
  plain ``unet3d`` (hebbax builds it with ``hebb=None``), one SGD each;
  both packages' argmax pseudo-labels are recorded through the criterion
  and must be equal.

Batch 2 at 32^3 (a 2^3 BN bottleneck over 16 values).  SGD with momentum
0.9 and weight decay 5e-5, warmup 1 (step 0 at lr 0), then lr 1e-2 for
UAMT and 1e-3 for CPS (model 2 has no weight norm; see
test_torch_semi_dual.py).  Tolerances, from test_torch_3d_steps.py:
losses rtol 1e-4 (loss, loss_sup, loss_unsup per step); parameters and BN
statistics of both models (UAMT's teacher included) rtol 1e-4 / atol
1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hebbax.engine.semi as jsemi
from hebbax.ops.losses import dice_loss as j_dice
from hebbax_torch.bridge import from_flax
from hebbax_torch.engine import semi
from hebbax_torch.engine.loop import to_device_batch_3d
from hebbax_torch.hebb.layers import transposed_paths
from hebbax_torch.ops.losses import dice_loss

from test_torch_3d_semi_nets import make_net_pair_3d
from test_torch_3d_semi_steps import (N_STEPS, compare_state, j_batch_3d,
                                      j_opt, semi_batches_3d, t_opt)
from test_torch_semi_dual import MC_T, uamt_noise_of
from test_torch_semi_steps import LOSS_KEYS, UNSUP_W, assert_losses_close

torch.set_num_threads(2)

N_EPOCHS = 2
UAMT_LR, CPS_LR = 1e-2, 1e-3


def _run_hebbax(step, state, batches, extra):
    losses = []
    for i, (bs, bu) in enumerate(batches):
        state, o = step(state, j_batch_3d(bs), j_batch_3d(bu),
                        jnp.float32(UNSUP_W), *extra(i),
                        jax.random.PRNGKey(i))
        losses.append({k: float(o[k]) for k in LOSS_KEYS})
    jax.effects_barrier()
    return state, losses


def _dual(v1, v2, tx1, tx2=None):
    return jsemi.DualState(
        params1=v1["params"], batch_stats1=v1["batch_stats"],
        opt_state1=tx1.init(v1["params"]), params2=v2["params"],
        batch_stats2=v2["batch_stats"],
        opt_state2=None if tx2 is None else tx2.init(v2["params"]), step=0)


@pytest.fixture(scope="module")
def hebbax_runs():
    """Both algorithms' hebbax runs, one compile each."""
    out = {}
    jm, v1, _, _ = make_net_pair_3d("unet3d", hebb=True, seed=31, alpha=0.0)
    _, v2, _, _ = make_net_pair_3d("unet3d", seed=32)
    tx = j_opt("sgd", UAMT_LR)
    step = jsemi.make_uamt_step(jm, "unet3d", j_dice, tx, 2, N_EPOCHS,
                                ema_decay=0.99, mc_T=MC_T)
    state, losses = _run_hebbax(step, _dual(v1, v2, tx), semi_batches_3d(41),
                                lambda i: (jnp.float32(i),))
    out["uamt"] = (state, losses)

    jm1, w1, _, _ = make_net_pair_3d("unet3d", hebb=True, seed=71,
                                     alpha=0.0)
    jm2, w2, _, _ = make_net_pair_3d("unet3d", seed=72)
    targets = []

    def crit(logits, target):
        jax.debug.callback(lambda t: targets.append(np.asarray(t)),
                           target, ordered=True)
        return j_dice(logits, target)

    tx1, tx2 = j_opt("sgd", CPS_LR), j_opt("sgd", CPS_LR)
    step = jsemi.make_cps_step(jm1, jm2, "unet3d", crit, tx1, tx2)
    state, losses = _run_hebbax(step, _dual(w1, w2, tx1, tx2),
                                semi_batches_3d(81), lambda i: ())
    out["cps"] = (state, losses, targets)
    return out


def test_uamt_steps_match(hebbax_runs):
    jstate, lj = hebbax_runs["uamt"]
    _, _, model, _ = make_net_pair_3d("unet3d", hebb=True, seed=31,
                                      alpha=0.0)
    # the teacher: model 1's spec (weight-normalized forward), params2
    _, v2, _, _ = make_net_pair_3d("unet3d", seed=32)
    _, _, teacher, _ = make_net_pair_3d("unet3d", hebb=True, seed=31,
                                        alpha=0.0)
    teacher.load_state_dict(from_flax(v2["params"], v2["batch_stats"],
                                      transposed_paths(teacher)))
    assert teacher.encoder.encoder1.conv1.spec.w_nrm
    opt, sched = t_opt("sgd", model.parameters(), UAMT_LR)
    state = semi.DualState(model1=model, optimizer1=opt, schedule1=sched,
                           model2=teacher)
    step = semi.make_uamt_step(model, teacher, "unet3d", dice_loss,
                               N_EPOCHS, ema_decay=0.99, mc_T=MC_T)
    lt = []
    for i, (bs, bu) in enumerate(semi_batches_3d(41)):
        noise = uamt_noise_of(jax.random.PRNGKey(i),
                              bu["image"][..., None].shape)
        state, o = step(state, to_device_batch_3d(bs, "cpu"),
                        to_device_batch_3d(bu, "cpu"), UNSUP_W, i,
                        noise=noise)
        lt.append({k: float(o[k]) for k in LOSS_KEYS})
    assert all(o["loss_unsup"] > 0.0 for o in lt)
    assert_losses_close(lt, lj)
    compare_state(jstate.params1, jstate.batch_stats1, model)
    # the teacher: EMA parameters, BN statistics of its own 9 forwards
    compare_state(jstate.params2, jstate.batch_stats2, teacher)


def test_cps_steps_match_and_pseudo_labels_agree(hebbax_runs):
    jstate, lj, j_targets = hebbax_runs["cps"]
    _, _, model1, _ = make_net_pair_3d("unet3d", hebb=True, seed=71,
                                       alpha=0.0)
    _, _, model2, _ = make_net_pair_3d("unet3d", seed=72)
    assert model2.encoder.encoder1.conv1.spec is None     # no w_nrm
    w0 = [m.encoder.encoder1.conv1.weight.detach().clone()
          for m in (model1, model2)]
    targets = []

    def crit(logits, target):
        targets.append(target.numpy().copy())
        return dice_loss(logits, target)

    opt1, s1 = t_opt("sgd", model1.parameters(), CPS_LR)
    opt2, s2 = t_opt("sgd", model2.parameters(), CPS_LR)
    state = semi.DualState(model1=model1, optimizer1=opt1, schedule1=s1,
                           model2=model2, optimizer2=opt2, schedule2=s2)
    step = semi.make_cps_step(model1, model2, "unet3d", crit)
    lt = []
    for bs, bu in semi_batches_3d(81):
        state, o = step(state, to_device_batch_3d(bs, "cpu"),
                        to_device_batch_3d(bu, "cpu"), UNSUP_W)
        lt.append({k: float(o[k]) for k in LOSS_KEYS})
        assert o["logits2"].shape == (2, 2, 32, 32, 32)
    # per step: pl2 (model 1's target), pl1, then the mask twice
    assert len(targets) == len(j_targets) == 4 * N_STEPS
    for i, (got, ref) in enumerate(zip(targets, j_targets)):
        np.testing.assert_array_equal(got, ref, err_msg=f"target {i}")
    assert not np.array_equal(targets[0], targets[1])
    assert_losses_close(lt, lj)
    compare_state(jstate.params1, jstate.batch_stats1, model1)
    compare_state(jstate.params2, jstate.batch_stats2, model2)
    for m, w in zip((model1, model2), w0):                # both trained
        assert not torch.equal(m.encoder.encoder1.conv1.weight, w)
