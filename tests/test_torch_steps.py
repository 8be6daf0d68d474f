"""A few train steps of the port held against hebbax's
``make_sup_train_step`` on carried weights and the same batches.

* pretraining: swta_t (K=50), alpha=1, ``out_conv`` excluded, Adam,
  ``backprop_only`` over the head, the pretraining freeze;
* fine-tuning: the Hebbian snapshot's spec with alpha=0 (weight-normalized
  forward, no deltas), SGD with momentum and weight decay 5e-5.

The schedule is the warmup+StepLR one with one step per epoch and warmup
1, so step 0 trains at lr 0 (the epoch-0 artifact) and the later steps at
the base rate.  Dropout is off in both (see test_torch_unet2d.py).

Tolerances, each from float32 rounding that differs between XLA and
torch: losses rtol 1e-4; BN statistics rtol 1e-4 / atol 1e-5 (as the
forward test); parameters rtol 1e-4 / atol 1e-5 (the updates of BN biases
are differences of nearly equal pixel sums, where the rounding of the
forward shows at ~1e-2 of a ~1e-4 update).  After Adam (lr 1e-3, two
steps at a rate above 0) at most 1% of a tensor's elements may miss that
bound, by no more than the two steps' full travel (4e-3): Adam's
g/sqrt(v) normalizes each element, so where a gradient element is a sum
that cancels to within its rounding (the head's first conv sums 2048
pixel terms of both signs; seen: 6e-5 absolute on 4e-4 with terms of
~1e-4), its update follows the rounding.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from hebbax.config.schedules import make_optimizer as j_make_optimizer
from hebbax.config.schedules import warmup_step_schedule
from hebbax.engine.state import TrainState as JState
from hebbax.engine.steps import make_sup_train_step as j_make_step
from hebbax.hebb.surgery import pretrain_trainable_mask
from hebbax.ops.losses import dice_loss as j_dice
from hebbax_torch.config.schedules import WarmupStepLR, make_optimizer
from hebbax_torch.engine.state import TrainState
from hebbax_torch.engine.steps import make_sup_train_step
from hebbax_torch.hebb.surgery import pretrain_trainable_names
from hebbax_torch.ops.losses import dice_loss

from test_torch_unet2d import make_pair, no_dropout, to_nchw  # noqa: F401

torch.set_num_threads(2)

N_STEPS = 3


def _batches(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(N_STEPS):
        x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
        m = (rng.random((2, 32, 32)) < 0.4).astype(np.int32)
        out.append((x, m))
    return out


def _run_hebbax(jm, variables, tx, batches, **step_kw):
    step = j_make_step(jm, "unet", j_dice, tx, **step_kw)
    state = JState(params=variables["params"],
                   batch_stats=variables["batch_stats"],
                   opt_state=tx.init(variables["params"]), step=0)
    losses = []
    for i, (x, m) in enumerate(batches):
        state, out = step(state, {"image": jnp.asarray(x),
                                  "mask": jnp.asarray(m)},
                          jax.random.PRNGKey(i))
        losses.append(float(out["loss"]))
    return state, losses


def _run_port(tm, optimizer, schedule, batches, **step_kw):
    step = make_sup_train_step(tm, "unet", dice_loss, **step_kw)
    state = TrainState(model=tm, optimizer=optimizer, schedule=schedule)
    losses = []
    for x, m in batches:
        state, out = step(state, {"image": to_nchw(x),
                                  "mask": torch.from_numpy(m).long()})
        losses.append(float(out["loss"]))
    assert state.step == len(batches)
    return losses


def _assert_params_close(got, ref, name, adam):
    if adam:
        far = np.abs(got - ref) > 1e-5 + 1e-4 * np.abs(ref)
        assert far.mean() <= 1e-2, (name, int(far.sum()))
        np.testing.assert_allclose(got, ref, rtol=0, atol=4e-3,
                                   err_msg=name)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def _compare(jstate, tm, losses_j, losses_t, adam):
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    sd = tm.state_dict()
    for path, v in traverse_util.flatten_dict(jstate.params).items():
        mod = ".".join(path[:-1])
        v = np.asarray(v)
        if path[-1] == "kernel":
            name, v = mod + ".weight", np.transpose(v, (3, 2, 0, 1))
        else:
            name = mod + (".weight" if path[-1] == "scale" else ".bias")
        _assert_params_close(sd[name].numpy(), v, name, adam)
    for path, v in traverse_util.flatten_dict(jstate.batch_stats).items():
        name = ".".join(path[:-1]) + (".running_mean" if path[-1] == "mean"
                                      else ".running_var")
        np.testing.assert_allclose(sd[name].numpy(), np.asarray(v),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_pretrain_steps_match(no_dropout):
    jm, variables, tm, _ = make_pair(hebb=True, seed=4)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    batches = _batches(0)
    tx = j_make_optimizer("adam", warmup_step_schedule(
        1e-3, warmup=1, step_size=50, gamma=0.5, steps_per_epoch=1))
    jstate, lj = _run_hebbax(
        jm, variables, tx, batches, hebb_alpha=1.0,
        trainable_mask=pretrain_trainable_mask(variables["params"],
                                               ("out_conv",)),
        backprop_only=("out_conv",))

    names = set(pretrain_trainable_names(tm, ("out_conv",)))
    opt = make_optimizer("adam", [p for n, p in tm.named_parameters()
                                  if n in names])
    lt = _run_port(tm, opt, WarmupStepLR(1e-3, warmup=1, step_size=50,
                                         gamma=0.5, steps_per_epoch=1),
                   batches, hebb_alpha=1.0, backprop_only=("out_conv",))
    _compare(jstate, tm, lj, lt, adam=True)
    after = dict(tm.named_parameters())
    # trunk kernels moved by -delta, frozen BN affine and conv biases did not
    assert not torch.equal(after["encoder.in_conv.conv1.weight"],
                           before["encoder.in_conv.conv1.weight"])
    assert torch.equal(after["encoder.in_conv.bn1.weight"],
                       before["encoder.in_conv.bn1.weight"])
    assert torch.equal(after["encoder.in_conv.conv1.bias"],
                       before["encoder.in_conv.conv1.bias"])
    assert not torch.equal(after["out_conv.conv1.bias"],
                           before["out_conv.conv1.bias"])


def test_finetune_steps_match(no_dropout):
    from hebbax.hebb.spec import HebbSpec as JSpec
    from hebbax.models.unet2d import UNet2D as JUNet
    from hebbax_torch.hebb.layers import bind_paths
    from hebbax_torch.hebb.spec import HebbSpec

    _, variables, tm, _ = make_pair(hebb=False, seed=5)
    kw = dict(mode="swta_t", k=50.0, w_nrm=True, alpha=0.0,
              exclude=("out_conv",))
    jm = JUNet(in_channels=3, n_cls=2, hebb=JSpec(**kw))
    bind_paths(tm, HebbSpec(**kw))
    batches = _batches(1)
    schedule = warmup_step_schedule(1e-2, warmup=1, step_size=50,
                                    gamma=0.5, steps_per_epoch=1)
    tx = j_make_optimizer("sgd", schedule, momentum=0.9,
                          weight_decay=5e-5)
    jstate, lj = _run_hebbax(jm, variables, tx, batches)
    opt = make_optimizer("sgd", tm.parameters(), momentum=0.9,
                         weight_decay=5e-5)
    lt = _run_port(tm, opt, WarmupStepLR(1e-2, warmup=1, step_size=50,
                                         gamma=0.5, steps_per_epoch=1),
                   batches)
    _compare(jstate, tm, lj, lt, adam=False)


@pytest.mark.parametrize("epoch", [0, 1, 2, 20, 21, 70, 71, 200])
def test_schedule_matches_optax(epoch):
    sched = warmup_step_schedule(0.5, warmup=20, step_size=50, gamma=0.5,
                                 steps_per_epoch=3)
    ours = WarmupStepLR(0.5, warmup=20, step_size=50, gamma=0.5,
                        steps_per_epoch=3)
    for count in (3 * epoch, 3 * epoch + 2):
        np.testing.assert_allclose(ours(count), float(sched(count)),
                                   rtol=1e-6)
