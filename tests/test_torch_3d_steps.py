"""Train steps of the port's UNet3D held against hebbax's
``make_sup_train_step`` on carried weights and the same batches.

* pretraining: swta_t (K=50), alpha=1, the head ``conv`` excluded, Adam,
  ``backprop_only`` over the head, the pretraining freeze — 22 Hebbian
  deltas per step, 4 of them on transpose convs;
* fine-tuning: the Hebbian snapshot's spec with alpha=0 (weight-normalized
  forward, no deltas), SGD with momentum and weight decay 5e-5.

The schedule is warmup+StepLR with one step per epoch and warmup 1, so
step 0 trains at lr 0 (the epoch-0 artifact) and step 1 at the base rate:
one step that moves the parameters.

Tolerances as in ``tests/test_torch_steps.py`` (float32 rounding that
differs between XLA and torch): losses rtol 1e-4; parameters and BN
statistics rtol 1e-4 / atol 1e-5; after Adam at most 1% of a tensor's
elements may miss that bound, by no more than the step's full travel
(lr 1e-3): Adam's g/sqrt(v) turns a gradient element that cancels to
within its rounding into a full step either way.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from hebbax.config.schedules import make_optimizer as j_make_optimizer
from hebbax.config.schedules import warmup_step_schedule
from hebbax.engine.state import TrainState as JState
from hebbax.engine.steps import make_sup_train_step as j_make_step
from hebbax.hebb.spec import HebbSpec as JSpec
from hebbax.hebb.surgery import pretrain_trainable_mask
from hebbax.models.unet3d import UNet3D as JUNet3D
from hebbax.ops.losses import dice_loss as j_dice
from hebbax_torch.config.schedules import WarmupStepLR, make_optimizer
from hebbax_torch.engine.loop import to_device_batch_3d
from hebbax_torch.engine.state import TrainState
from hebbax_torch.engine.steps import make_sup_train_step
from hebbax_torch.hebb.layers import bind_paths
from hebbax_torch.hebb.spec import HebbSpec
from hebbax_torch.hebb.surgery import pretrain_trainable_names
from hebbax_torch.ops.losses import dice_loss

from test_torch_3d_model import SPEC, make_pair

torch.set_num_threads(2)

N_STEPS = 2


def _batches(seed):
    """Host patch batches as the queue yields them: (B, X, Y, Z)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(N_STEPS):
        x = rng.standard_normal((2, 32, 32, 32)).astype(np.float32)
        m = (rng.random((2, 32, 32, 32)) < 0.4).astype(np.int32)
        out.append({"image": x, "mask": m})
    return out


def _run_hebbax(jm, variables, tx, batches, **step_kw):
    step = j_make_step(jm, "unet3d", j_dice, tx, **step_kw)
    state = JState(params=variables["params"],
                   batch_stats=variables["batch_stats"],
                   opt_state=tx.init(variables["params"]), step=0)
    losses = []
    for i, b in enumerate(batches):
        state, out = step(state, {"image": jnp.asarray(b["image"][..., None]),
                                  "mask": jnp.asarray(b["mask"])},
                          jax.random.PRNGKey(i))
        losses.append(float(out["loss"]))
    return state, losses


def _run_port(tm, optimizer, schedule, batches, **step_kw):
    step = make_sup_train_step(tm, "unet3d", dice_loss, **step_kw)
    state = TrainState(model=tm, optimizer=optimizer, schedule=schedule)
    losses = []
    for b in batches:
        state, out = step(state, to_device_batch_3d(b, "cpu"))
        losses.append(float(out["loss"]))
    assert state.step == len(batches)
    return losses


def _compare(jstate, tm, losses_j, losses_t, adam):
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    sd = tm.state_dict()
    for path, v in traverse_util.flatten_dict(jstate.params).items():
        mod = ".".join(path[:-1])
        v = np.asarray(v)
        if path[-1] == "kernel":
            perm = (3, 4, 0, 1, 2) if "upconv" in mod else (4, 3, 0, 1, 2)
            name, v = mod + ".weight", np.transpose(v, perm)
        else:
            name = mod + (".weight" if path[-1] == "scale" else ".bias")
        got = sd[name].numpy()
        if adam:
            far = np.abs(got - v) > 1e-5 + 1e-4 * np.abs(v)
            assert far.mean() <= 1e-2, (name, int(far.sum()))
            np.testing.assert_allclose(got, v, rtol=0, atol=1e-3,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(got, v, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
    for path, v in traverse_util.flatten_dict(jstate.batch_stats).items():
        name = ".".join(path[:-1]) + (".running_mean" if path[-1] == "mean"
                                      else ".running_var")
        np.testing.assert_allclose(sd[name].numpy(), np.asarray(v),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def _schedules(lr):
    return (warmup_step_schedule(lr, warmup=1, step_size=50, gamma=0.5,
                                 steps_per_epoch=1),
            WarmupStepLR(lr, warmup=1, step_size=50, gamma=0.5,
                         steps_per_epoch=1))


def test_pretrain_step_matches():
    jm, variables, tm, _ = make_pair(hebb=True, seed=4)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    batches = _batches(0)
    j_sched, t_sched = _schedules(1e-3)
    tx = j_make_optimizer("adam", j_sched)
    jstate, lj = _run_hebbax(
        jm, variables, tx, batches, hebb_alpha=1.0,
        trainable_mask=pretrain_trainable_mask(variables["params"],
                                               ("conv",)),
        backprop_only=("conv",))
    names = set(pretrain_trainable_names(tm, ("conv",)))
    opt = make_optimizer("adam", [p for n, p in tm.named_parameters()
                                  if n in names])
    lt = _run_port(tm, opt, t_sched, batches, hebb_alpha=1.0,
                   backprop_only=("conv",))
    _compare(jstate, tm, lj, lt, adam=True)
    after = dict(tm.named_parameters())
    # Hebbian kernels (convs and transpose convs) moved by -delta; frozen
    # BN affine and converted biases did not; the head trained by backprop
    for name in ("encoder.encoder1.conv1.weight", "decoder.upconv1.weight",
                 "conv.bias"):
        assert not torch.equal(after[name], before[name]), name
    for name in ("encoder.encoder1.norm1.bias", "decoder.upconv1.bias"):
        assert torch.equal(after[name], before[name]), name


def test_finetune_step_matches():
    _, variables, tm, _ = make_pair(seed=5)
    kw = dict(SPEC, alpha=0.0)
    jm = JUNet3D(in_channels=1, n_cls=2, init_features=4, hebb=JSpec(**kw))
    bind_paths(tm, HebbSpec(**kw))
    batches = _batches(1)
    j_sched, t_sched = _schedules(1e-2)
    tx = j_make_optimizer("sgd", j_sched, momentum=0.9, weight_decay=5e-5)
    jstate, lj = _run_hebbax(jm, variables, tx, batches)
    opt = make_optimizer("sgd", tm.parameters(), momentum=0.9,
                         weight_decay=5e-5)
    lt = _run_port(tm, opt, t_sched, batches)
    _compare(jstate, tm, lj, lt, adam=False)
