"""The control and the faults the check must catch, each a change to a
built trainer (``mutate(trainer)`` of :func:`portbench.harness.run_cell`)
or extra flags of the port's CLI.

* ``tf32``: the control, the precision below the configuration's float32
  with TF32 off: TF32 switched on for convolutions and matmuls after the
  port's CLI switched it off (K1 stays 3xTF32).
* ``bf16``: the port's own lower-precision path, ``--dtype bfloat16``.
* ``unchanged``: a step that leaves its state unchanged (the optimizer's
  step does nothing).
* ``half_batch``: half of a step's samples left out and the mean taken
  over the rest: in a semi step of one labelled and one unlabelled row,
  the unlabelled row is replaced by the labelled one.
* ``altered``: an answer altered where it is produced: the first
  trained parameter's gradient scaled by 1.1 before the optimizer
  reads it.
* ``drop_site``: a Hebbian step with one site's delta dropped (the
  Hebbian conv with the most weights records none).
* ``half_k``: a Hebbian step whose rule runs at half the configured
  inverse temperature K.

There is no exchange between cards to leave out: every cell runs on one.
"""

import dataclasses

import torch


def _tf32(trainer):
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True


def _unchanged(trainer):
    trainer.state.optimizer.step = lambda *a, **kw: None


def _half_batch(trainer):
    real = trainer.train_step

    def step(state, sup, unsup, *more):
        if sup["image"].shape[0] != 1 or unsup["image"].shape[0] != 1:
            raise NotImplementedError("half_batch plants one row of two")
        return real(state, sup, dict(unsup, image=sup["image"]), *more)

    trainer.train_step = step


def _altered(trainer):
    opt = trainer.state.optimizer
    real = opt.step
    first = opt.param_groups[0]["params"][0]

    def step(*a, **kw):
        if first.grad is not None:
            first.grad.mul_(1.1)
        return real(*a, **kw)

    opt.step = step


def _hebbian_sites(trainer):
    from hebbax_torch.hebb.layers import HConv
    return [m for m in trainer.state.model.modules()
            if isinstance(m, HConv) and m.spec is not None]


def _drop_site(trainer):
    site = max(_hebbian_sites(trainer), key=lambda m: m.weight.numel())
    site._record_delta = lambda *a, **kw: None


def _half_k(trainer):
    for m in _hebbian_sites(trainer):
        m.spec = dataclasses.replace(m.spec, k=m.spec.k / 2)


MUTATIONS = {"tf32": _tf32, "unchanged": _unchanged,
             "half_batch": _half_batch, "altered": _altered,
             "drop_site": _drop_site, "half_k": _half_k}
FLAGS = {"bf16": ["--dtype", "bfloat16"]}


def variant(name):
    """(mutate, extra_argv) of a variant; ``program`` is the program as it
    is."""
    if name == "program":
        return None, ()
    if name in FLAGS:
        return None, FLAGS[name]
    return MUTATIONS[name], ()
