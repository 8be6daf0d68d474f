"""Train and eval steps (``hebbax/engine/steps.py``).

A step takes a batch already on the model's device (NCHW images, int64
masks), runs one training forward — which also computes the Hebbian
deltas of the converted convs — and updates the model in place:

  grads = backprop grads (all trainable params, or only the head under
          ``backprop_only``)
  grads[kernel] = (1 - alpha) * grads[kernel] - alpha * delta   (alpha!=0)
  lr = schedule(step); optimizer.step()

The optimizer holds exactly the trainable parameters.  Like optax, it sees
a zero gradient (not a skipped one) for a trainable parameter no gradient
reached, so Adam's and SGD's moments decay the same way.

The unsupervised pretrainers' probe step takes two gradients of one
forward: the pretext loss over every parameter, the probe's segmentation
loss over the head only.

Under data parallelism (:mod:`hebbax_torch.parallel`) each rank holds the
global loss; its grads are all-reduced and divided by N
(:func:`~hebbax_torch.parallel.average_grads`) and its Hebbian deltas
summed (:func:`~hebbax_torch.parallel.sum_dict`) before they merge, so
every rank applies the single process's update.  The steps take
``torch.autograd.grad``, where DDP's reducer hooks never fire.
"""

import torch

from ..hebb.spec import is_excluded
from ..hebb.surgery import merge_hebbian_grads, pop_deltas
from ..models.registry import primary_logits
from ..parallel import average_grads, sum_dict
from ..utils import trace


def _module_path(param_name):
    return tuple(param_name.rsplit(".", 1)[0].split("."))


def sup_loss_fn(criterion, network, outputs, mask, deep_supervision=False):
    """Supervised loss: the criterion averaged over the heads of a
    multi-output network under deep supervision, else on the primary
    output."""
    if deep_supervision and isinstance(outputs, tuple):
        return sum(criterion(o, mask) for o in outputs) / len(outputs)
    return criterion(primary_logits(network, outputs), mask)


def forward(model, x):
    """``model(x)``, the step's forward, inside the ``hx.forward`` span."""
    with trace.span("hx.forward"):
        return model(x)


def apply_grads(optimizer, schedule, count, grads):
    """One optimizer step at ``schedule(count)``: every parameter the
    optimizer holds gets its grad from ``grads`` ({param: grad}), a zero
    where none reached it."""
    with trace.span("hx.optimizer"):
        lr = schedule(count)
        groups = optimizer.param_groups
        for group in groups:
            group["lr"] = lr
            for p in group["params"]:
                g = grads.get(p)
                p.grad = torch.zeros_like(p) if g is None else g
        optimizer.step()
        for group in groups:
            for p in group["params"]:
                p.grad = None


def make_sup_train_step(model, network: str, criterion,
                        deep_supervision: bool = False,
                        hebb_alpha: float = 0.0, backprop_only=None):
    """Supervised (or Hebbian pretraining) step ``(state, batch) ->
    (state, {'loss', 'logits'})``.

    deep_supervision: average the criterion over the four heads of a deep4
    network (the Hebbian pretraining of ``unet_urpc`` / ``unet_cct``,
    ``train_sup_2d -ds``).
    backprop_only: module-path prefixes (the Hebbian ``exclude`` head
    names).  When set, only the parameters under them are differentiated
    (``torch.autograd.grad`` over the head) and every other parameter has
    ``requires_grad`` off, so the trunk records no backward graph — the
    same result as the full backward at alpha=1, where every converted
    kernel's backprop grad is scaled by 0.  When it matches no module the
    backward is skipped and the loss is still reported.
    """
    params = dict(model.named_parameters())
    if backprop_only:
        heads = tuple(backprop_only)
        diff = [n for n in params if is_excluded(_module_path(n), heads)]
        for n, p in params.items():
            p.requires_grad_(n in diff)
    else:
        diff = [n for n, p in params.items() if p.requires_grad]

    def step(state, batch):
        model.train()
        pop_deltas(model)
        outputs = forward(model, batch["image"])
        loss = sup_loss_fn(criterion, network, outputs, batch["mask"],
                           deep_supervision)
        deltas = pop_deltas(model)
        grads = {}
        if diff:
            # a head the loss does not read (URPC's lower heads without
            # deep supervision) gets None here and a zero grad below
            gs = torch.autograd.grad(loss, [params[n] for n in diff],
                                     allow_unused=True)
            grads = average_grads(
                {n: g for n, g in zip(diff, gs) if g is not None})
        if hebb_alpha:
            grads = merge_hebbian_grads(params, grads, sum_dict(deltas),
                                        hebb_alpha)
        apply_grads(state.optimizer, state.schedule, state.step,
                    {params[n]: g for n, g in grads.items()})
        state.step += 1
        logits = primary_logits(network, outputs)
        return state, {"loss": loss.detach(), "logits": logits.detach()}

    return step


def probe_pretrain_update(state, params, losses, head_names):
    """One optimizer step of the reference's reset_internal_grads
    protocol from ``losses = (probe, unsup)`` of one forward: the unsup
    loss's grads reach every trainable parameter, the probe's only those
    under ``head_names``.  Two ``torch.autograd.grad`` calls over the one
    graph; a single backward of probe + unsup would let the probe train
    the trunk."""
    probe, unsup = losses
    names = [n for n, p in params.items() if p.requires_grad]
    head = [n for n in names if is_excluded(_module_path(n),
                                            tuple(head_names))]
    g_unsup = torch.autograd.grad(unsup, [params[n] for n in names],
                                  retain_graph=True, allow_unused=True)
    g_probe = torch.autograd.grad(probe, [params[n] for n in head],
                                  allow_unused=True)
    grads = {n: g for n, g in zip(names, g_unsup) if g is not None}
    for n, g in zip(head, g_probe):
        if g is not None:
            grads[n] = g if n not in grads else grads[n] + g
    grads = average_grads(grads)
    apply_grads(state.optimizer, state.schedule, state.step,
                {params[n]: g for n, g in grads.items()})
    state.step += 1
    return state


def make_probe_pretrain_step(model, network: str, criterion, unsup_loss,
                             head_names=("out_conv",)):
    """Unsupervised pretraining with a supervised probe head, ``(state,
    batch) -> (state, {'loss', 'loss_unsup', 'logits'})``: the probe's
    segmentation loss (``loss``) on the primary output trains only the
    ``head_names`` modules, ``unsup_loss(outputs, batch)`` trains every
    parameter (:func:`probe_pretrain_update`)."""
    params = dict(model.named_parameters())

    def step(state, batch):
        model.train()
        outputs = forward(model, batch["image"])
        logits = primary_logits(network, outputs)
        probe = criterion(logits, batch["mask"])
        unsup = unsup_loss(outputs, batch)
        state = probe_pretrain_update(state, params, (probe, unsup),
                                      head_names)
        return state, {"loss": probe.detach(), "loss_unsup": unsup.detach(),
                       "logits": logits.detach()}

    return step


def make_eval_step(model, network: str, criterion=None):
    """Inference step ``batch -> {'logits'[, 'loss']}`` in eval mode."""

    def step(batch):
        model.eval()
        with torch.no_grad():
            logits = primary_logits(network,
                                    forward(model, batch["image"]))
            out = {"logits": logits}
            if criterion is not None and "mask" in batch:
                out["loss"] = criterion(logits, batch["mask"])
        return out

    return step
