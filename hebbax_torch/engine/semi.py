"""Semi-supervised training (``hebbax/engine/semi.py``): one step per
algorithm built from shared pieces, and the epoch harnesses.

The reference's two-phase backward (unsup.backward(retain_graph=True);
sup.backward(); step()) is one step on sup + w*unsup, since the
pseudo-labels and teacher outputs are detached, so each step takes one
backward of that total.  Every step runs the unsup forward before the sup
forward, so the batch-norm running statistics take their two momentum
updates per step in the reference's order.  The linear unsup ramp
w*(epoch+1)/E is applied by the harness.

Random draws come from explicit ``torch.Generator``s (CCT's perturbations
from the model's, UAMT's noise from the step's); a caller may pass UAMT's
noise in as a tensor.

Under data parallelism the steps average their grads over the ranks
(:func:`hebbax_torch.parallel.average_grads`), and the per-sample
``weight`` of a padded batch masks the padded samples out of UAMT's
consistency and CPS's pseudo-labels, as hebbax's do.
"""

import dataclasses
import math
from typing import Callable, Optional

import torch

from ..bridge import kernel_layout
from ..models.registry import primary_logits
from ..ops.ema import update_ema
from ..ops.losses import entropy_loss, softmax_mse_loss, weighted_mean
from ..ops.metrics import make_accumulator
from ..parallel import average_grads, draw_rows, gsum
from ..utils import trace
from ..utils.checkpoint import save_snapshot
from .loop import SupTrainer
from .steps import apply_grads, forward


def _trainable(model):
    return [p for p in model.parameters() if p.requires_grad]


def _detached(out):
    return {k: v.detach() for k, v in out.items()}


# ---------------------------------------------------------------------------
# Single-model algorithms: EM, URPC, CCT, DTC
# ---------------------------------------------------------------------------

def make_semi_step(model, network: str, criterion, unsup_fn: Callable,
                   sup_fn: Optional[Callable] = None):
    """Single-model semi step ``(state, sup_batch, unsup_batch,
    unsup_weight) -> (state, {'loss', 'loss_sup', 'loss_unsup',
    'logits'})``.

    unsup_fn(outputs_unsup, unsup_batch) -> scalar consistency / entropy
    objective; sup_fn(outputs_sup, sup_batch) -> scalar supervised loss
    (default: the criterion on the primary output).
    """
    if sup_fn is None:
        def sup_fn(outputs, batch):
            return criterion(primary_logits(network, outputs),
                             batch["mask"])
    params = _trainable(model)

    def step(state, sup_batch, unsup_batch, unsup_weight):
        model.train()
        out_u = forward(model, unsup_batch["image"])
        out_s = forward(model, sup_batch["image"])
        # hebbax's weight is a float32 array: a bfloat16 objective is
        # promoted before it is scaled
        loss_u = unsup_fn(out_u, unsup_batch).float() * unsup_weight
        loss_s = sup_fn(out_s, sup_batch)
        loss = loss_s + loss_u
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        apply_grads(state.optimizer, state.schedule, state.step,
                    average_grads(dict(zip(params, grads))))
        state.step += 1
        return state, _detached({"loss": loss, "loss_sup": loss_s,
                                 "loss_unsup": loss_u,
                                 "logits": primary_logits(network, out_s)})

    return step


def em_unsup(num_classes):
    """Entropy minimization on the unlabelled softmax."""

    def fn(outputs, batch):
        return entropy_loss(torch.softmax(outputs, dim=1), num_classes,
                            weight=batch.get("weight"))

    return fn


def urpc_unsup(outputs, batch):
    """Uncertainty-rectified pyramid consistency: the mean softmax over the
    4 scales; each scale's squared distance to it weighted by exp(-KL),
    plus the KL."""
    w = batch.get("weight")
    ps = [torch.softmax(o, dim=1) for o in outputs]
    mean_p = sum(ps) / len(ps)
    log_mean = torch.log(mean_p)
    total = 0.0
    for p in ps:
        # KLDivLoss(log_mean, p) = p*(log p - log_mean), summed over C
        var = torch.sum(p * (torch.log(p + 1e-8) - log_mean), dim=1,
                        keepdim=True)
        exp_var = torch.exp(-var)
        dist = (mean_p - p) ** 2
        total = total + (weighted_mean(dist * exp_var, w)
                         / (weighted_mean(exp_var, w) + 1e-8)
                         + weighted_mean(var, w))
    return total / len(ps)


def cct_unsup(outputs, batch):
    """Cross-consistency: MSE between the main softmax and each perturbed
    pass's softmax."""
    w = batch.get("weight")
    main = torch.softmax(outputs[0], dim=1)
    total = 0.0
    for aux in outputs[1:]:
        total = total + weighted_mean(
            (main - torch.softmax(aux, dim=1)) ** 2, w)
    return total / (len(outputs) - 1)


def deep4_sup(criterion):
    """The criterion averaged over the 4 heads."""

    def fn(outputs, batch):
        mask = batch["mask"]
        return sum(criterion(o, mask) for o in outputs) / len(outputs)

    return fn


def dtc_unsup(outputs, batch):
    """Dual-task consistency: the MSE between sigmoid(-1500 * sdf), the
    SDF head mapped to a soft segmentation, and sigmoid(seg)."""
    sdf, seg = outputs
    return weighted_mean((torch.sigmoid(-1500.0 * sdf)
                          - torch.sigmoid(seg)) ** 2, batch.get("weight"))


def dtc_sup(criterion, beta=0.3, num_classes=2):
    """DTC's supervised loss: the criterion on the segmentation head plus
    beta times the MSE of the SDF head's class-1 channel to
    ``mask_sdf`` (and of its class-2 channel to ``mask_sdf2`` at 3
    classes)."""

    def fn(outputs, batch):
        sdf, seg = outputs
        w = batch.get("weight")
        loss_sdf = weighted_mean((sdf[:, 1] - batch["mask_sdf"]) ** 2, w)
        if num_classes == 3 and "mask_sdf2" in batch:
            loss_sdf = loss_sdf + weighted_mean(
                (sdf[:, 2] - batch["mask_sdf2"]) ** 2, w)
        return criterion(seg, batch["mask"]) + beta * loss_sdf

    return fn


# ---------------------------------------------------------------------------
# Dual-model algorithms: UAMT (EMA teacher), CPS (second network)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DualState:
    """Two models; UAMT's teacher (model 2) has no optimizer."""
    model1: torch.nn.Module
    optimizer1: torch.optim.Optimizer
    schedule1: Callable[[int], float]
    model2: torch.nn.Module
    optimizer2: Optional[torch.optim.Optimizer] = None
    schedule2: Optional[Callable[[int], float]] = None
    step: int = 0

    def model(self, which: int):
        return self.model1 if which == 1 else self.model2

    def state_dict(self, which: int = 1):
        return self.model(which).state_dict()


def uamt_noise(images, n, generator=None):
    """n draws of clamp(0.1*N(0,1), +-0.2) shaped like ``images``: the
    teacher's, then the MC ones (the global batch's draws under data
    parallelism, this rank's rows)."""
    z = draw_rows(lambda shape: torch.randn(
        shape, dtype=images.dtype, device=images.device,
        generator=generator), (n,) + tuple(images.shape), axis=1)
    return torch.clamp(0.1 * z, -0.2, 0.2)


def uamt_threshold(epoch, num_epochs):
    """(0.75 + 0.25*exp(-5(1 - clip(epoch/E))^2)) * ln 2, in float32."""
    phase = torch.clamp(torch.tensor(epoch, dtype=torch.float32)
                        / num_epochs, 0.0, 1.0)
    rampup = torch.exp(-5.0 * (1.0 - phase) ** 2)
    return float((0.75 + 0.25 * rampup)
                 * torch.tensor(math.log(2.0), dtype=torch.float32))


def make_uamt_step(model, teacher, network: str, criterion,
                   num_epochs: int, ema_decay: float = 0.99, mc_T: int = 8,
                   generator=None):
    """Uncertainty-aware mean teacher, ``(state, sup_batch, unsup_batch,
    unsup_weight, epoch, noise=None) -> (state, out)``.

    The teacher (``state.model2``, ``teacher`` here) sees the noised
    unsup batch in train mode, then mc_T more noised batches one after
    another, each moving its BN statistics, all without gradient.  The
    uncertainty is the entropy of the mean MC softmax; the consistency is
    the softmax MSE to the teacher, kept where the uncertainty is below
    :func:`uamt_threshold`.  After the optimizer step the teacher's
    parameters (not its BN statistics) move to the student's EMA with
    alpha = min(1 - 1/(epoch+1), ema_decay).  ``noise`` ((1+mc_T, *image
    shape)) replaces the draws from ``generator``.
    """
    params = _trainable(model)

    def step(state, sup_batch, unsup_batch, unsup_weight, epoch,
             noise=None):
        img_u = unsup_batch["image"]
        if noise is None:
            noise = uamt_noise(img_u, mc_T + 1, generator)
        teacher.train()
        with torch.no_grad():
            t_logits = primary_logits(network,
                                      forward(teacher, img_u + noise[0]))
            probs = [torch.softmax(primary_logits(
                network, forward(teacher, img_u + noise[1 + t])), dim=1)
                for t in range(mc_T)]
            mean_probs = torch.mean(torch.stack(probs), dim=0)
            uncertainty = -torch.sum(
                mean_probs * torch.log(mean_probs + 1e-6), dim=1,
                keepdim=True)
            # compared in float32, as hebbax's float32 threshold is
            unc_mask = (uncertainty.float() < uamt_threshold(
                epoch, num_epochs)).to(torch.float32)
            w = unsup_batch.get("weight")
            if w is not None:   # padded samples leave both sums
                unc_mask = unc_mask * w.reshape(
                    (-1,) + (1,) * (unc_mask.dim() - 1))

        model.train()
        logits_u = primary_logits(network, forward(model, img_u))
        logits_s = primary_logits(network,
                                  forward(model, sup_batch["image"]))
        cons = softmax_mse_loss(logits_u, t_logits)
        loss_u = (gsum(torch.sum(unc_mask * cons))
                  / (2 * gsum(torch.sum(unc_mask)) + 1e-16)) * unsup_weight
        loss_s = criterion(logits_s, sup_batch["mask"])
        loss = loss_s + loss_u
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        apply_grads(state.optimizer1, state.schedule1, state.step,
                    average_grads(dict(zip(params, grads))))
        update_ema(teacher, model, ema_decay, epoch)
        state.step += 1
        return state, _detached({"loss": loss, "loss_sup": loss_s,
                                 "loss_unsup": loss_u, "logits": logits_s})

    return step


def make_cps_step(model1, model2, network: str, criterion):
    """Cross pseudo supervision ``(state, sup_batch, unsup_batch,
    unsup_weight) -> (state, out)``: each network is supervised by the
    other's argmax pseudo-label on the unlabelled batch and both by the
    labels; one backward, then each optimizer on its own schedule."""
    p1, p2 = _trainable(model1), _trainable(model2)

    def step(state, sup_batch, unsup_batch, unsup_weight):
        model1.train()
        model2.train()
        img_u = unsup_batch["image"]
        l1u = primary_logits(network, forward(model1, img_u))
        l2u = primary_logits(network, forward(model2, img_u))
        pl1 = torch.argmax(l1u.detach(), dim=1)
        pl2 = torch.argmax(l2u.detach(), dim=1)
        w = unsup_batch.get("weight")
        if w is not None:   # padded samples' pseudo-labels -> ignore
            keep = w.reshape((-1,) + (1,) * (pl1.dim() - 1)) > 0
            pl1 = torch.where(keep, pl1, -1)
            pl2 = torch.where(keep, pl2, -1)
        loss_u = (criterion(l1u, pl2) + criterion(l2u, pl1)) * unsup_weight
        l1s = primary_logits(network, forward(model1, sup_batch["image"]))
        l2s = primary_logits(network, forward(model2, sup_batch["image"]))
        loss_s = (criterion(l1s, sup_batch["mask"])
                  + criterion(l2s, sup_batch["mask"]))
        loss = loss_s + loss_u
        grads = average_grads(dict(zip(
            p1 + p2, torch.autograd.grad(loss, p1 + p2, allow_unused=True))))
        apply_grads(state.optimizer1, state.schedule1, state.step,
                    {p: grads[p] for p in p1})
        apply_grads(state.optimizer2, state.schedule2, state.step,
                    {p: grads[p] for p in p2})
        state.step += 1
        return state, _detached({"loss": loss, "loss_sup": loss_s,
                                 "loss_unsup": loss_u, "logits": l1s,
                                 "logits2": l2s})

    return step


# ---------------------------------------------------------------------------
# Harnesses
# ---------------------------------------------------------------------------

class SemiTrainer(SupTrainer):
    """Single-model semi harness: an epoch is one pass over 'train_sup';
    each sup batch is paired with the next batch of 'train_unsup', from an
    iterator that persists across epochs and cycles; the unsup weight
    ramps as u*(epoch+1)/E; logging gains the unsup and total losses."""

    train_key = "train_sup"

    def __init__(self, *, unsup_weight, **kw):
        super().__init__(**kw)
        self.unsup_weight = unsup_weight
        self._unsup_gen = None

    def epoch_weight(self, epoch):
        return self.unsup_weight * (epoch + 1) / self.args.num_epochs

    def _unsup_iter(self):
        while True:
            yield from self.loaders["train_unsup"]

    def next_unsup(self):
        if self._unsup_gen is None:
            self._unsup_gen = self._unsup_iter()
        with trace.span("hx.data.next"):
            return next(self._unsup_gen)

    def call_step(self, sup_b, unsup_b, w, epoch):
        return self.train_step(self.state, sup_b, unsup_b, w)

    def train_epoch(self, epoch, collect_metrics):
        with trace.span("hx.epoch"):
            acc = (make_accumulator(self.num_classes) if collect_metrics
                   else None)
            totals = {"loss": 0.0, "loss_sup": 0.0, "loss_unsup": 0.0}
            n = 0
            w = self.epoch_weight(epoch)
            for sup_batch in trace.iterate(self.loaders[self.train_key],
                                           "hx.data.next"):
                unsup_b = self.prep(self.next_unsup())
                sup_b = self.prep(sup_batch)  # last: the valid rows are its
                with trace.span("hx.step"):
                    self.state, out = self.call_step(sup_b, unsup_b, w,
                                                     epoch)
                for k in totals:
                    totals[k] = totals[k] + out[k]    # device accumulation
                n += 1
                if acc is not None:
                    with trace.span("hx.metrics"):
                        acc.update(self._valid(out["logits"]),
                                   self._valid(sup_b["mask"]))
            n = max(n, 1)
            with trace.span("hx.epoch.read"):
                self._epoch_losses = {k: float(v) / n
                                      for k, v in totals.items()}
            return self._epoch_losses["loss"], acc


class UAMTTrainer(SemiTrainer):
    def call_step(self, sup_b, unsup_b, w, epoch):
        return self.train_step(self.state, sup_b, unsup_b, w, epoch)


class DualEvalMixin:
    """Validation of both models of a DualState; the winner by JI is saved
    as best_JI.ckpt, model 1's last snapshot in ``checkpoints/`` and model
    2's in ``checkpoints2/``.

    Model 2 is validated through ``eval_model2``, a network with model 1's
    Hebbian spec (UAMT's teacher itself; for CPS a twin that takes model
    2's weights before each validation), as hebbax validates both members
    through model 1's module: the weight-normalized forward that the
    saved snapshot's hebb_params describe.  As hebbax's, it counts every
    row of a data-parallel padded batch, the padding included.
    """

    def __init__(self, *, eval_model2, eval_step2, **kw):
        super().__init__(**kw)
        self.eval_model2 = eval_model2
        self.eval_step2 = eval_step2
        self._winner = 1

    def validate(self, epoch):
        if self.eval_model2 is not self.state.model2:
            self.eval_model2.load_state_dict(self.state.model2.state_dict())
        steps = (self.eval_step, self.eval_step2)
        accs = [make_accumulator(self.num_classes),
                make_accumulator(self.num_classes)]
        losses = [0.0, 0.0]
        n_batches = 0
        for batch in self.loaders["val"]:
            b = self.prep(batch)
            for i in (0, 1):
                out = steps[i](b)
                accs[i].update(out["logits"], b["mask"])
                if "loss" in out:
                    losses[i] = losses[i] + out["loss"]
            n_batches += 1
        ev1, ev2 = accs[0].finalize(), accs[1].finalize()
        self._winner = 2 if ev2[1] > ev1[1] else 1
        ev = ev2 if self._winner == 2 else ev1
        l1 = float(losses[0]) / max(n_batches, 1)
        l2 = float(losses[1]) / max(n_batches, 1)
        self.printer.line(f"Val Loss 2: {l2:.4f}")
        self.writer.add_scalar("val/segm_loss2", l2, epoch + 1)
        return l1, ev, [], []

    def _save_best(self, threshold, epoch):
        save_snapshot(self.state.state_dict(self._winner),
                      self.paths.checkpoints, threshold=threshold,
                      save_best=True,
                      **kernel_layout(self.state.model1),
                      **self.hebb_meta)

    def _save_last(self, threshold):
        for which, path in ((1, self.paths.checkpoints),
                            (2, self.paths.checkpoints + "2")):
            save_snapshot(self.state.state_dict(which), path,
                          threshold=threshold, save_best=False,
                          **kernel_layout(self.state.model1),
                          **self.hebb_meta)


class CPSTrainer(DualEvalMixin, SemiTrainer):
    pass


class UAMTDualTrainer(DualEvalMixin, UAMTTrainer):
    pass
