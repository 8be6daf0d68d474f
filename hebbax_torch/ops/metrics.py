"""Streaming evaluation metrics (``hebbax/ops/metrics.py``).

Per-batch counters stay on the device and are read once at ``finalize``.
A binary task (:class:`SweepAccumulator`) sweeps the 45 thresholds
``np.arange(0, 0.9, 0.02)`` (cast to the probabilities' dtype, as hebbax
does) as a broadcasted compare + reduce and picks the argmax-Jaccard
threshold; a task of N != 2 classes (:class:`ConfusionAccumulator`)
bincounts ``target * N + argmax`` into an N x N confusion histogram and
returns the mean Jaccard / Dice over the classes, with no threshold.
Under data parallelism both sum their counters over the ranks first.
"""

import numpy as np
import torch

from ..parallel import active, sum_tensors

THR_RANGE = (0.0, 0.9)
THR_INTERVAL = 0.02
THRESHOLDS = np.arange(THR_RANGE[0], THR_RANGE[1], THR_INTERVAL)


def sweep_counts(probs_fg, target):
    """Per-threshold (tp, union) counts for one batch; union counts pixels
    where exactly one of (pred, true) is 1."""
    thr = torch.as_tensor(THRESHOLDS, dtype=probs_fg.dtype,
                          device=probs_fg.device).reshape(-1, 1)
    p = probs_fg.reshape(1, -1)
    t = target.reshape(1, -1).to(probs_fg.dtype)
    pred = (p > thr).to(probs_fg.dtype)
    tp = torch.sum(pred * t, dim=1)
    union = torch.sum(torch.abs(pred - t), dim=1)
    return tp, union


class SweepAccumulator:
    """Accumulates per-threshold TP/union counters batch by batch from
    binary-task logits (N, 2, H, W); finalize() returns
    (best_threshold, jaccard, dice)."""

    def __init__(self):
        self.tp = None
        self.union = None

    def update(self, logits, target):
        # the softmax and the per-batch counts in the logits' dtype, the
        # running counters in float32, as hebbax's
        probs = torch.softmax(logits.detach(), dim=1)[:, 1]
        tp, union = (c.float() for c in sweep_counts(probs, target))
        if self.tp is None:
            self.tp, self.union = tp, union
        else:
            self.tp, self.union = self.tp + tp, self.union + union
        return self

    def finalize(self):
        """Under data parallelism the counters are first summed over the
        ranks (every rank counts its valid rows; a rank with none updates
        with an empty batch, so every rank holds counters)."""
        if active() and self.tp is not None:
            self.tp, self.union = sum_tensors([self.tp.clone(),
                                               self.union.clone()])
        n = len(THRESHOLDS)
        tp = (np.zeros(n) if self.tp is None
              else self.tp.double().cpu().numpy())
        union = (np.zeros(n) if self.union is None
                 else self.union.double().cpu().numpy())
        with np.errstate(invalid="ignore", divide="ignore"):
            jaccard = np.nan_to_num(tp / (union + tp))
            dice = np.nan_to_num(2 * tp / (union + 2 * tp))
        idx = int(np.argmax(jaccard))
        return float(THRESHOLDS[idx]), float(jaccard[idx]), float(dice[idx])


class ConfusionAccumulator:
    """Multi-class confusion-matrix accumulation from logits (N, C, ...)
    and integer targets: the argmax over the classes, then a bincount of
    ``target * num_classes + pred`` into a float32 histogram, as hebbax's.
    finalize() returns (None, nanmean Jaccard, nanmean Dice) in float64."""

    def __init__(self, num_classes):
        self.num_classes = num_classes
        self.hist = None

    def update(self, logits, target):
        n = self.num_classes
        pred = torch.argmax(logits.detach(), dim=1)
        idx = target.to(pred.device, torch.int64) * n + pred
        counts = torch.bincount(idx.reshape(-1), minlength=n * n).float()
        self.hist = counts if self.hist is None else self.hist + counts
        return self

    def finalize(self):
        """Under data parallelism the histogram is first summed over the
        ranks, as :meth:`SweepAccumulator.finalize` sums its counters."""
        n = self.num_classes
        if active() and self.hist is not None:
            (self.hist,) = sum_tensors([self.hist.clone()])
        hist = (np.zeros((n, n)) if self.hist is None
                else self.hist.double().cpu().numpy().reshape(n, n))
        diag = np.diag(hist)
        s0 = hist.sum(axis=0)
        s1 = hist.sum(axis=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            jaccard = diag / (s1 + s0 - diag)
            dice = 2 * diag / (s1 + s0)
        return None, float(np.nanmean(jaccard)), float(np.nanmean(dice))


def eval_single_class(logits, target):
    """One-shot binary evaluation of a whole (N, 2, ...) logits tensor."""
    return SweepAccumulator().update(torch.as_tensor(logits),
                                     torch.as_tensor(target)).finalize()


def eval_multi_class(logits, target, num_classes=None):
    """One-shot multi-class evaluation of a whole (N, C, ...) logits
    tensor; ``num_classes`` defaults to C."""
    logits = torch.as_tensor(logits)
    if num_classes is None:
        num_classes = logits.shape[1]
    return ConfusionAccumulator(num_classes).update(
        logits, torch.as_tensor(target)).finalize()


def evaluate(num_classes, logits, target):
    """(threshold or None, jaccard, dice) of channels-first logits."""
    if num_classes == 2:
        return eval_single_class(logits, target)
    return eval_multi_class(logits, target, num_classes)


def make_accumulator(num_classes):
    if num_classes == 2:
        return SweepAccumulator()
    return ConfusionAccumulator(num_classes)
