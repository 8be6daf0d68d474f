"""Streaming evaluation metrics (``hebbax/ops/metrics.py``).

Per-batch counters stay on the device; the threshold sweep is a
broadcasted compare + reduce over the 45 thresholds
``np.arange(0, 0.9, 0.02)`` (cast to the probabilities' dtype, as hebbax
does), and the argmax-Jaccard selection happens once at ``finalize``.
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


def make_accumulator(num_classes):
    if num_classes == 2:
        return SweepAccumulator()
    raise NotImplementedError(
        "multi-class confusion metrics are not ported yet")
