"""Surface-distance metrics (HD95, ASSD): a copy of
``hebbax/ops/distance.py`` on scipy.ndimage primitives.

  surface_distances(A, B): euclidean distance from each border pixel of A
    to the border of B, borders extracted as ``A ^ erode(A)`` with the
    connectivity-1 structuring element (medpy ``__surface_distances``).
  hd95  = 95th percentile of the pooled bidirectional surface distances.
  assd  = mean of (mean d(A->B), mean d(B->A)).

:func:`eval_distance_offline` is the 3D tester's per-volume evaluation
over saved predictions.
"""

import numpy as np
from scipy import ndimage


def _border(mask, connectivity=1):
    mask = np.asarray(mask, bool)
    structure = ndimage.generate_binary_structure(mask.ndim, connectivity)
    eroded = ndimage.binary_erosion(mask, structure=structure, border_value=0)
    return mask ^ eroded


def surface_distances(result, reference, voxelspacing=None, connectivity=1):
    result_border = _border(result, connectivity)
    reference_border = _border(reference, connectivity)
    if not reference_border.any():
        raise RuntimeError("reference has no surface voxels")
    dt = ndimage.distance_transform_edt(~reference_border,
                                        sampling=voxelspacing)
    return dt[result_border]


def hd95(result, reference, voxelspacing=None, connectivity=1):
    d1 = surface_distances(result, reference, voxelspacing, connectivity)
    d2 = surface_distances(reference, result, voxelspacing, connectivity)
    return float(np.percentile(np.hstack((d1, d2)), 95))


def assd(result, reference, voxelspacing=None, connectivity=1):
    d1 = surface_distances(result, reference, voxelspacing, connectivity)
    d2 = surface_distances(reference, result, voxelspacing, connectivity)
    return float(np.mean((d1.mean(), d2.mean())))


def evaluate_distance_binary(probs_fg, masks, thresholds):
    """The reference's evaluate_distance for the binary case: per
    sample, min over the threshold sweep of HD95/ASSD (skipping empty
    preds/masks), then sample-mean."""
    hd_list, sd_list = [], []
    for i in range(len(masks)):
        hd_ = np.zeros(len(thresholds))
        sd_ = np.zeros(len(thresholds))
        score = np.asarray(probs_fg[i])
        for t, thr in enumerate(thresholds):
            pred = (score > thr).astype(np.int8)
            score = pred  # the reference overwrites scores in place
            if np.any(pred) and np.any(masks[i] != 0):
                hd_[t] = hd95(pred, masks[i])
                sd_[t] = assd(pred, masks[i])
        hd_list.append(np.min(hd_))
        sd_list.append(np.min(sd_))
    return float(np.mean(hd_list)), float(np.mean(sd_list))


def eval_distance_offline(mask_list, pred_list, num_classes=2):
    """Offline HD95/ASSD over saved predictions: per volume, skipping a
    volume whose prediction or mask is empty, then the mean (per class,
    then over the classes, for a multi-class task).  NaN when every
    volume was skipped."""
    if num_classes == 2:
        hd_list, sd_list = [], []
        for m, p in zip(mask_list, pred_list):
            if np.any(p) and np.any(m):
                hd_list.append(hd95(p, m))
                sd_list.append(assd(p, m))
        return float(np.mean(hd_list)), float(np.mean(sd_list))
    hd_out, sd_out = [], []
    for cls in range(num_classes - 1):
        hd_list, sd_list = [], []
        for m, p in zip(mask_list, pred_list):
            m_ = np.where(m == cls + 1, m, 0)
            p_ = np.where(p == cls + 1, p, 0)
            if np.any(p_) and np.any(m_):
                hd_list.append(hd95(p_, m_))
                sd_list.append(assd(p_, m_))
        hd_out.append(np.mean(hd_list))
        sd_out.append(np.mean(sd_list))
    return float(np.mean(hd_out)), float(np.mean(sd_out))
