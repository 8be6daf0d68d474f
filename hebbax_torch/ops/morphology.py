"""Binary 3D post-processing: hole filling + largest connected component,
a copy of ``hebbax/ops/morphology.py`` (the reference's skimage pipeline
on scipy.ndimage).
"""

import numpy as np
from scipy import ndimage


def remove_small_holes(mask, area_threshold=500):
    """Fill background cavities smaller than ``area_threshold`` voxels.

    skimage.morphology.remove_small_holes semantics: a hole is a background
    component of the complement not connected to the border (connectivity 1).
    """
    mask = np.asarray(mask, bool)
    comp = ~mask
    labels, n = ndimage.label(comp)
    if n == 0:
        return mask.copy()
    # components touching the border are not holes
    border = np.zeros_like(mask)
    sl = [slice(None)] * mask.ndim
    for d in range(mask.ndim):
        for edge in (0, -1):
            s = list(sl)
            s[d] = edge
            border[tuple(s)] = True
    border_labels = np.unique(labels[border])
    sizes = np.bincount(labels.ravel())
    fill = np.zeros(n + 1, bool)
    for lab in range(1, n + 1):
        if lab not in border_labels and sizes[lab] < area_threshold:
            fill[lab] = True
    return mask | fill[labels]


def keep_largest_component(mask):
    """Zero all but the largest connected component (the reference's utils)."""
    mask = np.asarray(mask, bool)
    labels, n = ndimage.label(mask)
    if n == 0:
        return labels.astype(np.uint8)
    sizes = np.bincount(labels.ravel())
    sizes[0] = 0
    keep = sizes.argmax()
    return (labels == keep).astype(np.uint8)


def postprocess_3d_pred(pred, fill_hole_thr=500):
    """Hole-fill then keep the largest component (Atrial branch)."""
    pred = remove_small_holes(np.asarray(pred, bool), fill_hole_thr)
    return keep_largest_component(pred.astype(np.uint8))
