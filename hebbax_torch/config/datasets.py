"""Per-dataset constants: a copy of ``hebbax/config/datasets.py``.

Input channels, class counts, normalization statistics (including the
wavelet-variant statistics selected via ``--input1``), palettes, and the
3D patch-sampling configuration for Atrial/LA (unused until the 3D slice
is ported).  Kept as a copy so the port imports nothing of ``hebbax``.
"""

import numpy as np

_BINARY_PALETTE = list(np.array([[0, 0, 0], [255, 255, 255]]).flatten())

_CONFIG = {
    "GlaS": {
        "IN_CHANNELS": 3,
        "NUM_CLASSES": 2,
        "MEAN": [0.787803, 0.512017, 0.784938],
        "STD": [0.428206, 0.507778, 0.426366],
        "MEAN_HAAR_H": [0.528318],
        "STD_HAAR_H": [0.076766],
        "MEAN_HAAR_L": [0.579144],
        "STD_HAAR_L": [0.227451],
        "MEAN_HAAR_HHL": [0.542428],
        "STD_HAAR_HHL": [0.142663],
        "MEAN_HAAR_HLL": [0.569150],
        "STD_HAAR_HLL": [0.220854],
        "MEAN_BIOR1.5_H": [0.525711],
        "STD_BIOR1.5_H": [0.076606],
        "MEAN_BIOR2.4_H": [0.516579],
        "STD_BIOR2.4_H": [0.078798],
        "MEAN_COIF1_H": [0.523858],
        "STD_COIF1_H": [0.081001],
        "MEAN_DB2_H": [0.505234],
        "STD_DB2_H": [0.080919],
        "MEAN_DMEY_H": [0.502698],
        "STD_DMEY_H": [0.078861],
        "PALETTE": _BINARY_PALETTE,
    },
    "PH2": {
        "IN_CHANNELS": 3,
        "NUM_CLASSES": 2,
        "MEAN": [0.7534, 0.5765, 0.4885],
        "STD": [0.1647, 0.1598, 0.1588],
        "PALETTE": _BINARY_PALETTE,
    },
    "HMEPS": {
        "IN_CHANNELS": 3,
        "NUM_CLASSES": 2,
        "MEAN": [0.4614, 0.4614, 0.4614],
        "STD": [0.1188, 0.1188, 0.1188],
        "PALETTE": _BINARY_PALETTE,
    },
    "Atrial": {
        "IN_CHANNELS": 1,
        "NUM_CLASSES": 2,
        "NORMALIZE": "mean",  # z-normalize over voxels above the volume mean
        "PATCH_SIZE": (96, 96, 80),
        "FORMAT": ".nrrd",
        "NUM_SAMPLE_TRAIN": 4,
        "NUM_SAMPLE_VAL": 8,
        "PALETTE": _BINARY_PALETTE,
    },
    "OCT-CME": {
        "IN_CHANNELS": 3,
        "NUM_CLASSES": 2,
        "MEAN": [0.485, 0.456, 0.406],
        "STD": [0.229, 0.224, 0.225],
        "PALETTE": _BINARY_PALETTE,
    },
    "QaTa-COV19": {
        "IN_CHANNELS": 3,
        "NUM_CLASSES": 2,
        "MEAN": [0.485, 0.456, 0.406],
        "STD": [0.229, 0.224, 0.225],
        "PALETTE": _BINARY_PALETTE,
    },
}


def dataset_cfg(dataset_name):
    """Return the configuration dict for ``dataset_name``."""
    return _CONFIG[dataset_name]


def input_stats(cfg, input1):
    """Resolve the (mean, std) keys for an ``--input1`` selection.

    Mirrors hebbax's key scheme ``'MEAN_' + input1``
    (``hebbax/config/datasets.py`` ``input_stats``).
    """
    if input1 == "image":
        return cfg["MEAN"], cfg["STD"]
    return cfg["MEAN_" + input1], cfg["STD_" + input1]
