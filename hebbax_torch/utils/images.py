"""Prediction image dumps (``hebbax/utils/images.py``): binary predictions
thresholded at the selected threshold, saved as paletted PNGs.  The PNG
is written here with zlib and struct, so the port needs no PIL to save
predictions."""

import os
import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind, data):
    body = kind + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def encode_paletted_png(pred, palette):
    """PNG bytes of a (H, W) uint8 index image with an RGB palette given
    as a flat [r0, g0, b0, r1, ...] list (colour type 3, bit depth 8)."""
    pred = np.ascontiguousarray(pred, np.uint8)
    if pred.ndim != 2:
        raise ValueError(f"expected a 2D index image, got {pred.shape}")
    h, w = pred.shape
    pal = bytes(int(v) & 0xFF for v in palette)
    if len(pal) % 3 or not 3 <= len(pal) <= 768:
        raise ValueError("palette must hold 1 to 256 RGB triples")
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0)
    # filter type 0 (None) before every scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8), pred], axis=1)
    return (_PNG_SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"PLTE", pal)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + _chunk(b"IEND", b""))


def save_pred_png(pred, path, palette):
    with open(path, "wb") as f:
        f.write(encode_paletted_png(pred, palette))


def save_preds(probs_fg_or_labels, threshold, names, out_dir, palette):
    """probs_fg_or_labels: (N,H,W) foreground probabilities, thresholded
    here, or, with ``threshold`` None, values cast to uint8 labels (the
    multi-class snapshot's case, as hebbax's)."""
    os.makedirs(out_dir, exist_ok=True)
    arr = np.asarray(probs_fg_or_labels)
    for i, name in enumerate(names):
        if threshold is not None:
            pred = (arr[i] > threshold).astype(np.uint8)
        else:
            pred = arr[i].astype(np.uint8)
        save_pred_png(pred, os.path.join(out_dir, str(name)), palette)
