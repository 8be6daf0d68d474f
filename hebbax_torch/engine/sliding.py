"""Sliding-window 3D inference (``hebbax/engine/sliding.py``): tio
GridSampler(patch_size, patch_overlap) + GridAggregator(overlap_mode=
'average').

The volume is padded to at least the patch size; the patches of the grid
run through the model in fixed-size batches (the last batch padded with
the volume's first patch, whose output is dropped); their logits are added
into a device-resident volume in the grid's order and divided by the
per-voxel hit counts.  :func:`slide_window_inference` is hebbax's host
version, kept as the yardstick of the device one.

Under data parallelism (``test_3d --dp_devices N``, hebbax's mesh slider)
each patch batch is split over the ranks, each rank adds its patches'
logits into its own volume, and the volumes are summed over the ranks
before the hit counts divide them and the result is thresholded.
"""

import math
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from ..parallel import rank, sum_tensors, world_size


def grid_locations(vol_shape: Sequence[int], patch_size: Sequence[int],
                   overlap: Sequence[int]):
    """tio GridSampler location grid: stride = patch - overlap, last
    location clipped so the final patch abuts the border."""
    locs_per_dim = []
    for size, patch, ov in zip(vol_shape, patch_size, overlap):
        stride = patch - ov
        if size <= patch:
            locs = [0]
        else:
            n = math.ceil((size - patch) / stride) + 1
            locs = [min(i * stride, size - patch) for i in range(n)]
            locs = sorted(set(locs))
        locs_per_dim.append(locs)
    grid = []
    for x in locs_per_dim[0]:
        for y in locs_per_dim[1]:
            for z in locs_per_dim[2]:
                grid.append((x, y, z))
    return grid


def _pad_to_patch(vol, patch_size):
    pad = [max(0, p - s) for s, p in zip(vol.shape, patch_size)]
    if any(pad):
        vol = np.pad(vol, [(0, p) for p in pad])
    return vol


def slide_window_inference_device(forward: Callable, volume: np.ndarray,
                                  patch_size, overlap, n_cls: int,
                                  batch_size: int = 8, device=None,
                                  finalize: str = None,
                                  threshold: float = None):
    """The overlap-averaged prediction of ``volume`` (X, Y, Z), on
    ``device``, cropped to the volume's shape.

    forward(patches (B, 1, *patch) float32) -> logits (B, C, *patch), e.g.
    a model in eval mode; it runs under ``torch.no_grad()``.
    finalize: None -> (C, X, Y, Z) float32 averaged logits;
    'binary' -> (X, Y, Z) uint8, softmax class-1 probability > threshold
    (the stored per-run value, required); 'argmax' -> (X, Y, Z) uint8.
    Under data parallelism ``batch_size`` must be a multiple of the ranks;
    each rank forwards its contiguous share of every batch."""
    if finalize == "binary" and threshold is None:
        raise ValueError(
            "finalize='binary' requires an explicit threshold (the "
            "stored per-run value from training, or 0.5)")
    if finalize not in (None, "binary", "argmax"):
        raise ValueError(f"unknown finalize {finalize!r}")
    vol = _pad_to_patch(np.asarray(volume, np.float32), patch_size)
    locs = grid_locations(vol.shape, patch_size, overlap)
    hits = np.zeros(vol.shape, np.float32)
    for x, y, z in locs:
        hits[x:x + patch_size[0], y:y + patch_size[1],
             z:z + patch_size[2]] += 1.0
    inv_hits = torch.from_numpy(1.0 / np.maximum(hits, 1.0)).to(device)
    vol_d = torch.from_numpy(vol).to(device)
    acc = torch.zeros((n_cls,) + vol.shape, dtype=torch.float32,
                      device=device)
    px, py, pz = patch_size
    world = world_size()
    if batch_size % world:
        raise ValueError(f"batch_size {batch_size} is not a multiple of the "
                         f"{world} data-parallel ranks")
    local = batch_size // world
    lo = rank() * local
    with torch.no_grad():
        for start in range(0, len(locs), batch_size):
            chunk = locs[start:start + batch_size]
            padded = chunk + [(0, 0, 0)] * (batch_size - len(chunk))
            patches = torch.stack([vol_d[x:x + px, y:y + py, z:z + pz]
                                   for x, y, z in padded[lo:lo + local]])
            out = forward(patches[:, None]).float()
            for j, (x, y, z) in enumerate(chunk[lo:lo + local]):
                acc[:, x:x + px, y:y + py, z:z + pz] += out[j]
        sum_tensors([acc])
        agg = acc * inv_hits
        if finalize == "binary":
            agg = (torch.softmax(agg, dim=0)[1] > threshold).to(torch.uint8)
        elif finalize == "argmax":
            agg = torch.argmax(agg, dim=0).to(torch.uint8)
    sx, sy, sz = np.shape(volume)
    return agg[..., :sx, :sy, :sz]


def slide_window_inference(forward: Callable, volume: np.ndarray,
                           patch_size: Tuple[int, int, int],
                           overlap: Tuple[int, int, int],
                           n_cls: int, batch_size: int = 8) -> np.ndarray:
    """Aggregate per-patch logits over a volume on the host (hebbax's
    version, channels-last).

    forward(patches (B, *patch, 1) float32) -> logits (B, *patch, C).
    Returns (X, Y, Z, C) float32 overlap-averaged logits.
    """
    vol = _pad_to_patch(np.asarray(volume, np.float32), patch_size)
    locs = grid_locations(vol.shape, patch_size, overlap)
    logits_sum = np.zeros(vol.shape + (n_cls,), np.float32)
    hits = np.zeros(vol.shape, np.float32)

    for start in range(0, len(locs), batch_size):
        chunk = locs[start:start + batch_size]
        patches = np.stack([
            vol[x:x + patch_size[0], y:y + patch_size[1],
                z:z + patch_size[2]] for x, y, z in chunk])
        n_valid = len(chunk)
        if n_valid < batch_size:  # pad to keep the batch shape fixed
            patches = np.concatenate(
                [patches, np.repeat(patches[-1:],
                                    batch_size - n_valid, axis=0)])
        out = np.asarray(forward(patches[..., None]))
        for j, (x, y, z) in enumerate(chunk):
            logits_sum[x:x + patch_size[0], y:y + patch_size[1],
                       z:z + patch_size[2]] += out[j]
            hits[x:x + patch_size[0], y:y + patch_size[1],
                 z:z + patch_size[2]] += 1.0
    agg = logits_sum / np.maximum(hits, 1.0)[..., None]
    sx, sy, sz = np.shape(volume)
    return agg[:sx, :sy, :sz]
