"""2D train augmentation on the batch's device
(``hebbax/ops/augment_device.py``).

The host datasets then give resized and normalized items only
(``SegDataset2D.host_augment = False``), and each train step draws, per
sample, the distribution of the host chain (hebbax's and the
reference's albumentations chain):

  flip with p = 0.75, its direction uniform over {vertical, horizontal,
  both}; then transpose with p = 0.5; then rot90 with k uniform over
  {0, 1, 2, 3}.

The image and its mask get the same transform.  The draws come from an
explicit ``torch.Generator`` (the caller's stream; they are not hebbax's
``jax.random`` draws, as dropout's are not) and the transforms run where
the tensors lie.  Square spatial dims are required, as in hebbax.
"""

import torch

from ..parallel import rows, world_size

FLIP_P = 0.75
TRANSPOSE_P = 0.5


def draw_transforms(generator, n):
    """(flip_on, flip_d, transpose_on, rot_k) for ``n`` samples, as
    CPU tensors drawn from ``generator`` (a CPU generator)."""
    flip_on = torch.rand(n, generator=generator) < FLIP_P
    flip_d = torch.randint(0, 3, (n,), generator=generator)
    transpose_on = torch.rand(n, generator=generator) < TRANSPOSE_P
    rot_k = torch.randint(0, 4, (n,), generator=generator)
    return flip_on, flip_d, transpose_on, rot_k


def apply_transform(x, flip_on, flip_d, transpose_on, rot_k):
    """One sample's transform on ``x`` (..., H, W): flip (d 0 the rows, 1
    the columns, 2 both), transpose, rot90 by k (from H towards W, as
    ``jnp.rot90``)."""
    if flip_on:
        x = torch.flip(x, ((-2,), (-1,), (-2, -1))[flip_d])
    if transpose_on:
        x = x.transpose(-2, -1)
    return torch.rot90(x, rot_k, (-2, -1))


def augment_batch(generator, images, masks=None):
    """images (N, C, H, W), masks (N, H, W) or None; H == W required.
    Returns the augmented (images, masks)."""
    h, w = images.shape[-2:]
    if h != w:
        raise ValueError(f"device augmentation needs square images, got "
                         f"{h}x{w}")
    # the global batch's draws under data parallelism, this rank's rows
    draws = [rows(t).tolist() for t in draw_transforms(
        generator, images.shape[0] * world_size())]
    img_out, mask_out = [], []
    for i, d in enumerate(zip(*draws)):
        img_out.append(apply_transform(images[i], *d))
        if masks is not None:
            mask_out.append(apply_transform(masks[i], *d))
    return (torch.stack(img_out).contiguous(),
            None if masks is None else torch.stack(mask_out).contiguous())
