"""The space-to-depth 3D UNet names (``hebbax/models/unet3d_s2d.py``),
NCDHW: ``unet3d_s2d``, ``unet3d_dtc_s2d`` and ``unet3d_cct_s2d`` with its
``_batched`` / ``_rc`` variants, and :class:`FoldedBatchNorm3`, which
:mod:`.vnet_s2d` folds with.

hebbax folds these networks' full-resolution level at (2, 1, 1), the
depth axis into the channels, to fill the TPU's 128 lanes; the math, the
parameter tree and the snapshots are those of :mod:`.unet3d`.  The port
runs them unfolded, as their twins :class:`~.unet3d.UNet3D`,
:class:`~.unet3d.UNet3DDTC` and :class:`~.unet3d.UNet3DCCT`, on every
device: on a card the fold only adds work, since a 3x3x3 conv folded at
(2, 1, 1) runs 27 taps over 2Ci x 2Co channels on half the voxels, twice
the unfolded conv's FLOPs with half of them on zero taps.  The classes
keep hebbax's names, so the registry, snapshots and tests name the same
networks; the tests hold them against hebbax's folded classes.
"""

from ..ops import s2d3d
from .common import BatchNorm3d
from .unet3d import UNet3D, UNet3DCCT, UNet3DDTC


class FoldedBatchNorm3(BatchNorm3d):
    """:class:`BatchNorm3d` on a folded 3D tensor (N, pf·C, *s):
    statistics per ORIGINAL channel over the batch, the voxels and the
    ``pf`` subpixel blocks, parameters and statistics (C,).  ``groups``:
    the input is in grouped-concat order (a folded concat, or a
    FoldedHConv3 with ``out_groups``), and so is the output; the
    parameters stay in original (group-major) channel order."""

    def __init__(self, features: int, pf: int, groups=None, device=None):
        super().__init__(features, device=device)
        self.pf = pf
        self.groups = None if groups is None else tuple(groups)

    def forward(self, x):
        f = (self.pf, 1, 1)
        if self.groups is not None:
            x = s2d3d.regroup3(x, self.groups, f)
        n, sp = x.shape[0], tuple(x.shape[2:])
        c = x.shape[1] // self.pf
        y = super().forward(x.reshape((n * self.pf, c) + sp)).reshape(
            x.shape)
        if self.groups is not None:
            y = s2d3d.ungroup3(y, self.groups, f)
        return y


class UNet3DS2D(UNet3D):
    """``unet3d_s2d``: :class:`~.unet3d.UNet3D` (module docstring)."""


class UNet3DDTCS2D(UNet3DDTC):
    """``unet3d_dtc_s2d``: :class:`~.unet3d.UNet3DDTC` (module
    docstring); returns (sdf, seg)."""


class UNet3DCCTS2D(UNet3DCCT):
    """``unet3d_cct_s2d``: :class:`~.unet3d.UNet3DCCT` (module docstring).
    ``batched_aux`` and ``remat`` / ``remat_policy`` are the ``_batched``
    and ``_rc`` names'; the plain name recomputes nothing.  Returns (main,
    aux1, aux2, aux3)."""
