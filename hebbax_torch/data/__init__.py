"""Data pipelines: host-side numpy loading and augmentation, 2D image
folders and 3D NRRD patch queues."""

from .dataset2d import SegDataset2D, regime_split
from .loader import Loader, collate
from .volumes3d import PatchQueue, VolumeDataset3D, sample_patch

__all__ = ["SegDataset2D", "regime_split", "Loader", "collate",
           "PatchQueue", "VolumeDataset3D", "sample_patch"]
