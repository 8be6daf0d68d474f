"""2D data pipeline: host-side numpy loading and augmentation."""

from .dataset2d import SegDataset2D, regime_split
from .loader import Loader, collate

__all__ = ["SegDataset2D", "regime_split", "Loader", "collate"]
