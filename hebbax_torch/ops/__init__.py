"""Losses, threshold-sweep and confusion metrics, HD95/ASSD, dropout and
the single-level wavelet transforms."""

from .wavelets import dwt2, dwtn3

__all__ = ["dwt2", "dwtn3"]
