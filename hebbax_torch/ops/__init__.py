"""Losses, threshold-sweep metrics, HD95/ASSD and dropout."""
