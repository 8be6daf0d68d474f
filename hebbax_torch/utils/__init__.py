"""Seeding, run directories, logging sinks, PNG writer and snapshots."""
