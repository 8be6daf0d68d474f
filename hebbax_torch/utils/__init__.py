"""Seeding, run directories, logging sinks, PNG writer, snapshots, the
replay of a recomputed checkpoint region and step timing."""
