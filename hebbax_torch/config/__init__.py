"""Dataset constants and learning-rate schedules."""
