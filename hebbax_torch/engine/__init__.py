"""Train state, train/eval steps and the epoch harness."""
