"""Determinism discipline (``hebbax/utils/seeding.py``).

Python's and numpy's global generators are seeded for the host pipeline;
model initialisation and dropout take explicit ``torch.Generator``s built
from the same seed, so nothing depends on torch's global generator.
"""

import os
import random

import numpy as np
import torch


def init_seeds(seed):
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(0)


def make_generator(seed, device="cpu"):
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g
