"""Train state (``hebbax/engine/state.py``).

hebbax keeps params, batch stats and optimizer state in one immutable
pytree; here the model and optimizer hold them and are updated in place,
and the state bundles them with the learning-rate schedule and the
optimizer step count that the schedule reads.
"""

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0

    def state_dict(self):
        """The model's parameters and BN statistics."""
        return self.model.state_dict()
