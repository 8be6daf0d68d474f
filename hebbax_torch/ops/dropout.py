"""Elementwise dropout driven by a caller's ``torch.Generator``
(``hebbax/ops/dropout.py`` ``FastDropout``).

Same semantics as ``nn.Dropout`` (keep with probability 1-p, scale kept
values by 1/(1-p), identity in eval mode), but the mask is drawn from the
generator the model was built with, so a run's masks follow its seed.  The
mask stream differs from hebbax's by design: parity tests run with p=0.  A
recomputed checkpoint region replays the mask of its first run
(:mod:`hebbax_torch.utils.remat`).
"""

import torch
import torch.nn as nn

from ..parallel import draw_rows
from ..utils.remat import stash


class Dropout(nn.Module):
    def __init__(self, p: float, generator=None):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout probability {p} not in [0, 1)")
        self.p = p
        self.generator = generator

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        # the global batch's mask under data parallelism, this rank's rows;
        # a recomputed forward reuses its first run's mask
        keep = stash(lambda: draw_rows(lambda shape: torch.empty(
            shape, dtype=x.dtype, device=x.device).bernoulli_(
            1.0 - self.p, generator=self.generator), x.shape))
        return x * keep * (1.0 / (1.0 - self.p))

    def extra_repr(self):
        return f"p={self.p}"
