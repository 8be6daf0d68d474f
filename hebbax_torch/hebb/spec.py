"""Hebbian configuration and layer-exclusion predicate: a copy of
``hebbax/hebb/spec.py``.

Every conv site of a model is an :class:`hebbax_torch.hebb.layers.HConv`
that consults a static :class:`HebbSpec`; ``exclude`` is a predicate over
the module path (``encoder.in_conv.conv1`` split at the dots), and
"freezing" is which parameters the optimizer is given
(:func:`hebbax_torch.hebb.surgery.pretrain_trainable_names`).  One model
definition serves plain and Hebbian variants with identical parameters.
"""

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class HebbSpec:
    """Global Hebbian hyper-parameters (uniform across converted layers,
    as in the reference's single ``hebb_params`` dict).

    mode: 'swta' | 'hpca' | 'swta_t' | 'hpca_t' | 'contrastive'.
      Forward convs automatically strip the ``_t`` suffix
      (makehebbian.adjust_hebbian_params, makehebbian.py:25-30).
    k: softmax inverse temperature for swta-type rules.
    alpha: 1 -> pure Hebbian updates (pretraining), 0 -> pure backprop
      (fine-tuning; Hebbian layers then only keep weight-norm forward).
    patchwise: per-patch updates aggregated; the reference's
      non-patchwise branch is shape-inconsistent dead code and is not
      supported.
    exclude: module names (dotted paths) kept as plain trainable convs,
      e.g. ('out_conv',) — matched as ancestors, like the reference's
      named_modules equality match.
    """

    mode: str = "swta_t"
    k: float = 50.0
    w_nrm: bool = True
    alpha: float = 1.0
    patchwise: bool = True
    contrast: float = 1.0
    uniformity: bool = False
    exclude: Tuple[str, ...] = ()

    def conv_mode(self, transpose: bool) -> str:
        """Effective rule for a layer: forward convs use the non-_t rule."""
        if not transpose and self.mode.endswith("_t"):
            return self.mode[:-2]
        return self.mode

    def to_dict(self):
        d = dataclasses.asdict(self)
        d.pop("exclude")
        return d

    @classmethod
    def from_dict(cls, d, exclude=()):
        d = dict(d)
        d.pop("act", None)  # reference stores an nn.Identity here
        return cls(exclude=tuple(exclude or ()), **d)


# makehebbian.default_hebb_params parity (makehebbian.py:7)
default_hebb_params = HebbSpec()


def is_excluded(path, exclude) -> bool:
    """True if any dotted ancestor prefix of ``path`` equals an exclude
    name (reference excludes a named module and all its submodules)."""
    if not exclude:
        return False
    parts = tuple(str(p) for p in path)
    for i in range(1, len(parts) + 1):
        if ".".join(parts[:i]) in exclude:
            return True
    return False


def spec_if_active(hebb: Optional[HebbSpec], path) -> Optional[HebbSpec]:
    """The spec if this layer is converted, else None."""
    if hebb is None:
        return None
    if is_excluded(path, hebb.exclude):
        return None
    return hebb
