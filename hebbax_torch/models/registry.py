"""Network registry (``hebbax/models/registry.py``), the 2D main-path
networks: ``unet``, and ``unet_s2d`` registered on the same UNet2D — its
parameter tree is identical and the space-to-depth fold is a TPU layout,
so the CLIs' default ``-n unet_s2d`` runs the plain UNet2D here.
"""

from typing import Optional

from ..hebb.spec import HebbSpec
from .unet2d import UNet2D

# name -> (factory, metadata)
_REGISTRY = {
    "unet": (UNet2D, dict(nd=2, outputs="single")),
    "unet_s2d": (UNet2D, dict(nd=2, outputs="single")),
}


def available_networks():
    return sorted(_REGISTRY)


def network_meta(name: str) -> dict:
    """Static metadata: nd, output kind, extra rng streams consumed."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown network {name!r}; "
                       f"available: {available_networks()}")
    meta = dict(_REGISTRY[name][1])
    meta.setdefault("rngs", ())
    return meta


def get_network(name: str, in_channels: int, num_classes: int,
                init_type: str = "kaiming", hebb: Optional[HebbSpec] = None,
                device=None, generator=None, dropout_generator=None):
    """Build a model module on ``device``."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown network {name!r}; "
                       f"available: {available_networks()}")
    factory = _REGISTRY[name][0]
    return factory(in_channels=in_channels, n_cls=num_classes,
                   init_type=init_type, hebb=hebb, device=device,
                   generator=generator, dropout_generator=dropout_generator)


def primary_logits(name: str, outputs):
    """The tensor driving metrics and model selection (the first output
    of a multi-output network; every network ported so far has one)."""
    if network_meta(name)["outputs"] == "single":
        return outputs
    return outputs[0]
