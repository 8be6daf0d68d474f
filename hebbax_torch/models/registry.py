"""Network registry (``hebbax/models/registry.py``), the 2D networks
ported so far: ``unet``, ``unet_urpc``, ``unet_cct`` and the unsupervised
baselines ``unet_vae``, ``unet_superpix`` and ``unet_ddpm``.  The folded
``*_s2d`` names are registered on the same classes: their parameter trees
are identical and the space-to-depth fold is a TPU layout, so the CLIs'
default ``-n unet_s2d`` (``unet_urpc_s2d``, ``unet_cct_s2d``) runs the
unfolded network here; the baselines have no folded name in hebbax
either.  ``unet_cct_s2d_batched`` (one 4N-batched decode, other training
BN numerics) is not registered.
"""

from typing import Optional

from ..hebb.spec import HebbSpec
from .ddpm import DDPMUNet
from .unet2d import (UNet2D, UNetCCT2D, UNetSuperpix2D, UNetURPC2D,
                     UNetVAE2D)

_DEEP4 = dict(nd=2, outputs="deep4")
_CCT = dict(nd=2, outputs="deep4", rngs=("perturb",))

# name -> (factory, metadata)
_REGISTRY = {
    "unet": (UNet2D, dict(nd=2, outputs="single")),
    "unet_s2d": (UNet2D, dict(nd=2, outputs="single")),
    "unet_urpc": (UNetURPC2D, _DEEP4),
    "unet_urpc_s2d": (UNetURPC2D, _DEEP4),
    "unet_cct": (UNetCCT2D, _CCT),
    "unet_cct_s2d": (UNetCCT2D, _CCT),
    "unet_vae": (UNetVAE2D, dict(nd=2, outputs="vae", rngs=("latent",))),
    "unet_superpix": (UNetSuperpix2D, dict(nd=2, outputs="superpix")),
    "unet_ddpm": (DDPMUNet, dict(nd=2, outputs="ddpm")),
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
                device=None, generator=None, dropout_generator=None,
                perturb_generator=None, latent_generator=None):
    """Build a model module on ``device``; ``perturb_generator`` goes to
    the networks that draw perturbations (the ``perturb`` rng),
    ``latent_generator`` to those that draw a latent (``latent``)."""
    meta = network_meta(name)
    kw = {}
    if "perturb" in meta["rngs"]:
        kw["perturb_generator"] = perturb_generator
    if "latent" in meta["rngs"]:
        kw["latent_generator"] = latent_generator
    factory = _REGISTRY[name][0]
    return factory(in_channels=in_channels, n_cls=num_classes,
                   init_type=init_type, hebb=hebb, device=device,
                   generator=generator, dropout_generator=dropout_generator,
                   **kw)


def primary_logits(name: str, outputs):
    """The tensor driving metrics and model selection: the output of a
    single-output network and DDPMUNet's probe logits (its diffusion
    paths are called explicitly), the VAE's ``output``, the first (finest /
    clean / segmentation) of a tuple."""
    kind = network_meta(name)["outputs"]
    if kind in ("single", "ddpm"):
        return outputs
    if kind == "vae":
        return outputs["output"]
    return outputs[0]
