"""Network registry (``hebbax/models/registry.py``), the networks ported
so far: in 2D ``unet``, ``unet_urpc``, ``unet_cct`` and the unsupervised
baselines ``unet_vae``, ``unet_superpix`` and ``unet_ddpm``; in 3D
``unet3d``, ``unet3d_dtc``, ``unet3d_cct``, ``unet3d_urpc``,
``unet3d_min`` / ``unet3d_cct_min`` (32 initial features), the
unsupervised baselines ``unet3d_vae`` and ``unet3d_superpix``, and the
VNet family ``vnet``, ``vnet_cct``, ``vnet_dtc``; the spiking VGG9
``snn_vgg`` and its non-spiking twin ``ann_vgg``.  (The
RAD-DINO encoder and decoder are built by their trainer, as in hebbax.)

The folded ``*_s2d`` names are registered on the same classes: their
parameter trees are identical and the space-to-depth fold is a TPU
layout, so the CLIs' defaults (``unet_s2d``, ``unet3d_s2d``,
``unet3d_urpc_s2d``, ``vnet_s2d``, ...) run the unfolded network here;
the baselines have no folded name in hebbax either.
``unet3d_cct_s2d_rc`` and ``vnet_cct_s2d_rc`` are hebbax's remat policy
for the shared decoder, with unchanged grads: they run the plain
``UNet3DCCT`` / ``VNetCCT`` (no recomputation) here.  The ``*_batched``
names (one 4N-batched decode, other training BN numerics) are not
registered.
"""

from typing import Optional

from ..hebb.layers import set_hebb_generator
from ..hebb.spec import HebbSpec
from .ddpm import DDPMUNet
from .unet2d import (UNet2D, UNetCCT2D, UNetSuperpix2D, UNetURPC2D,
                     UNetVAE2D)
from .snn import ANNVGG, SNNVGG
from .unet3d import (UNet3D, UNet3DCCT, UNet3DDTC, UNet3DSuperpix,
                     UNet3DVAE)
from .urpc3d import UNet3DURPC
from .vnet import VNet, VNetCCT, VNetDTC

_DEEP4 = dict(nd=2, outputs="deep4")
_CCT = dict(nd=2, outputs="deep4", rngs=("perturb",))
_DEEP4_3D = dict(nd=3, outputs="deep4")
_CCT_3D = dict(nd=3, outputs="deep4", rngs=("perturb",))
_DTC_3D = dict(nd=3, outputs="dtc")


def _vgg(cls):
    """SNNVGG / ANNVGG from the registry's keywords: no Hebbian conv, and
    xavier init whatever ``init_type`` says (as in hebbax).  ANNVGG takes
    ``dtype``; SNNVGG ignores it, as hebbax's does."""
    def factory(in_channels, n_cls, init_type=None, hebb=None, device=None,
                generator=None, dropout_generator=None, dtype=None, **kw):
        del init_type, dropout_generator
        if hebb is not None:
            raise ValueError(f"{cls.__name__} has no Hebbian conv")
        if cls is ANNVGG:
            kw["dtype"] = dtype
        return cls(in_channels, n_cls, device=device, generator=generator,
                   **kw)
    return factory


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
    "snn_vgg": (_vgg(SNNVGG), dict(nd=2, outputs="single",
                                   rngs=("poisson",))),
    "ann_vgg": (_vgg(ANNVGG), dict(nd=2, outputs="single")),
    "unet3d": (UNet3D, dict(nd=3, outputs="single")),
    "unet3d_s2d": (UNet3D, dict(nd=3, outputs="single")),
    "unet3d_min": (lambda **kw: UNet3D(init_features=32, **kw),
                   dict(nd=3, outputs="single")),
    "unet3d_dtc": (UNet3DDTC, _DTC_3D),
    "unet3d_dtc_s2d": (UNet3DDTC, _DTC_3D),
    "unet3d_cct": (UNet3DCCT, _CCT_3D),
    "unet3d_cct_s2d": (UNet3DCCT, _CCT_3D),
    "unet3d_cct_s2d_rc": (UNet3DCCT, _CCT_3D),
    "unet3d_cct_min": (lambda **kw: UNet3DCCT(init_features=32, **kw),
                       _CCT_3D),
    "unet3d_urpc": (UNet3DURPC, _DEEP4_3D),
    "unet3d_urpc_s2d": (UNet3DURPC, _DEEP4_3D),
    "unet3d_vae": (UNet3DVAE, dict(nd=3, outputs="vae", rngs=("latent",))),
    "unet3d_superpix": (UNet3DSuperpix, dict(nd=3, outputs="superpix")),
    "vnet": (VNet, dict(nd=3, outputs="single")),
    "vnet_s2d": (VNet, dict(nd=3, outputs="single")),
    "vnet_cct": (VNetCCT, _CCT_3D),
    "vnet_cct_s2d": (VNetCCT, _CCT_3D),
    "vnet_cct_s2d_rc": (VNetCCT, _CCT_3D),
    "vnet_dtc": (VNetDTC, _DTC_3D),
    "vnet_dtc_s2d": (VNetDTC, _DTC_3D),
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
                perturb_generator=None, latent_generator=None,
                poisson_generator=None, hebb_generator=None, dtype=None):
    """Build a model module on ``device``; ``perturb_generator`` goes to
    the networks that draw perturbations (the ``perturb`` rng),
    ``latent_generator`` to those that draw a latent (``latent``),
    ``poisson_generator`` to those that draw spikes (``poisson``), and
    ``hebb_generator`` (on the CPU) to every HConv, whose contrastive
    permutations it draws (the ``hebb`` rng).
    ``dtype`` (None: float32) is the compute dtype, flax's ``dtype=``:
    parameters and BN statistics stay float32."""
    meta = network_meta(name)
    streams = {"perturb": perturb_generator, "latent": latent_generator,
               "poisson": poisson_generator}
    kw = {f"{r}_generator": streams[r] for r in meta["rngs"]}
    factory = _REGISTRY[name][0]
    model = factory(in_channels=in_channels, n_cls=num_classes,
                    init_type=init_type, hebb=hebb, device=device,
                    generator=generator, dropout_generator=dropout_generator,
                    dtype=dtype, **kw)
    return set_hebb_generator(model, hebb_generator)


def primary_logits(name: str, outputs):
    """The tensor driving metrics and model selection: the output of a
    single-output network and DDPMUNet's probe logits (its diffusion
    paths are called explicitly), the VAE's ``output``, DTC's
    segmentation (its second output), the first (finest / clean /
    segmentation) of another tuple."""
    kind = network_meta(name)["outputs"]
    if kind in ("single", "ddpm"):
        return outputs
    if kind == "vae":
        return outputs["output"]
    if kind == "dtc":
        return outputs[1]
    return outputs[0]
