"""Model zoo: UNet2D, UNetURPC2D, UNetCCT2D and their folded forms
(``models.unet2d_s2d``), the unsupervised baselines (UNetVAE2D,
UNetSuperpix2D, DDPMUNet), the 3D family (UNet3D, UNet3DDTC, UNet3DCCT,
UNet3DURPC, UNet3DVAE, UNet3DSuperpix; hebbax's folded names:
``models.unet3d_s2d``, run unfolded, and ``models.urpc3d_s2d``), the
VNet family (VNet, VNetCCT, VNetDTC; folded: ``models.vnet_s2d``), the
spiking VGG9 (SNNVGG, ANNVGG), the RAD-DINO
encoder and decoder (``models.raddino``) and the network registry."""

from .registry import (available_networks, get_network, network_meta,
                       primary_logits)
from .ddpm import DDPMUNet
from .unet2d import (UNet2D, UNetCCT2D, UNetSuperpix2D, UNetURPC2D,
                     UNetVAE2D)
from .snn import ANNVGG, SNNVGG
from .unet3d import (UNet3D, UNet3DCCT, UNet3DDTC, UNet3DSuperpix,
                     UNet3DVAE)
from .urpc3d import UNet3DURPC
from .vnet import VNet, VNetCCT, VNetDTC

__all__ = ["available_networks", "get_network", "network_meta",
           "primary_logits", "DDPMUNet", "UNet2D", "UNetCCT2D",
           "UNetSuperpix2D", "UNetURPC2D", "UNetVAE2D", "UNet3D", "UNet3DCCT",
           "UNet3DDTC", "UNet3DURPC", "UNet3DSuperpix", "UNet3DVAE",
           "VNet", "VNetCCT", "VNetDTC", "ANNVGG", "SNNVGG"]
