"""Model zoo: UNet2D, UNetURPC2D, UNetCCT2D, the unsupervised baselines
(UNetVAE2D, UNetSuperpix2D, DDPMUNet), the 3D family (UNet3D, UNet3DDTC,
UNet3DCCT, UNet3DURPC, UNet3DVAE, UNet3DSuperpix), the VNet family
(VNet, VNetCCT, VNetDTC), the spiking VGG9 (SNNVGG, ANNVGG), the
RAD-DINO encoder and decoder (``models.raddino``) and the network
registry."""

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
