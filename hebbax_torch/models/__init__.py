"""Model zoo: UNet2D, UNetURPC2D, UNetCCT2D, the unsupervised baselines
(UNetVAE2D, UNetSuperpix2D, DDPMUNet), the 3D family (UNet3D, UNet3DDTC,
UNet3DCCT, UNet3DURPC) and the network registry."""

from .registry import (available_networks, get_network, network_meta,
                       primary_logits)
from .ddpm import DDPMUNet
from .unet2d import (UNet2D, UNetCCT2D, UNetSuperpix2D, UNetURPC2D,
                     UNetVAE2D)
from .unet3d import UNet3D, UNet3DCCT, UNet3DDTC
from .urpc3d import UNet3DURPC

__all__ = ["available_networks", "get_network", "network_meta",
           "primary_logits", "DDPMUNet", "UNet2D", "UNetCCT2D",
           "UNetSuperpix2D", "UNetURPC2D", "UNetVAE2D", "UNet3D", "UNet3DCCT",
           "UNet3DDTC", "UNet3DURPC"]
