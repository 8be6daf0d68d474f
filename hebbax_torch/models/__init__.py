"""Model zoo: UNet2D, UNetURPC2D, UNetCCT2D, the unsupervised baselines
(UNetVAE2D, UNetSuperpix2D, DDPMUNet) and the network registry."""

from .registry import (available_networks, get_network, network_meta,
                       primary_logits)
from .ddpm import DDPMUNet
from .unet2d import (UNet2D, UNetCCT2D, UNetSuperpix2D, UNetURPC2D,
                     UNetVAE2D)

__all__ = ["available_networks", "get_network", "network_meta",
           "primary_logits", "DDPMUNet", "UNet2D", "UNetCCT2D",
           "UNetSuperpix2D", "UNetURPC2D", "UNetVAE2D"]
