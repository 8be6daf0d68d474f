"""Model zoo: UNet2D, UNetURPC2D, UNetCCT2D and the network registry."""

from .registry import (available_networks, get_network, network_meta,
                       primary_logits)
from .unet2d import UNet2D, UNetCCT2D, UNetURPC2D

__all__ = ["available_networks", "get_network", "network_meta",
           "primary_logits", "UNet2D", "UNetCCT2D", "UNetURPC2D"]
