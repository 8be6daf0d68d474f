"""Hebbian plasticity: spec, the swta and swta_t rules, the SWTA-delta
dispatcher and its CUDA kernel, HConv / HConvTranspose and gradient
merging."""

from .spec import HebbSpec, default_hebb_params, is_excluded
from .rules import (normalize, swta_conv3d_delta, swta_conv_delta,
                    swta_t_delta)
from .kernels import SWTA_DELTA, swta_delta
from .layers import HConv, HConvTranspose, transposed_paths
from .surgery import (merge_hebbian_grads, pop_deltas,
                      pretrain_trainable_names)

__all__ = [
    "HebbSpec", "default_hebb_params", "is_excluded", "normalize",
    "swta_conv_delta", "swta_conv3d_delta", "swta_t_delta", "SWTA_DELTA",
    "swta_delta", "HConv", "HConvTranspose", "transposed_paths",
    "merge_hebbian_grads", "pop_deltas", "pretrain_trainable_names",
]
