"""Hebbian plasticity: spec, the rules (swta, hpca, swta_t, hpca_t,
contrastive), the SWTA-delta dispatcher and its CUDA kernel, HConv /
HConvTranspose and gradient merging."""

from .spec import HebbSpec, default_hebb_params, is_excluded
from .rules import (compute_delta, contrastive_delta, hpca_conv_delta,
                    hpca_t_delta, normalize, swta_conv_delta,
                    swta_t_delta, swta_wgrad_delta)
from .kernels import SWTA_DELTA, swta_delta
from .layers import (HConv, HConvTranspose, set_hebb_generator,
                     transposed_paths)
from .surgery import (merge_hebbian_grads, pop_deltas,
                      pretrain_trainable_names)

__all__ = [
    "HebbSpec", "default_hebb_params", "is_excluded", "compute_delta",
    "contrastive_delta", "hpca_conv_delta", "hpca_t_delta", "normalize",
    "swta_conv_delta", "swta_t_delta", "swta_wgrad_delta", "SWTA_DELTA",
    "swta_delta", "HConv", "HConvTranspose", "set_hebb_generator",
    "transposed_paths", "merge_hebbian_grads", "pop_deltas",
    "pretrain_trainable_names",
]
