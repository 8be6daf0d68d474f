"""Hebbian plasticity: spec, the swta rule, its CUDA kernel dispatcher,
HConv and gradient merging."""

from .spec import HebbSpec, default_hebb_params, is_excluded
from .rules import normalize, swta_conv_delta
from .kernels import SWTA_DELTA, swta_delta
from .layers import HConv
from .surgery import (merge_hebbian_grads, pop_deltas,
                      pretrain_trainable_names)

__all__ = [
    "HebbSpec", "default_hebb_params", "is_excluded", "normalize",
    "swta_conv_delta", "SWTA_DELTA", "swta_delta", "HConv",
    "merge_hebbian_grads", "pop_deltas", "pretrain_trainable_names",
]
