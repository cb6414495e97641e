"""Functional few-bit ops on tensors."""

from fewbit_tpu_torch.functional.activations import gelu, resolve_activation
from fewbit_tpu_torch.functional.ffn import fewbit_ffn
from fewbit_tpu_torch.functional.fused import fewbit_dense_act
from fewbit_tpu_torch.functional.linear import (calc_proj_dim, linear,
                                                linear_crs, linear_grp,
                                                linear_grp_native,
                                                linear_randomized)

__all__ = ("gelu", "resolve_activation", "fewbit_ffn", "fewbit_dense_act",
           "calc_proj_dim", "linear", "linear_crs", "linear_grp",
           "linear_grp_native", "linear_randomized")
