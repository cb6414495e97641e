"""Functional few-bit ops on tensors."""

from fewbit_tpu_torch.functional.activations import resolve_activation
from fewbit_tpu_torch.functional.ffn import fewbit_ffn
from fewbit_tpu_torch.functional.linear import (calc_proj_dim,
                                                linear_grp_native)

__all__ = ("resolve_activation", "fewbit_ffn", "calc_proj_dim",
           "linear_grp_native")
