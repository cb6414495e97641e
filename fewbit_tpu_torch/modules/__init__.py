"""``nn.Module``s of the few-bit training path."""

from fewbit_tpu_torch.modules.activations import GELU
from fewbit_tpu_torch.modules.ffn import FewBitFFN
from fewbit_tpu_torch.modules.fused import FusedDenseActivation
from fewbit_tpu_torch.modules.linear import (DenseCRS, LinearCRS, LinearGRP,
                                             RandomizedDense,
                                             RandomizedLinear)

__all__ = ("GELU", "FewBitFFN", "FusedDenseActivation", "RandomizedDense",
           "LinearGRP", "RandomizedLinear", "DenseCRS", "LinearCRS")
