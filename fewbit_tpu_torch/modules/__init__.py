"""``nn.Module``s of the few-bit training path."""

# Piecewise activation modules.
from fewbit_tpu_torch.modules.activations import (  # noqa: F401
    Hardshrink, Hardsigmoid, Hardtanh, LeakyReLU, ReLU, ReLU6, Softshrink,
    Stepwise, Threshold)

# Continuous activation modules.
from fewbit_tpu_torch.modules.activations import (  # noqa: F401
    CELU, ELU, GELU, Hardswish, LogSigmoid, Mish, SELU, Sigmoid, SiLU,
    Softplus, Softsign, Tanh, Tanhshrink)

from fewbit_tpu_torch.modules.ffn import FewBitFFN
from fewbit_tpu_torch.modules.fused import FusedDenseActivation
from fewbit_tpu_torch.modules.linear import (DenseCRS, LinearCRS, LinearGRP,
                                             RandomizedDense,
                                             RandomizedLinear)
from fewbit_tpu_torch.modules.variance import (VarianceEstimator,
                                               VarianceEstimatorState)

__all__ = ("Hardshrink", "Hardsigmoid", "Hardtanh", "LeakyReLU", "ReLU",
           "ReLU6", "Softshrink", "Stepwise", "Threshold", "CELU", "ELU",
           "GELU", "Hardswish", "LogSigmoid", "Mish", "SELU", "Sigmoid",
           "SiLU", "Softplus", "Softsign", "Tanh", "Tanhshrink", "FewBitFFN",
           "FusedDenseActivation", "RandomizedDense", "LinearGRP",
           "RandomizedLinear", "DenseCRS", "LinearCRS",
           "VarianceEstimator", "VarianceEstimatorState")
