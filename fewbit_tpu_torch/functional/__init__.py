"""Functional few-bit ops on tensors."""

# Piecewise (1-bit) activation functions.
from fewbit_tpu_torch.functional.activations import (  # noqa: F401
    hardshrink, hardsigmoid, hardtanh, leaky_relu, relu, relu6, softshrink,
    stepwise, threshold)

# Continuous (multi-bit) activation functions.
from fewbit_tpu_torch.functional.activations import (  # noqa: F401
    celu, elu, gelu, hardswish, logsigmoid, mish, selu, sigmoid, silu,
    softplus, softsign, tanh, tanhshrink)

from fewbit_tpu_torch.functional.activations import (  # noqa: F401
    resolve_activation, store)
from fewbit_tpu_torch.functional.ffn import fewbit_ffn
from fewbit_tpu_torch.functional.fused import fewbit_dense_act
from fewbit_tpu_torch.functional.linear import (calc_proj_dim, linear,
                                                linear_crs, linear_grp,
                                                linear_grp_native,
                                                linear_randomized)
from fewbit_tpu_torch.functional.variance import (GradientStorage,
                                                  catch_gradients,
                                                  estimate_correlation,
                                                  estimate_variance_rmm,
                                                  estimate_variance_sgd)

__all__ = ("hardshrink", "hardsigmoid", "hardtanh", "leaky_relu", "relu",
           "relu6", "softshrink", "stepwise", "threshold", "celu", "elu",
           "gelu", "hardswish", "logsigmoid", "mish", "selu", "sigmoid",
           "silu", "softplus", "softsign", "tanh", "tanhshrink", "store",
           "resolve_activation", "fewbit_ffn", "fewbit_dense_act",
           "calc_proj_dim", "linear", "linear_crs", "linear_grp",
           "linear_grp_native", "linear_randomized", "GradientStorage",
           "catch_gradients", "estimate_correlation",
           "estimate_variance_sgd", "estimate_variance_rmm")
