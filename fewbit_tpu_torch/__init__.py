"""PyTorch + CUDA port of fewbit_tpu for NVIDIA Hopper.

Few-bit activation residuals and sketched weight gradients for
memory-efficient training, held against the JAX package ``fewbit_tpu``:

* **few-bit activations** (:mod:`fewbit_tpu_torch.functional`, the
  modules): an ``autograd.Function`` per activation whose backward keeps
  ``bits``-bit packed interval codes;
* **randomized linear layers**: ``x @ W^T + b`` whose backward keeps a
  sketch of the input along the batch axis;
* **the offline quantizer** (:func:`approximate`, :func:`dp_quantize`) and
  its CLI (``fewbit-tpu-torch quantize``);
* **model surgery, residual accounting and class-level patching**
  (:mod:`fewbit_tpu_torch.util`, :mod:`fewbit_tpu_torch.patch`) and
  gradient-variance estimation (:class:`VarianceEstimator`);
* **data and tensor parallelism** (:mod:`fewbit_tpu_torch.parallel`):
  ``DistributedDataParallel`` over a dp group, Megatron's column- and
  row-parallel layers over a tp group, on ``torch.distributed``.

This package imports torch and numpy, never JAX.  Importing it builds and
loads nothing: the CUDA kernels build at their first launch
(:mod:`fewbit_tpu_torch.ops._build`), the host codec at its first call
(:mod:`fewbit_tpu_torch.native`).
"""

__version__ = "0.1.0"

from fewbit_tpu_torch import functional, parallel  # noqa: E402,F401
from fewbit_tpu_torch.approx import (Stepwise, approximate,  # noqa: E402,F401
                                     dp_quantize)
from fewbit_tpu_torch.lut import StepwiseStore, store  # noqa: E402,F401
from fewbit_tpu_torch.modules import *  # noqa: E402,F401,F403
from fewbit_tpu_torch.util import (  # noqa: E402,F401
    convert_linear, device_memory_stats, estimate_memory_usage, map_module,
    memory_delta_bytes, peak_memory_bytes, profile_trace, residual_shapes)
from fewbit_tpu_torch.patch import (use_fewbit_activation,  # noqa: E402,F401
                                    use_fewbit_dense)
