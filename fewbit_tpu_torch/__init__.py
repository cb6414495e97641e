"""PyTorch + CUDA port of fewbit_tpu for NVIDIA Hopper.

Few-bit activation residuals and countsketched weight gradients for
memory-efficient training, held against the JAX package ``fewbit_tpu``.
This package imports torch and numpy, never JAX.  The CUDA kernels build
at their first launch (:mod:`fewbit_tpu_torch.ops._build`).
"""

__version__ = "0.1.0"
