"""Linear layers with sketched weight gradients, as
``fewbit_tpu/modules/linear.py``, and the exact ``Dense`` the models build
where the JAX models build flax's ``nn.Dense``: ``RandomizedDense`` (aliases
``LinearGRP``, ``RandomizedLinear``), a drop-in for ``nn.Linear`` whose
backward keeps a random projection of the input instead of the input, and
``DenseCRS`` (alias ``LinearCRS``), whose backward keeps sampled input
feature columns.

Randomness: each forward draws from the ``generator`` it is given (fresh
per training step); without one it falls back to a constant seed with a
warning (see :mod:`fewbit_tpu_torch.modules._rng`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as TF
from torch import nn

from fewbit_tpu_torch.functional.linear import linear_crs, linear_grp_native
from fewbit_tpu_torch.modules._rng import lecun_normal_, sketch_generator

__all__ = ("Dense", "RandomizedDense", "LinearGRP", "RandomizedLinear",
           "DenseCRS", "LinearCRS")


class Dense(nn.Module):
    """Exact ``x @ weight^T + bias`` in the compute dtype."""

    def __init__(self, in_features: int, out_features: int, dtype,
                 bias: bool = True, device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               device=device))
        lecun_normal_(self.weight, in_features, generator)
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if bias else None)

    def forward(self, x, generator=None):
        dt = self.dtype
        b = self.bias.to(dt) if self.bias is not None else None
        return TF.linear(x.to(dt), self.weight.to(dt), b)


class _SketchedBase(nn.Module):
    """``nn.Linear``-style parameters (``weight`` is ``(out, in)``, f32)
    and the cast to the compute dtype (None follows ``x``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 dtype, device, generator):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               device=device))
        lecun_normal_(self.weight, in_features, generator)
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if bias else None)

    def _params(self, x):
        dtype = self.dtype or x.dtype
        x, weight = x.to(dtype), self.weight.to(dtype)
        bias = self.bias.to(dtype) if self.bias is not None else None
        return x, weight, bias


class RandomizedDense(_SketchedBase):
    """Linear layer whose weight gradient uses a randomized sketch.

    :param proj_dim_ratio: sketch size as a fraction of the flattened batch.
    :param proj_dim: exact sketch size (overrides the ratio).
    :param proj_dim_min: lower clamp on the sketch size.
    :param proj_dim_max: upper clamp on the sketch size.
    :param matmul: ``'gaussian' | 'rademacher' | 'dct' | 'dft' |
        'countsketch' | 'srht'``.
    :param dtype: compute dtype (parameters stay f32); None follows ``x``.
    """

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, proj_dim_ratio: Optional[float] = None,
                 proj_dim: Optional[int] = None,
                 proj_dim_min: Optional[int] = None,
                 proj_dim_max: Optional[int] = None,
                 matmul: str = "gaussian", dtype=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, out_features, bias, dtype, device,
                         generator)
        self.proj_dim_ratio, self.proj_dim = proj_dim_ratio, proj_dim
        self.proj_dim_min, self.proj_dim_max = proj_dim_min, proj_dim_max
        self.matmul = matmul

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x, weight, bias = self._params(x)
        return linear_grp_native(x, weight.t(), bias,
                                 sketch_generator(self, generator, x.device),
                                 proj_dim_ratio=self.proj_dim_ratio,
                                 proj_dim=self.proj_dim,
                                 proj_dim_max=self.proj_dim_max,
                                 proj_dim_min=self.proj_dim_min,
                                 matmul=self.matmul)


class DenseCRS(_SketchedBase):
    """Linear layer whose weight gradient uses column-row sampling of
    ``nopairs`` input columns (default ``max(out_features // 2, 1)``)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, nopairs: Optional[int] = None,
                 dtype=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_features, out_features, bias, dtype, device,
                         generator)
        self.nopairs = nopairs

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x, weight, bias = self._params(x)
        nopairs = self.nopairs or max(self.out_features // 2, 1)
        return linear_crs(x, weight, bias,
                          sketch_generator(self, generator, x.device),
                          nopairs)


LinearGRP = RandomizedDense
RandomizedLinear = RandomizedDense
LinearCRS = DenseCRS
