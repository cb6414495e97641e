"""Linear layer with a sketched weight gradient, as ``RandomizedDense`` in
``fewbit_tpu/modules/linear.py``: a drop-in for ``nn.Linear`` whose
backward keeps a countsketch of the input instead of the input.

Randomness: each forward draws fresh signs from the ``generator`` it is
given (fresh per training step); without one it falls back to a constant
seed with a warning (see :mod:`fewbit_tpu_torch.modules._rng`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from fewbit_tpu_torch.functional.linear import linear_grp_native
from fewbit_tpu_torch.modules._rng import (draw_signs, lecun_normal_,
                                           sketch_generator)

__all__ = ("RandomizedDense",)


class RandomizedDense(nn.Module):
    """``nn.Linear``-style layer (``weight`` is ``(out, in)``) whose weight
    gradient uses a randomized sketch.

    :param proj_dim_ratio: sketch size as a fraction of the flattened batch.
    :param proj_dim: exact sketch size (overrides the ratio).
    :param proj_dim_min: lower clamp on the sketch size.
    :param proj_dim_max: upper clamp on the sketch size.
    :param matmul: sketch kind; this port has ``'countsketch'``.
    :param dtype: compute dtype (parameters stay f32); None follows ``x``.
    """

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, proj_dim_ratio: Optional[float] = None,
                 proj_dim: Optional[int] = None,
                 proj_dim_min: Optional[int] = None,
                 proj_dim_max: Optional[int] = None,
                 matmul: str = "countsketch", dtype=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.proj_dim_ratio, self.proj_dim = proj_dim_ratio, proj_dim
        self.proj_dim_min, self.proj_dim_max = proj_dim_min, proj_dim_max
        self.matmul = matmul
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               device=device))
        lecun_normal_(self.weight, in_features, generator)
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dtype = self.dtype or x.dtype
        x = x.to(dtype)
        kernel = self.weight.to(dtype).t()
        bias = self.bias.to(dtype) if self.bias is not None else None
        n = x.numel() // x.shape[-1]
        sigma = draw_signs(sketch_generator(self, generator, x.device), n,
                           x.device)
        return linear_grp_native(x, kernel, bias, sigma,
                                 proj_dim_ratio=self.proj_dim_ratio,
                                 proj_dim=self.proj_dim,
                                 proj_dim_max=self.proj_dim_max,
                                 proj_dim_min=self.proj_dim_min,
                                 matmul=self.matmul)

