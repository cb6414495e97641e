"""Module for the fused dense + few-bit activation, as
``FusedDenseActivation`` in ``fewbit_tpu/modules/fused.py``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from fewbit_tpu_torch.functional.fused import fewbit_dense_act
from fewbit_tpu_torch.modules._rng import lecun_normal_, sketch_generator

__all__ = ("FusedDenseActivation",)


class FusedDenseActivation(nn.Module):
    """``act(x @ weight^T + bias)`` with few-bit residuals in one fused op
    (kernel 6 forward, kernel 5 backward on the card).

    Parameters are named like ``Dense`` (``weight`` ``(out, in)``,
    ``bias``), so swapping a Dense + activation pair for this module keeps
    checkpoints loadable.  With a ``proj_dim*`` setting the weight gradient
    is sketched (``matmul``, any kind of ``RandomizedDense``), its
    projection drawn from the sketch generator.
    """

    def __init__(self, in_features: int, out_features: int,
                 activation: str = "gelu", bits: Optional[int] = None,
                 act_args: tuple = (), bias: bool = True, dtype=None,
                 proj_dim_ratio: Optional[float] = None,
                 proj_dim: Optional[int] = None,
                 proj_dim_min: Optional[int] = None,
                 proj_dim_max: Optional[int] = None,
                 matmul: str = "countsketch", device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activation, self.bits, self.act_args = activation, bits, act_args
        self.dtype = dtype
        self.proj_dim_ratio, self.proj_dim = proj_dim_ratio, proj_dim
        self.proj_dim_min, self.proj_dim_max = proj_dim_min, proj_dim_max
        self.matmul = matmul
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               device=device))
        lecun_normal_(self.weight, in_features, generator)
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if bias else None)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dtype = self.dtype or x.dtype
        x = x.to(dtype)
        bias = self.bias.to(dtype) if self.bias is not None else None
        key = None
        if self.proj_dim_ratio is not None or self.proj_dim is not None:
            key = sketch_generator(self, generator, x.device)
        return fewbit_dense_act(
            x, self.weight.to(dtype).t(), bias, key,
            activation=self.activation, bits=self.bits,
            act_args=self.act_args, proj_dim_ratio=self.proj_dim_ratio,
            proj_dim=self.proj_dim, proj_dim_min=self.proj_dim_min,
            proj_dim_max=self.proj_dim_max, matmul=self.matmul)
