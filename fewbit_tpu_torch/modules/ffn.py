"""Module for the fully fused few-bit FFN block, as ``FewBitFFN`` in
``fewbit_tpu/modules/ffn.py``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from fewbit_tpu_torch.functional.ffn import fewbit_ffn
from fewbit_tpu_torch.modules._rng import (draw_signs, lecun_normal_,
                                           sketch_generator)

__all__ = ("FewBitFFN",)


class FewBitFFN(nn.Module):
    """``act(x @ up + b_up) @ down + b_down`` with few-bit activation
    residuals and countsketched weight gradients for both projections
    (kernel 2 forward, kernel 3 backward on the card).

    Parameters, in torch orientation: ``up_weight`` ``(inner, in)``,
    ``up_bias``, ``down_weight`` ``(out, inner)``, ``down_bias``.
    """

    def __init__(self, in_features: int, inner_features: int,
                 out_features: int, activation: str = "gelu", bits: int = 3,
                 act_args: tuple = (), use_bias: bool = True,
                 use_down_bias: bool = True, dtype=None,
                 proj_dim_ratio: Optional[float] = None,
                 proj_dim: Optional[int] = None,
                 proj_dim_min: Optional[int] = None,
                 proj_dim_max: Optional[int] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.activation, self.bits, self.act_args = activation, bits, act_args
        self.dtype = dtype
        self.proj_dim_ratio, self.proj_dim = proj_dim_ratio, proj_dim
        self.proj_dim_min, self.proj_dim_max = proj_dim_min, proj_dim_max
        self.up_weight = nn.Parameter(torch.empty(inner_features,
                                                  in_features, device=device))
        self.down_weight = nn.Parameter(torch.empty(
            out_features, inner_features, device=device))
        lecun_normal_(self.up_weight, in_features, generator)
        lecun_normal_(self.down_weight, inner_features, generator)
        self.up_bias = (nn.Parameter(torch.zeros(inner_features,
                                                 device=device))
                        if use_bias else None)
        self.down_bias = (nn.Parameter(torch.zeros(out_features,
                                                   device=device))
                          if use_bias and use_down_bias else None)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dtype = self.dtype or x.dtype

        def cast(p):
            return p.to(dtype) if p is not None else None

        x = x.to(dtype)
        n = x.numel() // x.shape[-1]
        gen = sketch_generator(self, generator, x.device)
        sigma_up = draw_signs(gen, n, x.device)
        sigma_down = draw_signs(gen, n, x.device)
        return fewbit_ffn(
            x, cast(self.up_weight).t(), cast(self.up_bias),
            cast(self.down_weight).t(), cast(self.down_bias), sigma_up,
            sigma_down, activation=self.activation, bits=self.bits,
            act_args=self.act_args, proj_dim_ratio=self.proj_dim_ratio,
            proj_dim=self.proj_dim, proj_dim_min=self.proj_dim_min,
            proj_dim_max=self.proj_dim_max)
