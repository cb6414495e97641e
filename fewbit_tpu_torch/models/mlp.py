"""A configurable MLP with the few-bit switches of ``RobertaConfig``, as
``fewbit_tpu/models/mlp.py``: the smallest model of the few-bit path.

Each layer is an exact ``Dense`` or, with ``proj_dim_ratio``, a
``RandomizedDense`` of its default sketch kind (gaussian); between layers
runs the few-bit ``gelu`` with ``gelu_bits`` (kernels 4 and 5 on the card),
else the exact GELU.  flax infers the input width at ``init``; a torch
module needs it when it is built, so ``in_features`` is asked for.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as TF
from torch import nn

from fewbit_tpu_torch.functional.activations import gelu as fewbit_gelu
from fewbit_tpu_torch.models.roberta import _dense_pairs, model_device
from fewbit_tpu_torch.modules.linear import Dense, RandomizedDense

__all__ = ("MLP",)


class MLP(nn.Module):
    """``features[-1]``-way MLP.

    :param features: output width of each layer.
    :param gelu_bits: few-bit GELU backward (None = exact).
    :param proj_dim_ratio: ``RandomizedDense`` sketch ratio (None = exact
        ``Dense``).
    :param dtype: compute dtype (parameters stay f32).
    :param device: None builds on the card (``model_device``).
    :param in_features: width of the input.
    """

    def __init__(self, features: Sequence[int],
                 gelu_bits: Optional[int] = None,
                 proj_dim_ratio: Optional[float] = None,
                 dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None, *,
                 in_features: int):
        super().__init__()
        device = model_device(device)
        self.gelu_bits, self.proj_dim_ratio = gelu_bits, proj_dim_ratio
        widths = (in_features, *features)
        self.dense = nn.ModuleList(
            RandomizedDense(fin, fout, proj_dim_ratio=proj_dim_ratio,
                            dtype=dtype, device=device, generator=generator)
            if proj_dim_ratio else
            Dense(fin, fout, dtype, device=device, generator=generator)
            for fin, fout in zip(widths[:-1], widths[1:]))

    def forward(self, x: torch.Tensor,
                sketch_generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        for i, layer in enumerate(self.dense):
            x = layer(x, sketch_generator)
            if i + 1 < len(self.dense):
                x = (fewbit_gelu(x, bits=self.gelu_bits) if self.gelu_bits
                     else TF.gelu(x, approximate="none"))
        return x

    def flax_param_pairs(self, p, tp=(0, 1)):
        for i, layer in enumerate(self.dense):
            yield from _dense_pairs(layer, p[f"dense_{i}"], f"dense_{i}", tp)
