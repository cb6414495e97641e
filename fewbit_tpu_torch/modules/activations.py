"""Module wrappers of the few-bit activations, as
``fewbit_tpu/modules/activations.py``.  The port has the exact GELU; the
other modules wait for ROADMAP queue 1 item 7."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from fewbit_tpu_torch.functional.activations import gelu

__all__ = ("GELU",)


class GELU(nn.Module):
    """Exact GELU with a few-bit backward: ``bits`` (default 3) selects a
    builtin LUT, or ``borders`` + ``values`` give a custom one."""

    def __init__(self, bits: Optional[int] = None, borders=None,
                 values=None):
        super().__init__()
        self.bits, self.borders, self.values = bits, borders, values

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu(x, bits=self.bits, borders=self.borders,
                    values=self.values)
