"""Few-bit activation pieces: the activation spec, the interval codes and
the LUT select, as in ``fewbit_tpu/ops/activations.py``.

The generic few-bit ``autograd.Function`` (``fewbit_activation``) waits for
the elementwise kernels (see ROADMAP); the fused FFN block uses the pieces
here directly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

__all__ = ("ActivationSpec", "compare_codes", "apply_lut")


@dataclasses.dataclass(frozen=True)
class ActivationSpec:
    """Static description of one few-bit activation.

    ``fwd(x, args)`` computes the exact activation.  ``codes(x, borders,
    args)`` returns the per-element interval code; for the continuous
    family it counts the interior borders below ``x``.  ``n_borders`` is
    the length of ``borders`` (``len(levels) - 1``).
    """

    name: str
    bits: int
    fwd: Callable[[torch.Tensor, tuple], torch.Tensor]
    codes: Callable[[torch.Tensor, torch.Tensor, tuple], torch.Tensor]
    args: tuple = ()
    n_borders: int = 0


def compare_codes(x: torch.Tensor, borders: torch.Tensor,
                  args: tuple) -> torch.Tensor:
    """Interval code = number of interior borders strictly below ``x``,
    compared in f32 (int32 result)."""
    xf = x.float()
    acc = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for k in range(borders.shape[0]):
        acc += (xf > borders[k]).to(torch.int32)
    return acc


def apply_lut(codes: torch.Tensor, levels: torch.Tensor,
              bits: int) -> torch.Tensor:
    """``levels[codes]`` as a balanced select tree: one mask per code bit,
    ``2**bits - 1`` selects, no gather."""
    vals = [levels[k] for k in range(1 << bits)]
    for b in range(bits):
        mask = ((codes >> b) & 1).bool()
        vals = [torch.where(mask, vals[2 * k + 1], vals[2 * k])
                for k in range(len(vals) // 2)]
    return vals[0]
