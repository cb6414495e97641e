"""Few-bit activation engine: the activation spec, the interval codes, the
LUT select and the generic few-bit ``autograd.Function``, as in
``fewbit_tpu/ops/activations.py``.

:func:`fewbit_activation` computes the exact activation and keeps only the
packed interval codes (``bits / 8`` bytes per element) for its backward,
``dx = levels[code] * g``.  On a CUDA tensor inside the envelope
(:func:`fewbit_tpu_torch.ops.kernels.act_kernel_ok`) forward and backward
run kernels 4 and 5; elsewhere their plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

__all__ = ("ActivationSpec", "compare_codes", "apply_lut",
           "fewbit_activation")


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


def _rows(t: torch.Tensor) -> torch.Tensor:
    """The ``(R, C)`` view the kernels take: leading dims collapsed (a 0-D
    or 1-D tensor becomes one column)."""
    if t.ndim < 2:
        return t.reshape(-1, 1)
    return t.reshape(-1, t.shape[-1])


class _FewBitActivation(torch.autograd.Function):
    """Exact ``spec.fwd(x)``; the backward keeps ``(packed codes,
    levels)``, never ``x``."""

    @staticmethod
    def forward(ctx, spec: ActivationSpec, x, borders, levels):
        from fewbit_tpu_torch.ops import kernels as K

        x2 = _rows(x)
        fwd = (K.fused_forward if K.act_kernel_ok(spec, x2.shape[1], x.dtype)
               else K.act_forward_plain)
        y2, packed = fwd(spec, x2.contiguous(), borders)
        ctx.spec = spec
        ctx.save_for_backward(packed, levels)
        return y2.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        from fewbit_tpu_torch.ops import kernels as K

        spec = ctx.spec
        packed, levels = ctx.saved_tensors
        g2 = _rows(g)
        bwd = (K.fused_backward if K.act_kernel_ok(spec, g2.shape[1], g.dtype)
               else K.act_backward_plain)
        dx = bwd(spec, packed, levels, g2.contiguous())
        return None, dx.reshape(g.shape), None, None


def fewbit_activation(spec: ActivationSpec, x: torch.Tensor,
                      borders: torch.Tensor,
                      levels: torch.Tensor) -> torch.Tensor:
    """Exact forward of ``spec`` with a few-bit backward pass.

    ``borders``: f32 interior borders, shape ``(spec.n_borders,)``;
    ``levels``: f32 stepwise derivative values (``levels[k]`` multiplies
    cotangents whose input fell in interval ``k``), ``2**bits`` of them.
    Both on ``x``'s device.
    """
    return _FewBitActivation.apply(spec, x, borders, levels)
