"""Few-bit activation engine: the activation spec, the interval codes, the
LUT select and the generic few-bit ``autograd.Function``, as in
``fewbit_tpu/ops/activations.py``.

:func:`fewbit_activation` computes the exact activation and keeps only the
packed interval codes (``bits / 8`` bytes per element) for its backward,
``dx = levels[code] * g``.  On a CUDA tensor inside the envelope
(:func:`fewbit_tpu_torch.ops.kernels.act_kernel_ok`) forward and backward
run kernels 4 and 5; elsewhere their plain versions.

A spec carries what a kernel reads, besides its Python closures: the
forward's id (:data:`ACT_IDS`, shared with ``csrc/common.cuh``), the code
kind (``"borders"``, ``"predicate"`` or ``"stepwise"``) and the scalar
arguments, which the kernels take as parameters (:func:`kernel_args`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

__all__ = ("ActivationSpec", "ACT_IDS", "CODE_KINDS", "compare_codes",
           "quantize_codes", "apply_lut", "spec_args", "kernel_args",
           "fewbit_activation")

# Forward ids of the kernels, in csrc/common.cuh's order: GELU, the other
# twelve continuous functions, the eight piecewise ones, and the identity
# forward of the generic ``stepwise``.
ACT_IDS = {name: i for i, name in enumerate((
    "gelu", "celu", "elu", "hardswish", "logsigmoid", "mish", "selu",
    "sigmoid", "silu", "softplus", "softsign", "tanh", "tanhshrink",
    "hardshrink", "hardsigmoid", "hardtanh", "leaky_relu", "relu", "relu6",
    "softshrink", "threshold", "stepwise"))}
# How a kernel computes the code of z: count the borders below it; a
# piecewise function's 1-bit predicate; stepwise's recentred count.
CODE_KINDS = {"borders": 0, "predicate": 1, "stepwise": 2}


@dataclasses.dataclass(frozen=True)
class ActivationSpec:
    """Static description of one few-bit activation.

    ``fwd(x, args)`` computes the exact activation on an f32 tensor.
    ``codes(x, borders, args)`` returns the per-element interval code: the
    interior borders below ``x`` (``compare_codes``), a predicate bit, or
    the stepwise code.  ``n_borders`` is the length of ``borders`` (0 for
    a predicate).  ``code`` names the kind a kernel computes (a key of
    :data:`CODE_KINDS`).  ``args``: the forward's and the predicate's
    scalars (λ, α, slope, min/max, β/threshold, value), or stepwise's
    ``(shift s, offset t, parity)`` with parity -1 for None.
    """

    name: str
    bits: int
    fwd: Callable[[torch.Tensor, tuple], torch.Tensor]
    codes: Callable[[torch.Tensor, torch.Tensor, tuple], torch.Tensor]
    args: tuple = ()
    n_borders: int = 0
    code: str = "borders"


def compare_codes(x: torch.Tensor, borders: torch.Tensor,
                  args: tuple) -> torch.Tensor:
    """Interval code = number of interior borders strictly below ``x``,
    compared in f32 (int32 result)."""
    xf = x.float()
    acc = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for k in range(borders.shape[0]):
        acc += (xf > borders[k]).to(torch.int32)
    return acc


def quantize_codes(x: torch.Tensor, borders: torch.Tensor) -> torch.Tensor:
    """Interval codes of ``x`` with respect to the interior ``borders``."""
    return compare_codes(x, borders, ())


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


def _round(v: float, dtype) -> float:
    return float(torch.tensor(v, dtype=torch.float32).to(dtype).float())


def spec_args(spec: ActivationSpec, dtype) -> tuple:
    """``spec.args`` as a forward sees them on an input of ``dtype``: each
    scalar rounded to that type, as a Python scalar meets a tensor in the
    JAX package (weak typing), so a bf16 input compares with bf16(0.3).
    Kernel 4 reads its input in its own type; kernels 6 and 2 read the f32
    accumulator.  Stepwise's arguments stay f32: its codes recentre in f32
    (``_compute_codes``)."""
    if spec.code == "stepwise":
        s, t, parity = spec.args
        return (_round(s, torch.float32), t, parity)
    return tuple(_round(a, dtype) for a in spec.args)


_PREDICATES = {
    # name -> (lo, hi, on |z|) of the code lo < b and not b >= hi, b = z or
    # |z|; hi NaN: no upper bound.  From the arguments as spec_args rounds
    # them.
    "relu": lambda a: (0.0, math.nan, 0),
    "leaky_relu": lambda a: (0.0, math.nan, 0),
    "relu6": lambda a: (0.0, 6.0, 0),
    "hardtanh": lambda a: (a[0], a[1], 0),
    "hardsigmoid": lambda a: (-3.0, 3.0, 0),
    "hardshrink": lambda a: (a[0], math.nan, 1),
    "softshrink": lambda a: (a[0], math.nan, 1),
    "threshold": lambda a: (a[0], math.nan, 0),
}


def kernel_args(spec: ActivationSpec, dtype) -> tuple:
    """The parameters a kernel reads of ``spec`` on an input of ``dtype``,
    in the order of ``ActArgs`` in ``csrc/common.cuh``: ``(act, kind, a0,
    a1, lo, hi, pred_abs, shift, parity)``."""
    args = spec_args(spec, dtype)
    lo, hi, on_abs = math.inf, math.nan, 0
    shift, parity = 0.0, -1
    fwd_args = (0.0, 0.0)
    if spec.code == "stepwise":
        shift, _, parity = args
    else:
        fwd_args = (tuple(args) + (0.0, 0.0))[:2]
        if spec.code == "predicate":
            lo, hi, on_abs = _PREDICATES[spec.name](args)
    return (ACT_IDS[spec.name], CODE_KINDS[spec.code], *fwd_args, lo, hi,
            on_abs, shift, int(parity))


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
