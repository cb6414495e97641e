"""Few-bit activations by name, as ``fewbit_tpu/functional/activations.py``:
the 8 piecewise 1-bit functions, the 13 continuous ones with a LUT of
``bits`` (default 3) or a custom ``borders``/``values`` one, the generic
``stepwise``, and ``resolve_activation``, which builds the (spec, interior
borders, levels) triple the elementwise engine and the fused ops share.

Every forward here takes the f32-widened input and the arguments as
:func:`fewbit_tpu_torch.ops.activations.spec_args` rounds them, and its
result is stored once in the input's type: what kernels 4, 6 and 2 compute
(the exact libm forms, ``erf``, ``expm1``, ``log1p``, ``tanh``; softplus in
its stable form).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as TF

from fewbit_tpu_torch.lut import store
from fewbit_tpu_torch.ops.activations import (ActivationSpec, compare_codes,
                                              fewbit_activation)

STEPWISE = ("hardshrink", "hardsigmoid", "hardtanh", "leaky_relu", "relu",
            "relu6", "softshrink", "stepwise", "threshold")

CONTINUOUS = ("celu", "elu", "gelu", "hardswish", "logsigmoid", "mish", "selu",
              "sigmoid", "silu", "softplus", "softsign", "tanh", "tanhshrink")

__all__ = STEPWISE + CONTINUOUS + ("store", "resolve_activation")


def _empty_borders(device=None) -> torch.Tensor:
    return torch.zeros((0,), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# 1-bit piecewise family: exact forward, a predicate bit, two levels.
# ---------------------------------------------------------------------------


def _bits(pred: torch.Tensor) -> torch.Tensor:
    return pred.to(torch.int32)


def _hardshrink_fwd(x, args):
    (lambd,) = args
    return torch.where(x.abs() > lambd, x, torch.zeros_like(x))


def _hardshrink_pred(x, borders, args):
    (lambd,) = args
    return _bits(x.abs() > lambd)


def _hardsigmoid_fwd(x, args):
    return torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


def _hardsigmoid_pred(x, borders, args):
    return _bits((x > -3.0) & (x < 3.0))


def _hardtanh_fwd(x, args):
    lo, hi = args
    return torch.clamp(x, lo, hi)


def _hardtanh_pred(x, borders, args):
    lo, hi = args
    return _bits((x > lo) & (x < hi))


def _leaky_relu_fwd(x, args):
    (slope,) = args
    return torch.where(x >= 0, x, x * slope)


def _positive_pred(x, borders, args):
    return _bits(x > 0)


def _relu_fwd(x, args):
    return torch.where(x < 0, torch.zeros_like(x), x)


def _relu6_fwd(x, args):
    # Clamps at 6, as the JAX package does.
    return torch.clamp(x, 0.0, 6.0)


def _relu6_pred(x, borders, args):
    return _bits((x > 0.0) & (x < 6.0))


def _softshrink_fwd(x, args):
    (lambd,) = args
    return torch.where(x > lambd, x - lambd,
                       torch.where(x < -lambd, x + lambd, torch.zeros_like(x)))


def _threshold_fwd(x, args):
    thresh, value = args
    return torch.where(x > thresh, x, torch.full_like(x, value))


def _threshold_pred(x, borders, args):
    thresh, _ = args
    return _bits(x > thresh)


def _binary_call(name, x, args):
    spec, b, v = resolve_activation(name, args=args, device=x.device)
    return fewbit_activation(spec, x, b, v)


def hardshrink(x: torch.Tensor, lambd: float = 0.5) -> torch.Tensor:
    """Hard shrinkage; saves 1 bit per element for the backward."""
    return _binary_call("hardshrink", x, (float(lambd),))


def hardsigmoid(x: torch.Tensor) -> torch.Tensor:
    return _binary_call("hardsigmoid", x, ())


def hardtanh(x: torch.Tensor, min_val: float = -1.0,
             max_val: float = 1.0) -> torch.Tensor:
    return _binary_call("hardtanh", x, (float(min_val), float(max_val)))


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return _binary_call("leaky_relu", x, (float(negative_slope),))


def relu(x: torch.Tensor) -> torch.Tensor:
    return _binary_call("relu", x, ())


def relu6(x: torch.Tensor) -> torch.Tensor:
    return _binary_call("relu6", x, ())


def softshrink(x: torch.Tensor, lambd: float = 0.5) -> torch.Tensor:
    return _binary_call("softshrink", x, (float(lambd),))


def threshold(x: torch.Tensor, threshold: float,
              value: float) -> torch.Tensor:
    return _binary_call("threshold", x, (float(threshold), float(value)))


# ---------------------------------------------------------------------------
# Generic user-defined stepwise derivative.
# ---------------------------------------------------------------------------


def _identity_fwd(x, args):
    return x


def _stepwise_codes(x, borders, args, half):
    """Stepwise's code, as the JAX package's ``_compute_codes``: x
    recentred by s in f32, the borders counted on ``|x - s|`` when parity
    is set, and for parity True the sign bit ``half = 1 << (bits - 1)``
    added below s (the negative half-table starts at the padded half
    size)."""
    s, _, parity = args
    xs = x.float() - s if s else x.float()
    codes = compare_codes(xs.abs() if parity >= 0 else xs, borders, ())
    if parity == 1:
        codes = codes + torch.where(xs < 0, half, 0).to(torch.int32)
    return codes


def stepwise_triple(borders, levels, parity: Optional[bool] = None,
                    shift: Optional[Tuple[float, float]] = None,
                    device=None):
    """The ``(spec, interior borders, levels)`` of :func:`stepwise`, f32
    tensors on ``device``: what ``resolve_activation`` gives for a name."""
    borders = np.asarray(borders, dtype=np.float32)
    levels = np.asarray(levels, dtype=np.float32)
    if borders.ndim != 1 or levels.ndim != 1:
        raise ValueError("borders and levels must be 1-D")
    if borders.shape[0] == levels.shape[0] + 1:
        borders = borders[1:-1]
    if borders.shape[0] != levels.shape[0] - 1:
        raise ValueError(
            f"expected len(borders) == len(levels) - 1, got "
            f"{borders.shape[0]} vs {levels.shape[0]}")
    if levels.shape[0] > 256:
        raise ValueError("at most 256 levels are supported")
    bits = max(1, math.ceil(math.log2(levels.shape[0])))
    s, t = shift if shift is not None else (0.0, 0.0)
    # Padded to 1 << bits, as the kernels read the table: no code reaches
    # the padding.  The negative half-table of parity True starts at the
    # padded half size, not at len(levels): they differ for a LUT that is
    # not a power of two.
    full_levels = np.pad(levels, (0, (1 << bits) - levels.shape[0]))
    if parity:
        full_levels = np.concatenate([full_levels, -full_levels])
        bits += 1
    if t:
        full_levels = full_levels + np.float32(t)
    p = -1 if parity is None else int(bool(parity))
    spec = ActivationSpec(
        "stepwise", bits, _identity_fwd,
        functools.partial(_stepwise_codes, half=1 << (bits - 1)),
        args=(float(s), float(t), p), n_borders=int(borders.shape[0]),
        code="stepwise")
    return (spec, torch.tensor(borders, device=device),
            torch.tensor(full_levels, dtype=torch.float32, device=device))


def stepwise(x: torch.Tensor, borders, levels,
             parity: Optional[bool] = None,
             shift: Optional[Tuple[float, float]] = None) -> torch.Tensor:
    """Identity forward with a user-defined stepwise derivative.

    ``borders`` may include the outer domain edges (they are stripped).
    With ``parity`` set, the LUT describes the right half-domain of a
    symmetric derivative: ``parity=False`` (even derivative) quantises
    ``|x - s|``; ``parity=True`` (odd derivative) also flips the sign of
    the level for ``x < s``.  ``shift=(s, t)`` recentres the derivative at
    ``s`` and adds the constant ``t``.  At most 256 levels.
    """
    spec, b, v = stepwise_triple(borders, levels, parity, shift, x.device)
    return fewbit_activation(spec, x, b, v)


# ---------------------------------------------------------------------------
# Continuous family: exact forward, LUT-quantised derivative.
# ---------------------------------------------------------------------------

_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805


def _softplus(x):
    """``log(1 + e^x)``: torch's (``x`` itself above 20, where the kernels'
    stable form ``max(x, 0) + log1p(e^-|x|)`` rounds to ``x`` too)."""
    return TF.softplus(x)


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


# Bound at import: ``use_fewbit_activation`` (:mod:`fewbit_tpu_torch.patch`)
# points ``torch.nn.functional.gelu`` and ``torch.tanh`` at these few-bit
# functions within its scope, and their forwards must stay exact.
_exact_gelu = TF.gelu
_exact_tanh = torch.tanh


def _celu_fwd(x, args):
    (alpha,) = args
    return torch.where(x > 0, x, alpha * torch.expm1(x / alpha))


def _elu_fwd(x, args):
    (alpha,) = args
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def _gelu_fwd(x, args):
    # Exact (erf) GELU, x * normcdf(x).
    return _exact_gelu(x, approximate="none")


def _hardswish_fwd(x, args):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def _logsigmoid_fwd(x, args):
    return -_softplus(-x)


def _mish_fwd(x, args):
    return x * _exact_tanh(_softplus(x))


def _selu_fwd(x, args):
    return _SELU_SCALE * torch.where(x > 0, x, _SELU_ALPHA * torch.expm1(x))


def _sigmoid_fwd(x, args):
    return _sigmoid(x)


def _silu_fwd(x, args):
    return x * _sigmoid(x)


def _softplus_fwd(x, args):
    beta, thresh = args
    scaled = x * beta
    return torch.where(scaled > thresh, x, _softplus(scaled) / beta)


def _softsign_fwd(x, args):
    return x / (1.0 + x.abs())


def _tanh_fwd(x, args):
    return _exact_tanh(x)


def _tanhshrink_fwd(x, args):
    return x - _exact_tanh(x)


def _resolve_lut(name: str, bits: Optional[int], borders, values):
    use_builtin = bits is not None
    use_custom = borders is not None and values is not None
    if use_builtin and use_custom:
        raise ValueError(
            "specify either `bits` or `borders`+`values`, not both")
    if use_custom:
        borders = np.asarray(borders, dtype=np.float32)
        values = np.asarray(values, dtype=np.float32)
        if borders.shape[0] == values.shape[0] + 1:
            borders = borders[1:-1]
        if borders.shape[0] != values.shape[0] - 1:
            raise ValueError(
                f"expected len(borders) == len(values) - 1, got "
                f"{borders.shape[0]} vs {values.shape[0]}")
        nbits = max(1, math.ceil(math.log2(values.shape[0])))
        pad = (1 << nbits) - values.shape[0]
        if pad:
            values = np.pad(values, (0, pad))
        return borders, values, nbits
    nbits = bits if bits is not None else 3
    b, v = store.get_interior(name, nbits)
    return b, v, nbits


# name -> (fwd, predicate, default args, level below, level above); the
# low level None: leaky_relu's, its negative slope.
_BUILDERS = {
    "relu": (_relu_fwd, _positive_pred, (), 0.0, 1.0),
    "relu6": (_relu6_fwd, _relu6_pred, (), 0.0, 1.0),
    "hardtanh": (_hardtanh_fwd, _hardtanh_pred, (-1.0, 1.0), 0.0, 1.0),
    "leaky_relu": (_leaky_relu_fwd, _positive_pred, (0.01,), None, 1.0),
    "hardsigmoid": (_hardsigmoid_fwd, _hardsigmoid_pred, (), 0.0, 1.0 / 6.0),
    "hardshrink": (_hardshrink_fwd, _hardshrink_pred, (0.5,), 0.0, 1.0),
    "softshrink": (_softshrink_fwd, _hardshrink_pred, (0.5,), 0.0, 1.0),
    "threshold": (_threshold_fwd, _threshold_pred, (0.0, 0.0), 0.0, 1.0),
}


def resolve_activation(name: str, bits: Optional[int] = None, borders=None,
                       values=None, args: tuple = (), device=None):
    """The ``(spec, borders, levels)`` triple for an activation by name;
    ``borders`` and ``levels`` are f32 tensors on ``device``.  Any name of
    the two families but ``stepwise``, which has no builtin LUT (call
    :func:`stepwise`).  ``args`` default as in the JAX package: alpha 1.0
    for celu and elu, (1.0, 20.0) for softplus, each piecewise function's
    own."""
    if name in CONTINUOUS:
        fwd = globals()[f"_{name}_fwd"]
        if name in ("celu", "elu") and not args:
            args = (1.0,)
        if name == "softplus" and not args:
            args = (1.0, 20.0)
        b, v, nbits = _resolve_lut(name, bits, borders, values)
        spec = ActivationSpec(name=name, bits=nbits, fwd=fwd,
                              codes=compare_codes, args=tuple(args),
                              n_borders=int(b.shape[0]))
        return (spec, torch.tensor(b, dtype=torch.float32, device=device),
                torch.tensor(v, dtype=torch.float32, device=device))
    if name not in _BUILDERS:
        raise ValueError(f"unknown activation {name!r}")
    fwd, pred, default_args, lo, hi = _BUILDERS[name]
    args = tuple(args) or default_args
    if lo is None:
        lo = args[0]
    spec = ActivationSpec(name=name, bits=1, fwd=fwd, codes=pred, args=args,
                          n_borders=0, code="predicate")
    return (spec, _empty_borders(device),
            torch.tensor([lo, hi], dtype=torch.float32, device=device))


def _continuous_call(name, x, args, bits, borders, values):
    spec, b, v = resolve_activation(name, bits=bits, borders=borders,
                                    values=values, args=args,
                                    device=x.device)
    return fewbit_activation(spec, x, b, v)


def celu(x: torch.Tensor, alpha: float = 1.0, *, bits: Optional[int] = None,
         borders=None, values=None) -> torch.Tensor:
    return _continuous_call("celu", x, (float(alpha),), bits, borders,
                            values)


def elu(x: torch.Tensor, alpha: float = 1.0, *, bits: Optional[int] = None,
        borders=None, values=None) -> torch.Tensor:
    return _continuous_call("elu", x, (float(alpha),), bits, borders, values)


def gelu(x: torch.Tensor, *, bits: Optional[int] = None, borders=None,
         values=None) -> torch.Tensor:
    """Exact GELU whose backward keeps ``bits``-bit codes of ``x`` (3 when
    neither ``bits`` nor ``borders``/``values`` is given)."""
    return _continuous_call("gelu", x, (), bits, borders, values)


def hardswish(x: torch.Tensor, *, bits: Optional[int] = None, borders=None,
              values=None) -> torch.Tensor:
    return _continuous_call("hardswish", x, (), bits, borders, values)


def logsigmoid(x: torch.Tensor, *, bits: Optional[int] = None, borders=None,
               values=None) -> torch.Tensor:
    return _continuous_call("logsigmoid", x, (), bits, borders, values)


def mish(x: torch.Tensor, *, bits: Optional[int] = None, borders=None,
         values=None) -> torch.Tensor:
    return _continuous_call("mish", x, (), bits, borders, values)


def selu(x: torch.Tensor, *, bits: Optional[int] = None, borders=None,
         values=None) -> torch.Tensor:
    return _continuous_call("selu", x, (), bits, borders, values)


def sigmoid(x: torch.Tensor, *, bits: Optional[int] = None, borders=None,
            values=None) -> torch.Tensor:
    return _continuous_call("sigmoid", x, (), bits, borders, values)


def silu(x: torch.Tensor, *, bits: Optional[int] = None, borders=None,
         values=None) -> torch.Tensor:
    return _continuous_call("silu", x, (), bits, borders, values)


def softplus(x: torch.Tensor, beta: float = 1.0, threshold: float = 20.0, *,
             bits: Optional[int] = None, borders=None,
             values=None) -> torch.Tensor:
    return _continuous_call("softplus", x, (float(beta), float(threshold)),
                            bits, borders, values)


def softsign(x: torch.Tensor, *, bits: Optional[int] = None, borders=None,
             values=None) -> torch.Tensor:
    return _continuous_call("softsign", x, (), bits, borders, values)


def tanh(x: torch.Tensor, *, bits: Optional[int] = None, borders=None,
         values=None) -> torch.Tensor:
    return _continuous_call("tanh", x, (), bits, borders, values)


def tanhshrink(x: torch.Tensor, *, bits: Optional[int] = None, borders=None,
               values=None) -> torch.Tensor:
    return _continuous_call("tanhshrink", x, (), bits, borders, values)
