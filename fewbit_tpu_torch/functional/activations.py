"""Few-bit activations by name: ``resolve_activation`` (spec, interior
borders and levels) and the functional ``gelu``, as in
``fewbit_tpu/functional/activations.py``.

The port has the exact erf GELU.  The other activations wait for ROADMAP
queue 1 item 7; each adds an activation id to kernels 4 and 6.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as TF

from fewbit_tpu_torch.lut import store
from fewbit_tpu_torch.ops.activations import (ActivationSpec, compare_codes,
                                              fewbit_activation)

__all__ = ("resolve_activation", "gelu_exact", "gelu")

PORTED = ("gelu",)


def gelu_exact(x: torch.Tensor, args: tuple = ()) -> torch.Tensor:
    """Exact (erf-based) GELU, ``x * normcdf(x)``."""
    return TF.gelu(x, approximate="none")


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


def resolve_activation(name: str, bits: Optional[int] = None, borders=None,
                       values=None, args: tuple = (), device=None):
    """The ``(spec, borders, levels)`` triple for an activation by name;
    ``borders`` and ``levels`` are f32 tensors on ``device``."""
    if name not in PORTED:
        raise NotImplementedError(
            f"activation {name!r} is not ported yet (ROADMAP, queue 1 item "
            f"7: full activation surface); ported: {PORTED}")
    b, v, nbits = _resolve_lut(name, bits, borders, values)
    spec = ActivationSpec(name=name, bits=nbits, fwd=gelu_exact,
                          codes=compare_codes, args=args,
                          n_borders=int(b.shape[0]))
    return (spec, torch.tensor(b, dtype=torch.float32, device=device),
            torch.tensor(v, dtype=torch.float32, device=device))


def gelu(x: torch.Tensor, *, bits: Optional[int] = None, borders=None,
         values=None) -> torch.Tensor:
    """Exact GELU whose backward keeps ``bits``-bit codes of ``x`` (3 when
    neither ``bits`` nor ``borders``/``values`` is given)."""
    spec, b, v = resolve_activation("gelu", bits=bits, borders=borders,
                                    values=values, device=x.device)
    return fewbit_activation(spec, x, b, v)
