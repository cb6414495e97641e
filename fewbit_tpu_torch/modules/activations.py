"""Module wrappers of the few-bit activations, as
``fewbit_tpu/modules/activations.py``: the 9 classes of the piecewise
family (``Stepwise``, the user LUT, among them) and the 13 of the
continuous one.  Each constructor takes the flax module's fields, in their
order; the continuous ones take ``bits`` (default 3) or ``borders`` +
``values`` first, then the function's own arguments."""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import nn

from fewbit_tpu_torch.functional import activations as F

STEPWISE = ("Hardshrink", "Hardsigmoid", "Hardtanh", "LeakyReLU", "ReLU",
            "ReLU6", "Softshrink", "Stepwise", "Threshold")
CONTINUOUS = ("CELU", "ELU", "GELU", "Hardswish", "LogSigmoid", "Mish",
              "SELU", "Sigmoid", "SiLU", "Softplus", "Softsign", "Tanh",
              "Tanhshrink")

__all__ = STEPWISE + CONTINUOUS


class Hardshrink(nn.Module):

    def __init__(self, lambd: float = 0.5):
        super().__init__()
        self.lambd = lambd

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.hardshrink(x, self.lambd)


class Hardsigmoid(nn.Module):

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.hardsigmoid(x)


class Hardtanh(nn.Module):

    def __init__(self, min_val: float = -1.0, max_val: float = 1.0):
        super().__init__()
        self.min_val, self.max_val = min_val, max_val

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.hardtanh(x, self.min_val, self.max_val)


class LeakyReLU(nn.Module):

    def __init__(self, negative_slope: float = 0.01):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(x, self.negative_slope)


class ReLU(nn.Module):

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(x)


class ReLU6(nn.Module):

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu6(x)


class Softshrink(nn.Module):

    def __init__(self, lambd: float = 0.5):
        super().__init__()
        self.lambd = lambd

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.softshrink(x, self.lambd)


class Threshold(nn.Module):

    def __init__(self, threshold: float = 0.0, value: float = 0.0):
        super().__init__()
        self.threshold, self.value = threshold, value

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.threshold(x, self.threshold, self.value)


class Stepwise(nn.Module):
    """User-defined stepwise derivative (identity forward).

    :param borders: interior interval borders (outer edges stripped if
        given).
    :param levels: constant derivative value per interval (at most 256).
    :param parity: ``None`` for a full-domain LUT; ``False``/``True`` for a
        half-domain LUT of an even/odd derivative.
    :param shift: optional ``(s, t)`` recentring of the derivative.
    """

    def __init__(self, borders: Any = None, levels: Any = None,
                 parity: Optional[bool] = None,
                 shift: Optional[Tuple[float, float]] = None):
        super().__init__()
        self.borders, self.levels = borders, levels
        self.parity, self.shift = parity, shift

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.stepwise(x, self.borders, self.levels, self.parity,
                          self.shift)


class _ContinuousBase(nn.Module):
    """The LUT fields of the continuous family."""

    def __init__(self, bits: Optional[int] = None, borders: Any = None,
                 values: Any = None):
        super().__init__()
        self.bits, self.borders, self.values = bits, borders, values

    def _lut_kwargs(self):
        return dict(bits=self.bits, borders=self.borders, values=self.values)


class CELU(_ContinuousBase):

    def __init__(self, bits: Optional[int] = None, borders: Any = None,
                 values: Any = None, alpha: float = 1.0):
        super().__init__(bits, borders, values)
        self.alpha = alpha

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.celu(x, self.alpha, **self._lut_kwargs())


class ELU(_ContinuousBase):

    def __init__(self, bits: Optional[int] = None, borders: Any = None,
                 values: Any = None, alpha: float = 1.0):
        super().__init__(bits, borders, values)
        self.alpha = alpha

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.elu(x, self.alpha, **self._lut_kwargs())


class GELU(_ContinuousBase):
    """Exact GELU with a few-bit backward."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(x, **self._lut_kwargs())


class Hardswish(_ContinuousBase):

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.hardswish(x, **self._lut_kwargs())


class LogSigmoid(_ContinuousBase):

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.logsigmoid(x, **self._lut_kwargs())


class Mish(_ContinuousBase):

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.mish(x, **self._lut_kwargs())


class SELU(_ContinuousBase):

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.selu(x, **self._lut_kwargs())


class Sigmoid(_ContinuousBase):

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.sigmoid(x, **self._lut_kwargs())


class SiLU(_ContinuousBase):

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(x, **self._lut_kwargs())


class Softplus(_ContinuousBase):

    def __init__(self, bits: Optional[int] = None, borders: Any = None,
                 values: Any = None, beta: float = 1.0,
                 threshold: float = 20.0):
        super().__init__(bits, borders, values)
        self.beta, self.threshold = beta, threshold

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.softplus(x, self.beta, self.threshold, **self._lut_kwargs())


class Softsign(_ContinuousBase):

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.softsign(x, **self._lut_kwargs())


class Tanh(_ContinuousBase):

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.tanh(x, **self._lut_kwargs())


class Tanhshrink(_ContinuousBase):

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.tanhshrink(x, **self._lut_kwargs())
