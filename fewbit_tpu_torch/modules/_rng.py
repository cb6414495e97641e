"""Sketch-sign plumbing for the sketched modules.

The sketched weight-gradient estimators are unbiased only over fresh random
signs.  Each forward takes a ``torch.Generator`` (fresh per training step)
in place of flax's ``'sketch'`` RNG collection.  Without one, the module
falls back to a constant seed with a warning (inference still works: the
sketch only affects gradients), or raises under
``FEWBIT_TPU_STRICT_SKETCH=1``.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

import torch

from fewbit_tpu_torch.functional.linear import draw_signs

__all__ = ("sketch_generator", "draw_signs", "lecun_normal_")

_WARNING = (
    "{cls}: no sketch generator was passed to forward(); falling back to a "
    "constant key.  Every training step will reuse the SAME random sketch "
    "signs, so the weight-gradient noise is perfectly correlated across "
    "steps and will not average out.  Pass a torch.Generator (fresh per "
    "step) when training; this fallback is only safe for inference.  Set "
    "FEWBIT_TPU_STRICT_SKETCH=1 to make this an error.")


def sketch_generator(module, generator: Optional[torch.Generator],
                     device) -> torch.Generator:
    """The generator to draw ``module``'s sketch signs from: ``generator``
    when given, else a constant-seeded one with a warning (or, under
    ``FEWBIT_TPU_STRICT_SKETCH=1``, an error)."""
    if generator is not None:
        return generator
    msg = _WARNING.format(cls=type(module).__name__)
    if os.environ.get("FEWBIT_TPU_STRICT_SKETCH") == "1":
        raise RuntimeError(msg)
    warnings.warn(msg, stacklevel=3)
    return torch.Generator(device=device).manual_seed(0)


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None):
    """flax's default kernel init: a normal truncated at two standard
    deviations, scaled to variance ``1 / fan_in``."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        return torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                           generator=generator)
