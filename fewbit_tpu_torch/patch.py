"""Whole-model few-bit conversion for third-party models, as
``fewbit_tpu/patch.py``: scoped, reversible patches at the class and
module level, for models whose layers :func:`fewbit_tpu_torch.util.map_module`
should not or cannot rewrite.

Inside :func:`use_fewbit_dense`, every ``torch.nn.Linear.forward`` computes
through :func:`fewbit_tpu_torch.functional.linear_grp` (exact forward,
sketched weight gradient).  Inside :func:`use_fewbit_activation`,
``torch.nn.functional.<name>`` (and ``torch.<name>`` for ``sigmoid`` and
``tanh``, which ``nn.Sigmoid`` and ``nn.Tanh`` call) runs through the
few-bit engine.  Both act on calls made within the scope; a module that
bound the function itself when it was built (HF's ``GELUActivation`` binds
``nn.functional.gelu`` in its constructor) keeps what it bound, so such a
model must be built inside the activation patch.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

import torch
import torch.nn.functional as TF
from torch import nn

__all__ = ("use_fewbit_dense", "use_fewbit_activation")


@contextmanager
def use_fewbit_dense(proj_dim_ratio: Optional[float] = None,
                     proj_dim: Optional[int] = None,
                     proj_dim_min: Optional[int] = None,
                     proj_dim_max: Optional[int] = None,
                     matmul: str = "gaussian",
                     generator: Optional[torch.Generator] = None):
    """Scope in which every ``nn.Linear`` keeps a sketch of its input for
    the weight gradient.

    Parameters are unchanged, so existing checkpoints keep loading.  The
    layers draw their projections from ``generator`` (fresh per training
    step, shared by every layer in call order); without one each call
    falls back to a constant seed with a warning, or raises under
    ``FEWBIT_TPU_STRICT_SKETCH=1`` (:mod:`fewbit_tpu_torch.modules._rng`).
    """
    from fewbit_tpu_torch.functional.linear import linear_grp
    from fewbit_tpu_torch.modules._rng import sketch_generator

    original = nn.Linear.forward

    def patched(self, input):
        return linear_grp(input, self.weight, self.bias,
                          sketch_generator(self, generator, input.device),
                          proj_dim_ratio=proj_dim_ratio, proj_dim=proj_dim,
                          proj_dim_min=proj_dim_min,
                          proj_dim_max=proj_dim_max, matmul=matmul)

    nn.Linear.forward = patched
    try:
        yield
    finally:
        nn.Linear.forward = original


_ACT_TARGETS = ("gelu", "silu", "relu", "sigmoid", "tanh")
# The activations that nn.Sigmoid and nn.Tanh reach through ``torch.<name>``.
_TORCH_TARGETS = ("sigmoid", "tanh")


@contextmanager
def use_fewbit_activation(name: str = "gelu", bits: int = 3):
    """Scope in which ``torch.nn.functional.<name>`` (and ``torch.<name>``
    for ``sigmoid`` and ``tanh``) runs through the few-bit backward engine
    at ``bits`` bits; arguments other than the input (``approximate=``,
    ``inplace=``) are dropped, as the JAX package drops them."""
    if name not in _ACT_TARGETS:
        raise ValueError(f"unsupported activation {name!r}; "
                         f"one of {_ACT_TARGETS}")
    import fewbit_tpu_torch.functional as F

    few = getattr(F, name)

    def patched(x, *args, **kwargs):
        return few(x, bits=bits) if name != "relu" else few(x)

    owners = [TF] + ([torch] if name in _TORCH_TARGETS else [])
    saved = [(owner, getattr(owner, name)) for owner in owners]
    for owner in owners:
        setattr(owner, name, patched)
    try:
        yield
    finally:
        for owner, fn in saved:
            setattr(owner, name, fn)
