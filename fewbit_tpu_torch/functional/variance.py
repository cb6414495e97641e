"""Gradient-variance estimation for choosing sketch compression ratios, as
``fewbit_tpu/functional/variance.py``.

Given a layer input ``x`` (flattened to ``(N, d_in)``) and its output
gradient ``g`` (``(N, d_out)``), estimate

* the input/gradient correlation,
* the SGD (mini-batch sampling) variance of the weight gradient,
* the RMM (randomized matmul / sketching) variance,

so that ``proj_dim_ratio`` can be chosen where the sketch noise stays below
the inherent SGD noise (the criterion of arXiv 2201.13195).  The estimates
are computed on the tensors' own device, accumulating in f32 (or f64 for
f64 inputs).

Gradient capture: :func:`catch_gradients` is an identity
``torch.autograd.Function`` that records its input on the forward and the
incoming gradient on the backward into a :class:`GradientStorage`, where
the JAX package ships both to the host through ``jax.debug.callback``.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ("GradientStorage", "catch_gradients", "estimate_correlation",
           "estimate_variance_sgd", "estimate_variance_rmm")


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in its accumulation type: at least f32."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _xg_norm_sq(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm(x.t() @ g) ** 2


def estimate_correlation(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Squared normalised correlation ``(|x^T g| / (|x| |g|))^2``."""
    x, g = _acc(x), _acc(g)
    xg = torch.linalg.norm(x.t() @ g)
    return (xg / (torch.linalg.norm(x) * torch.linalg.norm(g))) ** 2


def estimate_variance_sgd(x: torch.Tensor, g: torch.Tensor,
                          batch_size: Optional[int] = None) -> torch.Tensor:
    """Variance of the SGD weight-gradient estimator over row subsampling."""
    bs = batch_size if batch_size else x.shape[0]
    if bs < 2:
        raise ValueError(
            f"estimate_variance_sgd needs a batch of at least 2 rows "
            f"(got {bs}); the unbiased variance divides by batch_size - 1")
    x, g = _acc(x), _acc(g)
    fst = bs / (bs - 1)
    snd = 1.0 / (bs - 1)
    xs = torch.sum(x * x, dim=1)
    gs = torch.sum(g * g, dim=1)
    return fst * (xs @ gs) - snd * _xg_norm_sq(x, g)


def estimate_variance_rmm(x: torch.Tensor, g: torch.Tensor,
                          proj_dim: Optional[int] = None) -> torch.Tensor:
    """Variance of the randomized-matmul (sketched) gradient estimator."""
    k = proj_dim if proj_dim else x.shape[0]
    x, g = _acc(x), _acc(g)
    xs = torch.linalg.norm(x) ** 2
    gs = torch.linalg.norm(g) ** 2
    return (xs * gs - _xg_norm_sq(x, g)) / k


class GradientStorage:
    """Holds a layer input and its output gradient, as captured."""

    def __init__(self) -> None:
        self.input = None
        self.grad_output = None

    def record_input(self, value) -> None:
        self.input = value

    def record_grad(self, value) -> None:
        self.grad_output = value
        self.postprocess()

    def postprocess(self) -> None:
        """Overridden by subclasses to react once both sides are present."""


class _CatchGradient(torch.autograd.Function):
    """Identity whose backward records the incoming gradient."""

    @staticmethod
    def forward(ctx, x, storage):
        ctx.storage = storage
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.storage.record_grad(g.detach())
        return g, None


def catch_gradients(x: torch.Tensor,
                    storage: GradientStorage) -> torch.Tensor:
    """Identity that records ``x`` into ``storage`` on the forward and its
    gradient on the backward (returned unchanged)."""
    storage.record_input(x.detach())
    return _CatchGradient.apply(x, storage)
