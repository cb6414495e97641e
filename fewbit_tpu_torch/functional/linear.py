"""Linear layer with a countsketched weight gradient, as the countsketch
path of ``fewbit_tpu/functional/linear.py``.

``linear_grp_native`` computes the exact forward ``y = x @ kernel + b``;
its backward keeps only a countsketch of the input along the flattened
batch axis, ``sk_x[b] = sum_{r = b mod k_eff} sigma_r x_r``, sketches the
output gradient with the same signs, and estimates ``dW = sk_x^T sk_g``
(unbiased: ``E[sigma_i sigma_j] = delta_ij``).  The signs ``sigma`` are an
argument: the modules draw them from a ``torch.Generator``.

Inside the kernel envelope (:func:`_fused_cs_keff`, a function of shapes
alone) forward and backward run kernel 1,
:func:`fewbit_tpu_torch.ops.kernels.fused_matmul_input_sketch`; outside it
(the classification head, whose N is the batch) the plain sketch runs.
The other sketch kinds are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from fewbit_tpu_torch.ops import kernels as K

__all__ = ("linear_grp_native", "calc_proj_dim", "MATMUL_KINDS")

MATMUL_KINDS = ("gaussian", "rademacher", "dct", "dft", "countsketch",
                "srht")
PORTED_KINDS = ("countsketch",)


def calc_proj_dim(ndim: int,
                  proj_dim_ratio: Optional[float] = None,
                  proj_dim: Optional[int] = None,
                  proj_dim_max: Optional[int] = None,
                  proj_dim_min: Optional[int] = None) -> int:
    """Resolve the sketch dimension from ratio/exact/min/max settings."""
    if proj_dim:
        result = proj_dim
    elif proj_dim_ratio:
        result = int(proj_dim_ratio * ndim)
    else:
        result = ndim
    if proj_dim_min:
        result = max(proj_dim_min, result)
    if proj_dim_max:
        result = min(proj_dim_max, result)
    return max(result, 1)


@dataclasses.dataclass(frozen=True)
class _GRPConfig:
    proj_features: int
    matmul: str
    has_bias: bool


def _dot_acc_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an f32 result: f32 operands multiply in f32, bf16
    operands on the bf16 path (f32 accumulation inside the product)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt)).float()


def _countsketch_partition(n: int, k: int):
    """A stride partition ``(block, k_eff)`` with ``block * k_eff == n``
    and ``k <= k_eff <= 2 k``, or None."""
    if k >= n:
        return 1, n
    for block in range(n // k, 0, -1):
        if n % block:
            continue
        k_eff = n // block
        if k_eff > 2 * k:
            return None
        if k_eff % 8 == 0 or block == 1:
            return block, k_eff
    return None


_countsketch_signed = K.countsketch_signed


def _plain_keff(n: int, k: int) -> int:
    part = _countsketch_partition(n, k)
    return part[1] if part is not None else k


def _fused_cs_keff(cfg: _GRPConfig, n: int, kdim: int, m: int,
                   dtype) -> Optional[int]:
    """Aligned bucket count when BOTH directions of kernel 1 are in its
    envelope, else None.  A pure function of shapes and dtype, so forward
    and backward make the same decision."""
    if cfg.matmul != "countsketch":
        return None
    k = cfg.proj_features
    ke_fwd = K.matmul_sketch_keff(n, kdim, m, k, dtype)
    ke_bwd = K.matmul_sketch_keff(n, m, kdim, k, dtype)
    if ke_fwd is None or ke_fwd != ke_bwd:
        return None
    return ke_fwd


class _LinearGRP(torch.autograd.Function):
    """Exact ``x @ kernel + b``; the backward keeps ``(sketch, kernel,
    sigma)``, never ``x``."""

    @staticmethod
    def forward(ctx, cfg: _GRPConfig, x, kernel, bias, sigma):
        x2 = x.reshape(-1, x.shape[-1])
        n = x2.shape[0]
        k_eff = _fused_cs_keff(cfg, n, kernel.shape[0], kernel.shape[1],
                               x.dtype)
        if k_eff is not None:
            y2, sketch = K.fused_matmul_input_sketch(
                x2.contiguous(), kernel, bias, sigma, k_eff)
        else:
            y2 = x2 @ kernel
            if bias is not None:
                y2 = y2 + bias
            sketch = _countsketch_signed(
                x2, sigma, _plain_keff(n, cfg.proj_features))
        ctx.cfg = cfg
        ctx.x_shape = x.shape
        ctx.save_for_backward(sketch, kernel, sigma)
        return y2.reshape(*x.shape[:-1], kernel.shape[1])

    @staticmethod
    def backward(ctx, g):
        cfg = ctx.cfg
        sketch, kernel, sigma = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        n = g2.shape[0]
        # The backward contracts against the forward's sketch: its bucket
        # partition is read off the residual's shape.
        k_eff = sketch.shape[0]
        if _fused_cs_keff(cfg, n, kernel.shape[0], kernel.shape[1],
                          g.dtype) == k_eff:
            out = K.fused_matmul_input_sketch(
                g2.contiguous(), kernel.t(), None, sigma, k_eff,
                want_colsum=cfg.has_bias)
            grad_x2, g_proj = out[0], out[1]
            grad_b = out[2].to(g.dtype) if cfg.has_bias else None
        else:
            grad_x2 = g2 @ kernel.t()
            g_proj = _countsketch_signed(g2, sigma, k_eff)
            grad_b = g2.sum(0) if cfg.has_bias else None
        grad_k = _dot_acc_f32(sketch.t(), g_proj).to(kernel.dtype)
        grad_x = grad_x2.reshape(ctx.x_shape).to(g.dtype)
        return None, grad_x, grad_k, grad_b, None


def _validate_grp(x, proj_dim_ratio, proj_dim, proj_dim_max, proj_dim_min,
                  matmul, bias) -> _GRPConfig:
    if proj_dim_ratio is None and proj_dim is None:
        raise ValueError("either proj_dim or proj_dim_ratio must be given")
    if proj_dim_min is not None and proj_dim_min <= 0:
        raise ValueError("proj_dim_min must be strictly positive")
    if (proj_dim_min is not None and proj_dim_max is not None
            and proj_dim_max < proj_dim_min):
        raise ValueError("proj_dim_min must not exceed proj_dim_max")
    if matmul not in MATMUL_KINDS:
        raise ValueError(
            f"unknown matmul kind {matmul!r}; expected one of {MATMUL_KINDS}")
    if matmul not in PORTED_KINDS:
        raise NotImplementedError(
            f"sketch kind {matmul!r} is not ported yet (ROADMAP, queue 1 "
            f"item 10: other sketch kinds and CRS); ported: {PORTED_KINDS}")
    ndim = int(np.prod(x.shape[:-1]))
    k = calc_proj_dim(ndim, proj_dim_ratio, proj_dim, proj_dim_max,
                      proj_dim_min)
    return _GRPConfig(proj_features=k, matmul=matmul,
                      has_bias=bias is not None)


def linear_grp_native(x: torch.Tensor,
                      kernel: torch.Tensor,
                      bias: Optional[torch.Tensor],
                      sigma: torch.Tensor,
                      proj_dim_ratio: Optional[float] = None,
                      proj_dim: Optional[int] = None,
                      proj_dim_max: Optional[int] = None,
                      proj_dim_min: Optional[int] = None,
                      matmul: str = "countsketch") -> torch.Tensor:
    """Exact linear forward with a sketched weight-gradient backward.

    :param x: input, shape ``(..., in)``.
    :param kernel: the ``(in, out)`` weight (flax orientation; a torch
        ``(out, in)`` weight passes as ``weight.t()``).
    :param sigma: ``(prod(x.shape[:-1]),)`` f32 random signs, shared by the
        forward sketch and the backward gradient sketch.
    """
    cfg = _validate_grp(x, proj_dim_ratio, proj_dim, proj_dim_max,
                        proj_dim_min, matmul, bias)
    return _LinearGRP.apply(cfg, x, kernel, bias, sigma)
