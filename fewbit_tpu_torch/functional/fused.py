"""Fused dense + few-bit activation, as ``fewbit_tpu/functional/fused.py``:
``fewbit_dense_act(x, w, b) = act(x @ w + b)`` as one
``autograd.Function``.

* forward (kernel 6, :func:`fewbit_tpu_torch.ops.kernels.fused_dense_act`):
  the product with the activation, border compare and bit-plane pack in its
  epilogue; the pre-activation ``z`` never reaches device memory;
* residuals: the packed codes (``bits / 8`` bytes per element of ``z``),
  the weight, and either the exact input or, with a sketch configured,
  only its countsketch ``(k_eff, K)``;
* backward: ``dz = levels[codes] * g`` (kernel 5,
  :func:`fewbit_tpu_torch.ops.kernels.fused_backward`), then
  ``dx = dz @ w^T``, ``dW = sk(x)^T sk(dz)`` (or exactly ``x^T dz``) and
  ``db = sum dz`` as plain products.

The countsketch takes the plain stride partition (``_plain_keff``), as the
JAX package's ``_sketch`` does, with the signs ``sigma`` as an argument.
Other sketch kinds raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from fewbit_tpu_torch.functional.activations import resolve_activation
from fewbit_tpu_torch.functional.linear import (_countsketch_signed,
                                                _dot_acc_f32, _plain_keff,
                                                _validate_grp)
from fewbit_tpu_torch.ops import kernels as K

__all__ = ("fewbit_dense_act",)


@dataclasses.dataclass(frozen=True)
class _FusedConfig:
    spec: object               # ActivationSpec
    k_proj: Optional[int]      # requested sketch dimension; None = exact dW
    has_bias: bool


class _DenseAct(torch.autograd.Function):

    @staticmethod
    def forward(ctx, cfg: _FusedConfig, x, w, b, sigma, borders, levels):
        spec = cfg.spec
        x2 = x.reshape(-1, x.shape[-1])
        n, kdim = x2.shape
        m = w.shape[1]
        fwd = (K.fused_dense_act if K.dense_act_ok(spec, kdim, m, x.dtype)
               else K.dense_act_plain)
        y2, packed = fwd(spec, x2.contiguous(), w, b, borders)
        x_saved = (x2 if cfg.k_proj is None else
                   _countsketch_signed(x2, sigma, _plain_keff(n, cfg.k_proj)))
        ctx.cfg = cfg
        ctx.save_for_backward(packed, x_saved, w, sigma, levels)
        return y2.reshape(*x.shape[:-1], m)

    @staticmethod
    def backward(ctx, g):
        cfg = ctx.cfg
        spec = cfg.spec
        packed, x_saved, w, sigma, levels = ctx.saved_tensors
        kdim, m = w.shape
        g2 = g.reshape(-1, m)
        bwd = (K.fused_backward if K.act_kernel_ok(spec, m, g.dtype)
               else K.act_backward_plain)
        dz = bwd(spec, packed, levels, g2.contiguous())
        dx = torch.matmul(dz, w.t().to(dz.dtype))
        if cfg.k_proj is None:
            dw = _dot_acc_f32(x_saved.t(), dz)
        else:
            # The gradient side contracts against the forward's sketch: its
            # bucket count is read off the residual's shape.
            dz_proj = _countsketch_signed(dz, sigma, x_saved.shape[0])
            dw = _dot_acc_f32(x_saved.t(), dz_proj)
        db = dz.sum(0) if cfg.has_bias else None
        return (None, dx.reshape(*g.shape[:-1], kdim).to(g.dtype),
                dw.to(w.dtype), db, None, None, None)


def fewbit_dense_act(x: torch.Tensor,
                     w: torch.Tensor,
                     b: Optional[torch.Tensor] = None,
                     sigma: Optional[torch.Tensor] = None,
                     activation: str = "gelu",
                     bits: Optional[int] = None,
                     act_args: tuple = (),
                     borders=None,
                     values=None,
                     proj_dim_ratio: Optional[float] = None,
                     proj_dim: Optional[int] = None,
                     proj_dim_min: Optional[int] = None,
                     proj_dim_max: Optional[int] = None,
                     matmul: str = "countsketch") -> torch.Tensor:
    """``act(x @ w + b)`` with few-bit activation residuals and, with a
    ``proj_dim*`` setting, a countsketched weight gradient.

    :param x: ``(..., K)`` input.
    :param w: the logical ``(K, M)`` weight (flax orientation; a torch
        ``(out, in)`` weight passes as ``weight.t()``).
    :param sigma: ``(prod(x.shape[:-1]),)`` f32 random signs of the sketch,
        required when a ``proj_dim*`` setting is given.
    """
    spec, b_arr, v_arr = resolve_activation(activation, bits=bits,
                                            borders=borders, values=values,
                                            args=act_args, device=x.device)
    k_proj = None
    if proj_dim_ratio is not None or proj_dim is not None:
        if sigma is None:
            raise ValueError("sketch signs `sigma` are required for "
                             "sketched gradients")
        k_proj = _validate_grp(x, proj_dim_ratio, proj_dim, proj_dim_max,
                               proj_dim_min, matmul, None).proj_features
    cfg = _FusedConfig(spec=spec, k_proj=k_proj, has_bias=b is not None)
    return _DenseAct.apply(cfg, x, w, b, sigma, b_arr, v_arr)
