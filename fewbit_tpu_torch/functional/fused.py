"""Fused dense + few-bit activation, as ``fewbit_tpu/functional/fused.py``:
``fewbit_dense_act(x, w, b) = act(x @ w + b)`` as one
``autograd.Function``.

* forward (kernel 6, :func:`fewbit_tpu_torch.ops.kernels.fused_dense_act`):
  the product with the activation, border compare and bit-plane pack in its
  epilogue; the pre-activation ``z`` never reaches device memory;
* residuals: the packed codes (``bits / 8`` bytes per element of ``z``),
  the weight, and either the exact input or, with a sketch configured,
  only its sketch ``(k, K)`` (any kind of
  :data:`fewbit_tpu_torch.functional.linear.MATMUL_KINDS`);
* backward: ``dz = levels[codes] * g`` (kernel 5,
  :func:`fewbit_tpu_torch.ops.kernels.fused_backward`), then
  ``dx = dz @ w^T``, ``dW = sk(x)^T sk(dz)`` (its real part; or exactly
  ``x^T dz``) and ``db = sum dz`` as plain products.

The sketches are ``_sketch``'s, as in the JAX package: the countsketch on
the plain stride partition with its signs, the other kinds from the draws
of the key, replayed in the backward.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from fewbit_tpu_torch.functional.activations import resolve_activation
from fewbit_tpu_torch.functional.linear import (_projection_key, _sketch,
                                                _validate_grp, _weight_grad)
from fewbit_tpu_torch.ops import kernels as K

__all__ = ("fewbit_dense_act",)


@dataclasses.dataclass(frozen=True)
class _FusedConfig:
    spec: object               # ActivationSpec
    grp: Optional[object]      # the sketch's _GRPConfig; None = exact dW
    has_bias: bool


class _DenseAct(torch.autograd.Function):

    @staticmethod
    def forward(ctx, cfg: _FusedConfig, x, w, b, key, borders, levels):
        spec = cfg.spec
        x2 = x.reshape(-1, x.shape[-1])
        kdim = x2.shape[1]
        m = w.shape[1]
        fwd = (K.fused_dense_act if K.dense_act_ok(spec, kdim, m, x.dtype)
               else K.dense_act_plain)
        y2, packed = fwd(spec, x2.contiguous(), w, b, borders)
        x_saved = (x2 if cfg.grp is None else
                   _sketch(cfg.grp, key, x2, normalise=True))
        ctx.cfg = cfg
        # A countsketch's signs are saved; other kinds' draws ride on ctx.
        sigma = key if isinstance(key, torch.Tensor) else None
        ctx.draws = None if sigma is not None else key
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
        dz_proj = dz
        if cfg.grp is not None:
            key = sigma if sigma is not None else ctx.draws.replay()
            dz_proj = _sketch(cfg.grp, key, dz, normalise=False)
        dw = _weight_grad(x_saved, dz_proj, w.dtype)
        db = dz.sum(0) if cfg.has_bias else None
        return (None, dx.reshape(*g.shape[:-1], kdim).to(g.dtype),
                dw, db, None, None, None)


def fewbit_dense_act(x: torch.Tensor,
                     w: torch.Tensor,
                     b: Optional[torch.Tensor] = None,
                     key=None,
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
    ``proj_dim*`` setting, a sketched weight gradient.

    :param x: ``(..., K)`` input.
    :param w: the logical ``(K, M)`` weight (flax orientation; a torch
        ``(out, in)`` weight passes as ``weight.t()``).
    :param key: the sketch's ``torch.Generator`` (for ``countsketch`` also
        its ``(prod(x.shape[:-1]),)`` f32 signs), required when a
        ``proj_dim*`` setting is given.
    """
    grp = None
    if proj_dim_ratio is not None or proj_dim is not None:
        if key is None:
            raise ValueError("a sketch key (a torch.Generator, or the signs "
                             "`sigma` of a countsketch) is required for "
                             "sketched gradients")
        grp = _validate_grp(x, proj_dim_ratio, proj_dim, proj_dim_max,
                            proj_dim_min, matmul, None)
        key = _projection_key(matmul, key, x.numel() // x.shape[-1],
                              x.device)
    spec, b_arr, v_arr = resolve_activation(activation, bits=bits,
                                            borders=borders, values=values,
                                            args=act_args, device=x.device)
    cfg = _FusedConfig(spec=spec, grp=grp, has_bias=b is not None)
    return _DenseAct.apply(cfg, x, w, b, key, b_arr, v_arr)
