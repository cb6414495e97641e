"""Fully fused memory-efficient FFN block: up projection + few-bit
activation + down projection as ONE ``autograd.Function``, as
``fewbit_tpu/functional/ffn.py``.

* forward (kernel 2, :func:`fewbit_tpu_torch.ops.kernels.
  fused_dense_act_sketch`): ``y = act(x @ w_up + b_up)`` with the
  pre-activation never reaching device memory, emitting the packed few-bit
  codes and ``countsketch(y)``, the down projection's weight-gradient
  residual;
* backward (kernel 3, :func:`fewbit_tpu_torch.ops.kernels.
  fused_matmul_lut_backward`): ``dz = levels[codes] * (g @ w_down^T)``,
  ``countsketch(dz)`` for the up projection's weight gradient, and
  ``db_up = sum dz``.

Residuals for the whole block: ``countsketch(x)``, the packed codes
(``bits / 8`` bytes per pre-activation element), ``countsketch(y)``, the
two weights and the two sign vectors: no (N, M) or (N, K) tensor survives
the forward.  Estimators: ``dW_up = sk(x)^T sk(dz)`` with the up signs,
``dW_down = sk(y)^T sk(g)`` with the down signs.

The signs are arguments (``sigma_up``, ``sigma_down``); the JAX package
derives them from two folds of one key.  f32 models compute and store y
and dz in f32; storing them in bf16 on f32 models, as the TPU path does,
is left to a later measurement (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from fewbit_tpu_torch.functional.activations import resolve_activation
from fewbit_tpu_torch.functional.linear import (_countsketch_partition,
                                                _countsketch_signed,
                                                _dot_acc_f32, calc_proj_dim)
from fewbit_tpu_torch.ops import kernels as K
from fewbit_tpu_torch.ops.activations import (apply_lut, compare_codes,
                                              spec_args)
from fewbit_tpu_torch.ops.bitpack import pack_codes, unpack_codes

__all__ = ("fewbit_ffn",)


@dataclasses.dataclass(frozen=True)
class _FFNConfig:
    spec: object      # ActivationSpec
    k_proj: int       # requested sketch dimension
    has_b_up: bool
    has_b_down: bool


def _keff(n: int, k: int) -> int:
    """Bucket count shared by the plain and kernel paths: kernel-aligned
    when possible so that both produce identical sketches."""
    aligned = K.countsketch_aligned_keff(n, k)
    if aligned is not None:
        return aligned
    part = _countsketch_partition(n, k)
    return part[1] if part is not None else min(k, n)


def _kernel_ok(cfg: _FFNConfig, n: int, kdim: int, m: int, h: int,
               dtype) -> bool:
    """Whether kernels 2 and 3 take this block, by the JAX package's rule
    (``_pallas_ok``): a function of the spec, shapes and dtype alone, so
    forward and backward agree."""
    spec = cfg.spec
    if dtype not in (torch.float32, torch.bfloat16):
        return False
    if spec.bits > 6 or spec.code == "stepwise":
        return False
    if spec.n_borders > 0 and spec.codes is not compare_codes:
        return False
    if n % K.FFN_BN or m % K.FFN_BM or kdim % 128 or h % 128:
        return False
    return K.countsketch_aligned_keff(n, cfg.k_proj) is not None


class _FFN(torch.autograd.Function):

    @staticmethod
    def forward(ctx, cfg: _FFNConfig, x, w_up, b_up, w_down, b_down,
                sig_up, sig_down, borders, levels):
        spec = cfg.spec
        x2 = x.reshape(-1, x.shape[-1])
        n, kdim = x2.shape
        m, h = w_up.shape[1], w_down.shape[1]
        k_eff = _keff(n, cfg.k_proj)
        if _kernel_ok(cfg, n, kdim, m, h, x.dtype):
            y2, packed, sk_y = K.fused_dense_act_sketch(
                spec, x2.contiguous(), w_up, b_up, borders, sig_down, k_eff)
        else:
            z = _dot_acc_f32(x2, w_up)
            if b_up is not None:
                z = z + b_up
            args = spec_args(spec, torch.float32)
            packed = pack_codes(spec.codes(z, borders, args), spec.bits)
            y2 = spec.fwd(z, args).to(x.dtype)
            sk_y = _countsketch_signed(y2, sig_down, k_eff)
        sk_x = _countsketch_signed(x2, sig_up, k_eff)

        out = _dot_acc_f32(y2, w_down.to(y2.dtype))
        if b_down is not None:
            out = out + b_down
        ctx.cfg = cfg
        ctx.x_shape = x.shape
        ctx.save_for_backward(packed, sk_x, sk_y, w_up, w_down, sig_up,
                              sig_down, levels)
        return out.reshape(*x.shape[:-1], h).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        cfg = ctx.cfg
        spec = cfg.spec
        (packed, sk_x, sk_y, w_up, w_down, sig_up, sig_down,
         levels) = ctx.saved_tensors
        kdim, m = w_up.shape
        h = w_down.shape[1]
        g2 = g.reshape(-1, h)
        n = g2.shape[0]
        k_eff = sk_x.shape[0]

        db_down = g2.sum(0) if cfg.has_b_down else None
        sk_g = _countsketch_signed(g2, sig_down, k_eff)
        dw_down = _dot_acc_f32(sk_y.t(), sk_g).to(w_down.dtype)

        if _kernel_ok(cfg, n, kdim, m, h, g2.dtype):
            dz, sk_dz, db_up = K.fused_matmul_lut_backward(
                spec, packed, levels, g2.contiguous(), w_down.t(), sig_up,
                k_eff)
        else:
            codes = unpack_codes(packed, spec.bits, n)
            dz32 = apply_lut(codes, levels, spec.bits) * _dot_acc_f32(
                g2, w_down.t().to(g2.dtype))
            # Storage follows the MODEL dtype so that both paths agree.
            sk_dz = _countsketch_signed(dz32, sig_up, k_eff,
                                        out_dtype=K.sketch_dtype(g2.dtype))
            db_up = dz32.sum(0)
            dz = dz32.to(g2.dtype)

        dw_up = _dot_acc_f32(sk_x.t(), sk_dz).to(w_up.dtype)
        dx = _dot_acc_f32(dz, w_up.t().to(dz.dtype))
        dx = dx.reshape(ctx.x_shape).to(g.dtype)
        db_up = db_up.to(w_up.dtype) if cfg.has_b_up else None
        return (None, dx, dw_up, db_up, dw_down, db_down, None, None, None,
                None)


def fewbit_ffn(x: torch.Tensor,
               w_up: torch.Tensor,
               b_up: Optional[torch.Tensor],
               w_down: torch.Tensor,
               b_down: Optional[torch.Tensor],
               sigma_up: torch.Tensor,
               sigma_down: torch.Tensor,
               activation: str = "gelu",
               bits: Optional[int] = None,
               act_args: tuple = (),
               borders=None,
               values=None,
               proj_dim_ratio: Optional[float] = None,
               proj_dim: Optional[int] = None,
               proj_dim_min: Optional[int] = None,
               proj_dim_max: Optional[int] = None) -> torch.Tensor:
    """``act(x @ w_up + b_up) @ w_down + b_down`` with few-bit and
    countsketched residuals for the whole block.

    :param x: ``(..., K)`` input.
    :param w_up: logical ``(K, M)`` kernel; :param w_down: logical
        ``(M, H)`` kernel (flax orientation; torch ``(out, in)`` weights
        pass as ``weight.t()``).
    :param sigma_up: ``(N,)`` f32 signs of the up projection's sketches
        (``x`` and ``dz``); :param sigma_down: those of the down projection
        (``y`` and ``g``); ``N = prod(x.shape[:-1])``.
    :param proj_dim_ratio: sketch size as a fraction of the flattened batch
        (the kernel path may round the bucket count UP, never down).
    """
    spec, b_arr, v_arr = resolve_activation(activation, bits=bits,
                                            borders=borders, values=values,
                                            args=act_args, device=x.device)
    if proj_dim_ratio is None and proj_dim is None:
        raise ValueError("fewbit_ffn requires proj_dim or proj_dim_ratio")
    ndim = int(np.prod(x.shape[:-1]))
    k = calc_proj_dim(ndim, proj_dim_ratio, proj_dim, proj_dim_max,
                      proj_dim_min)
    cfg = _FFNConfig(spec=spec, k_proj=k, has_b_up=b_up is not None,
                     has_b_down=b_down is not None)
    return _FFN.apply(cfg, x, w_up, b_up, w_down, b_down, sigma_up,
                      sigma_down, b_arr, v_arr)
