"""Linear layers with sketched weight gradients, as
``fewbit_tpu/functional/linear.py``.

``linear_grp`` computes the exact forward ``y = x @ W^T + b``; its backward
keeps only a random projection of the input along the flattened batch
axis, ``(k, in)`` instead of ``(N, in)``, redraws the same projection of the
output gradient and estimates ``dW = (P g)^T (P x)``, unbiased because the
forward side carries the factor that makes ``E[P^T P] = I``.

Sketch kinds (``MATMUL_KINDS``):

* ``gaussian``: a dense N(0, 1) projection, scaled ``1 / k``; drawn and
  applied in row chunks of about 32 MiB (:func:`_dense_proj_chunks`), so
  the ``(k, N)`` matrix never exists;
* ``rademacher``: a dense +-0.5 projection, scaled ``4 / k``;
* ``dct`` / ``dft``: the orthonormal transform along the batch axis, ``k``
  of its rows drawn with replacement, scaled ``N / k``; dft's residual is
  complex64 and its gradient side takes the inverse transform;
* ``srht``: random signs, zero rows up to a power of two ``N_p``, the
  orthonormal Walsh-Hadamard transform, ``k`` rows, scaled ``N_p / k``;
* ``countsketch``: a signed bucket sum over a stride partition, with the
  signs ``sigma`` as an argument; inside its envelope (:func:`_fused_cs_keff`,
  a function of shapes alone) forward and backward run kernel 1,
  :func:`fewbit_tpu_torch.ops.kernels.fused_matmul_input_sketch`.

``linear_crs`` (column-row sampling) keeps ``nopairs`` input feature columns
drawn with replacement, duplicates kept and scatter-added in the backward.

Randomness: the projection's draws come through one small interface,
:class:`Draws` (``normal``, ``bits``, ``rows``, by draw index, and
``replay``).  :class:`GeneratorDraws` takes them from a ``torch.Generator``:
it keeps the generator's state from before the first draw (a few bytes on
the host), and the backward replays that state on a fresh generator, so it
draws exactly the forward's projection while the shared generator moves on
to the next layer's.  The residual holds the sketch, the weight and the
draws, never ``x`` and never a ``(k, N)`` matrix.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as TF

from fewbit_tpu_torch.fft import dct, fwht
from fewbit_tpu_torch.ops import kernels as K

__all__ = ("linear", "linear_crs", "linear_grp", "linear_grp_native",
           "linear_randomized", "calc_proj_dim", "MATMUL_KINDS")

MATMUL_KINDS = ("gaussian", "rademacher", "dct", "dft", "countsketch",
                "srht")


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


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact ``x @ W^T + b`` with a torch-style ``(out, in)`` weight."""
    return TF.linear(x, weight, bias)


@dataclasses.dataclass(frozen=True)
class _GRPConfig:
    proj_features: int
    matmul: str
    has_bias: bool


# ---------------------------------------------------------------------------
# Randomness.
# ---------------------------------------------------------------------------


class Draws:
    """The random draws of one projection.  ``i`` names the draw within it
    (None: the projection's own key; the JAX package folds ``i`` into its
    key).  Every method returns a tensor on the caller's choice of device
    via ``.to``."""

    def normal(self, i, shape, dtype) -> torch.Tensor:
        raise NotImplementedError

    def bits(self, i, shape) -> torch.Tensor:
        """Fair coin flips, bool."""
        raise NotImplementedError

    def rows(self, i, k: int, high: int) -> torch.Tensor:
        """``k`` indices in ``[0, high)``, drawn with replacement."""
        raise NotImplementedError

    def replay(self) -> "Draws":
        """Draws equal to these, from the first again (the backward's)."""
        raise NotImplementedError


class GeneratorDraws(Draws):
    """Draws taken in order from a ``torch.Generator`` (``i`` is not read:
    forward and backward make the same calls in the same order)."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.state = generator.get_state()

    def normal(self, i, shape, dtype):
        return torch.randn(shape, generator=self.generator, dtype=dtype,
                           device=self.generator.device)

    def bits(self, i, shape):
        # draw_signs' call: countsketch signs are the same either way.
        return torch.randint(0, 2, shape, generator=self.generator,
                             device=self.generator.device).bool()

    def rows(self, i, k, high):
        return torch.randint(0, high, (k,), generator=self.generator,
                             device=self.generator.device)

    def replay(self):
        gen = torch.Generator(device=self.generator.device)
        gen.set_state(self.state)
        return GeneratorDraws(gen)


def draw_signs(generator: torch.Generator, n: int, device) -> torch.Tensor:
    """``(n,)`` f32 random signs in {-1, +1}, drawn on the generator's
    device and moved to ``device``."""
    bits = torch.randint(0, 2, (n,), generator=generator,
                         device=generator.device)
    return bits.to(device=device, dtype=torch.float32) * 2.0 - 1.0


def _projection_key(matmul: str, key, n: int, device):
    """What ``_sketch`` takes for ``matmul``: the ``(n,)`` f32 signs of a
    countsketch, the :class:`Draws` of any other kind.  ``key`` is a
    ``torch.Generator``, a :class:`Draws`, or (countsketch) the signs."""
    if isinstance(key, torch.Generator):
        if matmul == "countsketch":
            return draw_signs(key, n, device)
        return GeneratorDraws(key)
    if isinstance(key, Draws):
        if matmul == "countsketch":
            return key.bits(None, (n,)).to(device, torch.float32) * 2.0 - 1.0
        return key
    if matmul == "countsketch" and isinstance(key, torch.Tensor):
        return key
    raise TypeError(f"the {matmul} sketch takes a torch.Generator"
                    + (" or its (N,) signs" if matmul == "countsketch"
                       else "") + f", not {type(key).__name__}")


# ---------------------------------------------------------------------------
# Sketches.
# ---------------------------------------------------------------------------


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


def _dense_proj_chunks(n: int, k: int) -> int:
    """Rows per chunk of a dense projection: each ``(k, chunk)`` block is
    drawn, applied and freed in turn, about 32 MiB at a time."""
    target = (32 << 20) // (4 * max(k, 1))
    return max(256, min(n, target))


def _dense_sketch(draws: Draws, mat: torch.Tensor, k: int,
                  rademacher: bool, scale) -> torch.Tensor:
    """``scale * B @ mat`` for a dense ``(k, N)`` projection ``B``, drawn
    and accumulated in ``mat.dtype`` one row chunk at a time."""
    n, d = mat.shape
    chunk = _dense_proj_chunks(n, k)
    acc = torch.zeros((k, d), dtype=mat.dtype, device=mat.device)
    for idx, start in enumerate(range(0, n, chunk)):
        size = min(chunk, n - start)
        if rademacher:
            block = draws.bits(idx, (k, size)).to(mat.device, mat.dtype) - 0.5
        else:
            block = draws.normal(idx, (k, size), mat.dtype).to(mat.device)
        acc = acc + block @ mat[start:start + size]
    return acc * scale if scale != 1.0 else acc


def _take_rows(t: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    return t.index_select(0, rows.to(t.device))


def _sketch(cfg: _GRPConfig, key, mat: torch.Tensor,
            normalise: bool) -> torch.Tensor:
    """Project ``mat`` of shape ``(N, d)`` down to ``(k, d)`` along the
    batch axis.  ``normalise`` applies the unbiasedness factor (the input
    side); the gradient side takes the raw projection, so their product
    carries it once.  ``key``: the signs of a countsketch, else the
    projection's :class:`Draws`."""
    n = mat.shape[0]
    k = cfg.proj_features
    if cfg.matmul == "gaussian":
        return _dense_sketch(key, mat, k, False, 1.0 / k if normalise else 1.0)
    if cfg.matmul == "rademacher":
        return _dense_sketch(key, mat, k, True, 4.0 / k if normalise else 1.0)
    if cfg.matmul == "countsketch":
        return _countsketch_signed(mat, key, _plain_keff(n, k))
    if cfg.matmul == "srht":
        # E[S^T S] = (k / n_p) I under rows drawn with replacement, and
        # D H^T H D = I: the factor n_p / k makes the estimate unbiased.
        n_p = 1 << (max(n - 1, 1)).bit_length()
        signs = key.bits(0, (n,)).to(mat.device, mat.dtype) * 2.0 - 1.0
        signed = mat * signs[:, None]
        if n_p != n:
            signed = TF.pad(signed, (0, 0, 0, n_p - n))
        out = _take_rows(fwht(signed, norm="ortho"), key.rows(1, k, n_p))
        return out * (n_p / k) if normalise else out
    if cfg.matmul == "dct":
        rows = key.rows(None, k, n)
        out = _take_rows(dct(mat, type=2, axis=0, norm="ortho"), rows)
        return out * (n / k) if normalise else out
    if cfg.matmul == "dft":
        rows = key.rows(None, k, n)
        wide = mat if mat.dtype in (torch.float32, torch.float64) else \
            mat.float()
        if normalise:
            return _take_rows(torch.fft.fft(wide, dim=0, norm="ortho"),
                              rows) * (n / k)
        # The gradient side takes the conjugate spectrum, so that
        # sum_r conj(F g)_r (F x)_r recovers g^T x by Parseval.
        return _take_rows(torch.fft.ifft(wide, dim=0, norm="ortho"), rows)
    raise ValueError(f"unknown matmul kind: {cfg.matmul!r}")


def _weight_grad(sketch: torch.Tensor, g_proj: torch.Tensor,
                 dtype) -> torch.Tensor:
    """``sketch^T @ g_proj`` in the promoted operand type (bf16 operands on
    the bf16 path), its real part when complex, in ``dtype``."""
    dt = torch.promote_types(sketch.dtype, g_proj.dtype)
    out = torch.matmul(sketch.t().to(dt), g_proj.to(dt))
    if out.is_complex():
        out = out.real
    return out.to(dtype)


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
    """Exact ``x @ kernel + b``; the backward keeps ``(sketch, kernel)``
    and the key (countsketch: its signs, saved; else the draws, on
    ``ctx``), never ``x``."""

    @staticmethod
    def forward(ctx, cfg: _GRPConfig, x, kernel, bias, key):
        x2 = x.reshape(-1, x.shape[-1])
        n = x2.shape[0]
        k_eff = _fused_cs_keff(cfg, n, kernel.shape[0], kernel.shape[1],
                               x.dtype)
        if k_eff is not None:
            y2, sketch = K.fused_matmul_input_sketch(
                x2.contiguous(), kernel, bias, key, k_eff)
        else:
            y2 = x2 @ kernel
            if bias is not None:
                y2 = y2 + bias
            sketch = _sketch(cfg, key, x2, normalise=True)
        ctx.cfg = cfg
        ctx.x_shape = x.shape
        if cfg.matmul == "countsketch":
            ctx.save_for_backward(sketch, kernel, key)
        else:
            ctx.draws = key
            ctx.save_for_backward(sketch, kernel)
        return y2.reshape(*x.shape[:-1], kernel.shape[1])

    @staticmethod
    def backward(ctx, g):
        cfg = ctx.cfg
        sketch, kernel = ctx.saved_tensors[:2]
        g2 = g.reshape(-1, g.shape[-1])
        n = g2.shape[0]
        # A countsketch contracts against the forward's sketch: its bucket
        # partition is read off the residual's shape.
        k_eff = sketch.shape[0]
        if _fused_cs_keff(cfg, n, kernel.shape[0], kernel.shape[1],
                          g.dtype) == k_eff:
            out = K.fused_matmul_input_sketch(
                g2.contiguous(), kernel.t(), None, ctx.saved_tensors[2],
                k_eff, want_colsum=cfg.has_bias)
            grad_x2, g_proj = out[0], out[1]
            grad_b = out[2].to(g.dtype) if cfg.has_bias else None
        else:
            grad_x2 = g2 @ kernel.t()
            g_proj = (_countsketch_signed(g2, ctx.saved_tensors[2], k_eff)
                      if cfg.matmul == "countsketch" else
                      _sketch(cfg, ctx.draws.replay(), g2, normalise=False))
            grad_b = g2.sum(0) if cfg.has_bias else None
        grad_k = _weight_grad(sketch, g_proj, kernel.dtype)
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
    ndim = int(np.prod(x.shape[:-1]))
    k = calc_proj_dim(ndim, proj_dim_ratio, proj_dim, proj_dim_max,
                      proj_dim_min)
    return _GRPConfig(proj_features=k, matmul=matmul,
                      has_bias=bias is not None)


def linear_grp_native(x: torch.Tensor,
                      kernel: torch.Tensor,
                      bias: Optional[torch.Tensor],
                      key,
                      proj_dim_ratio: Optional[float] = None,
                      proj_dim: Optional[int] = None,
                      proj_dim_max: Optional[int] = None,
                      proj_dim_min: Optional[int] = None,
                      matmul: str = "gaussian") -> torch.Tensor:
    """Exact linear forward with a sketched weight-gradient backward.

    :param x: input, shape ``(..., in)``.
    :param kernel: the ``(in, out)`` weight (flax orientation; a torch
        ``(out, in)`` weight passes as ``weight.t()``).
    :param key: the ``torch.Generator`` the projection is drawn from (its
        state at the call is kept to redraw it in the backward); for
        ``countsketch`` also its ``(prod(x.shape[:-1]),)`` f32 signs.
    """
    cfg = _validate_grp(x, proj_dim_ratio, proj_dim, proj_dim_max,
                        proj_dim_min, matmul, bias)
    n = x.numel() // x.shape[-1]
    return _LinearGRP.apply(cfg, x, kernel, bias,
                            _projection_key(matmul, key, n, x.device))


def linear_grp(x: torch.Tensor,
               weight: torch.Tensor,
               bias: Optional[torch.Tensor],
               key,
               proj_dim_ratio: Optional[float] = None,
               proj_dim: Optional[int] = None,
               proj_dim_max: Optional[int] = None,
               proj_dim_min: Optional[int] = None,
               matmul: str = "gaussian") -> torch.Tensor:
    """:func:`linear_grp_native` with a torch-style ``(out, in)`` weight."""
    return linear_grp_native(x, weight.t(), bias, key,
                             proj_dim_ratio=proj_dim_ratio,
                             proj_dim=proj_dim, proj_dim_max=proj_dim_max,
                             proj_dim_min=proj_dim_min, matmul=matmul)


linear_randomized = linear_grp


class _LinearCRS(torch.autograd.Function):
    """Exact ``x @ W^T + b``; the backward keeps the sampled columns of
    ``x`` (scaled), their indices and the weight."""

    @staticmethod
    def forward(ctx, nopairs: int, x, weight, bias, cols):
        in_features = weight.shape[-1]
        x2 = x.reshape(-1, in_features)
        # Duplicates kept; each sampled column carries 1 / (p nopairs),
        # p = 1 / in_features, applied once on the input side.
        x_cols = x2.index_select(1, cols) * (in_features / nopairs)
        ctx.has_bias = bias is not None
        ctx.save_for_backward(x_cols, cols, weight)
        return TF.linear(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x_cols, cols, weight = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        grad_x = (g2 @ weight).reshape(*g.shape[:-1], weight.shape[-1])
        outer = g2.t() @ x_cols                     # (out, nopairs)
        grad_w = torch.zeros_like(weight).index_add_(1, cols,
                                                     outer.to(weight.dtype))
        grad_b = g2.sum(0) if ctx.has_bias else None
        return None, grad_x.to(g.dtype), grad_w, grad_b, None


def linear_crs(x: torch.Tensor,
               weight: torch.Tensor,
               bias: Optional[torch.Tensor],
               key,
               nopairs: int) -> torch.Tensor:
    """Exact linear forward; the backward keeps only ``nopairs`` input
    feature columns, drawn uniformly with replacement from ``key`` (a
    ``torch.Generator`` or :class:`Draws`), for the weight gradient.

    :param weight: torch-style ``(out, in)`` weight.
    """
    if nopairs <= 0:
        raise ValueError("nopairs must be positive")
    draws = _projection_key("crs", key, 0, x.device)
    cols = draws.rows(None, int(nopairs), weight.shape[-1]).to(x.device)
    return _LinearCRS.apply(int(nopairs), x, weight, bias, cols)
