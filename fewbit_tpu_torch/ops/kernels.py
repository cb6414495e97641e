"""The CUDA kernels of the few-bit training steps, their plain PyTorch
versions, their envelopes and their launch counters: the counterpart of
``fewbit_tpu/ops/pallas_kernels.py`` and of JAX's Pallas TPU flash
attention (F1-F3; plain versions in :mod:`fewbit_tpu_torch.ops.
flash_attention`).

Each wrapper takes the plain version only for a tensor that lies on the
CPU.  For a CUDA tensor it checks device, dtype, shape, contiguity and the
envelope, raises on anything its kernel does not take, allocates the
outputs, launches on the current stream, raises on a CUDA error, and adds
one to its ``launches`` count.  The callers in :mod:`fewbit_tpu_torch.
functional` decide, from shapes alone, whether a call is inside the
envelope, exactly where the JAX package decides between its Pallas and jnp
paths.

Numerics: the kernels multiply f32 operands in f32 (kernels 1, 2, 2', 3 and
6 as three TF32 products on the tensor cores, hi hi + hi lo + lo hi, which
keep f32 accuracy) and bf16 operands with f32 accumulation, and every sketch
accumulates in f32 and is stored in :func:`sketch_dtype`.  The plain
versions compute the same function: the product of the f32-widened
operands, the epilogue on the f32 result.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from fewbit_tpu_torch.ops.activations import (ACT_IDS, apply_lut,
                                              compare_codes, kernel_args,
                                              spec_args)
from fewbit_tpu_torch.ops.bitpack import (packed_shape, pack_codes,
                                          unpack_codes)
from fewbit_tpu_torch.ops.flash_attention import (flash_backward_dkv_plain,
                                                  flash_backward_dq_plain,
                                                  flash_forward_plain)

__all__ = ("FFN_BN", "FFN_BM", "ACT_IDS", "sketch_dtype",
           "countsketch_aligned_keff", "countsketch_signed",
           "matmul_sketch_keff", "matmul_sketch_route", "ffn_gemm_route",
           "dense_act_sketch_x_route", "act_kernel_ok",
           "dense_act_ok", "DENSE_ACT_SCHEDULES", "dense_act_kloop_route",
           "dense_act_direct_route", "dense_act_emit_route",
           "dense_act_pipelined_route", "dense_act_schedule",
           "PIPELINED_MIN_TILES",
           "dense_act_kloop", "dense_act_direct", "dense_act_emit",
           "dense_act_pipelined", "dense_act_simt",
           "fused_matmul_input_sketch", "input_sketch",
           "fused_dense_act_sketch", "fused_dense_act_sketch_x",
           "dense_act_sketch_x_simt", "fused_matmul_lut_backward",
           "fused_forward", "fused_backward", "fused_dense_act",
           "flash_forward", "flash_backward_dkv", "flash_backward_dq",
           "flash_forward_simt", "flash_backward_dkv_simt",
           "flash_backward_dq_simt",
           "flash_backward_envelope", "flash_instance",
           "FLASH_HEAD_DIMS", "FLASH_INSTANCES", "matmul_input_sketch_plain",
           "input_sketch_plain", "dense_act_sketch_plain",
           "dense_act_sketch_x_plain",
           "matmul_lut_backward_plain", "act_forward_plain",
           "act_backward_plain", "dense_act_plain", "launch_counts",
           "reset_launch_counts", "KERNELS")

FFN_BN = 512  # row granularity of the sketch partition (k_eff % FFN_BN)
FFN_BM = 512  # column granularity of the FFN kernels' envelope

_DTYPES = (torch.float32, torch.bfloat16)


class ActArgs(ctypes.Structure):
    """What a kernel reads of an activation spec: ``ActArgs`` of
    ``csrc/common.cuh``, filled by :func:`fewbit_tpu_torch.ops.activations.
    kernel_args` and handed to an entry point by address."""

    _fields_ = [("act", ctypes.c_int), ("kind", ctypes.c_int),
                ("a0", ctypes.c_float), ("a1", ctypes.c_float),
                ("lo", ctypes.c_float), ("hi", ctypes.c_float),
                ("pred_abs", ctypes.c_int), ("shift", ctypes.c_float),
                ("parity", ctypes.c_int)]


@functools.lru_cache(maxsize=256)
def _act_args(spec, dtype) -> ActArgs:
    return ActArgs(*kernel_args(spec, dtype))


def sketch_dtype(dtype) -> torch.dtype:
    """Storage dtype for countsketch residuals, keyed on the MODEL dtype:
    bf16 models store bf16 sketches, f32 models f32.  Accumulation is f32
    wherever an accumulator exists."""
    return torch.bfloat16 if dtype == torch.bfloat16 else torch.float32


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def countsketch_aligned_keff(n: int, k: int) -> Optional[int]:
    """Bucket count for the kernel-fused countsketch: the smallest multiple
    of FFN_BN that divides ``n`` and is >= ``k``, within a 2x bucket
    budget; None when there is none (the caller takes the plain sketch)."""
    if n % FFN_BN:
        return None
    k_eff = max(FFN_BN, _cdiv(k, FFN_BN) * FFN_BN)
    while k_eff <= 2 * k:
        if n % k_eff == 0:
            return k_eff if k_eff <= n else None
        k_eff += FFN_BN
    return None


@functools.lru_cache(maxsize=None)
def matmul_sketch_keff(n: int, kdim: int, m: int, k: int,
                       dtype) -> Optional[int]:
    """Envelope of :func:`fused_matmul_input_sketch`: the aligned bucket
    count, or None when the caller must take the plain path.

    The width cap (<= 1024) and the fast-memory estimate below are the JAX
    package's findings for its own kernel, kept so that the port takes the
    same paths as the reference; both wait for a measurement on this
    card's kernels (ROADMAP)."""
    if dtype not in _DTYPES:
        return None
    if n % FFN_BN or kdim % 128 or m % 128 or kdim > 1024 or m > 1024:
        return None
    k_eff = countsketch_aligned_keff(n, k)
    if k_eff is None or k_eff > n // 2:
        return None
    est = (2 * FFN_BN * kdim * 2 + kdim * m * 2 + 2 * FFN_BN * m * 4
           + FFN_BN * kdim * 4 + FFN_BN * kdim * 4)
    if est > 56 * 1024 * 1024:
        return None
    return k_eff


# Kernel 1's GEMM (csrc/matmul_input_sketch.cu): 128-row block tiles (and
# as many buckets per column-sum partial on both routes), a 4-stage TMA
# ring, the tile widths it is built for in order of preference, and the
# shared memory a block may take.  The GPU tests hold _k1_smem and the
# limit against the source's own k1_smem (fewbit_matmul_sketch_smem).
K1_BM, K1_STAGES, K1_TILE_N = 128, 4, (96, 64)
K1_SMEM_LIMIT = 232448


def _k1_smem(dtype, bn: int, kdim: int, m: int, fused: bool) -> int:
    """Dynamic shared memory of kernel 1's GEMM block, as ``k1_smem`` in
    the source: the ring (128-byte rows of A and of B, B split in two for
    f32), with the fused sketch the f32 accumulators of the block's sketch
    slice (128 rows) and of its column sums (one row per sketch-read row
    group), the barriers and 1024 bytes of alignment slack."""
    parts, groups = (2, 4) if dtype == torch.float32 else (1, 2)
    kcp = _cdiv(kdim, m // bn) if fused else 0
    return (K1_STAGES * (K1_BM + parts * bn) * 128
            + (K1_BM + 2 * groups) * kcp * 4 + 2 * K1_STAGES * 8 + 1024)


@functools.lru_cache(maxsize=None)
def matmul_sketch_route(kdim: int, m: int, dtype) -> tuple:
    """Kernel 1's plan for a call inside :func:`matmul_sketch_keff`:
    ``(fused, bn)``.

    ``bn``, the column-tile width: 96 where it divides M (at 768 -> 768
    with k_eff 2048, 16 slabs x 8 column tiles = 128 blocks on 132 SMs),
    otherwise 64.  ``fused``: the sketch and column sum come from the
    GEMM's own read of x, each block keeping an f32 slice of
    ``ceil(K / (M / bn))`` sketch columns in shared memory; where that
    slice does not fit at 96, 64 is tried, and where it fits at neither, a
    separate sketch pass reads x again.  A function of the shapes alone,
    never of a failed launch."""
    widths = [bn for bn in K1_TILE_N if m % bn == 0]
    for bn in widths:
        if _k1_smem(dtype, bn, kdim, m, True) <= K1_SMEM_LIMIT:
            return True, bn
    return False, widths[0]


# The GEMM of kernels 2 and 3 (csrc/ffn_gemm.cuh): 128-bucket block tiles,
# a 4-stage TMA ring, and the tile widths it is built for in order of
# preference.  The GPU tests hold _ffn_smem against the source's own
# fg_smem (fewbit_ffn_gemm_smem).
FG_BM, FG_STAGES, FG_TILE_N = 128, 4, (96, 64)
FG_SMEM_LIMIT = K1_SMEM_LIMIT


def _ffn_smem(dtype, bn: int) -> int:
    """Dynamic shared memory of a block of kernels 2 and 3, as ``fg_smem``
    in the source: the ring (128-byte rows of A and of B, B split in two
    for f32), the f32 sketch accumulators of the 256 consumer threads
    (``bn / 2`` each), one db row per consumer warp, the 64-entry borders
    or levels table, the barriers and 1024 bytes of alignment slack."""
    parts = 2 if dtype == torch.float32 else 1
    return (FG_STAGES * (FG_BM + parts * bn) * 128 + (bn // 2) * 256 * 4
            + 8 * bn * 4 + 64 * 4 + 2 * FG_STAGES * 8 + 1024)


@functools.lru_cache(maxsize=None)
def ffn_gemm_route(m: int, dtype) -> int:
    """The column-tile width of kernels 2 and 3 for an ``M`` inside their
    envelope: 96 where it divides M (M = 3072 with k_eff 2048: 32 column
    tiles x 16 bucket tiles = 512 blocks, 3.9 waves on 132 SMs), otherwise
    64 (M = 512).  A function of the shapes alone, never of a failed
    launch; every width it returns fits the block's shared memory."""
    for bn in FG_TILE_N:
        if m % bn == 0 and _ffn_smem(dtype, bn) <= FG_SMEM_LIMIT:
            return bn
    raise ValueError(f"M={m}: no tile width of {FG_TILE_N} divides it")


def _sketch_x_smem(dtype, bn: int, kdim: int, m: int) -> int:
    """Dynamic shared memory of a block of kernel 2', as ``sketch_x_smem``
    in the source: kernel 2's (:func:`_ffn_smem`) and the f32 slice of the
    x sketch that the block owns, 128 buckets of ``ceil(K / (M / bn))``
    columns."""
    return _ffn_smem(dtype, bn) + FG_BM * _cdiv(kdim, m // bn) * 4


@functools.lru_cache(maxsize=None)
def dense_act_sketch_x_route(kdim: int, m: int, dtype) -> tuple:
    """Kernel 2''s plan for a call inside kernel 2's envelope:
    ``(fused, bn)``.  ``fused``: the sketch of x comes from the kernel's
    own read of x (the slice of kernel 1's design beside kernel 2's block),
    at the first tile width of 96, 64 that divides M and leaves room for
    the slice (f32 at 768 -> 3072: 217,408 + 12,288 of 232,448 bytes);
    where it fits at neither, kernel 2 at :func:`ffn_gemm_route`'s width
    and then :func:`input_sketch`, the separate pass.  A function of the
    shapes alone, never of a failed launch."""
    for bn in FG_TILE_N:
        if (m % bn == 0
                and _sketch_x_smem(dtype, bn, kdim, m) <= FG_SMEM_LIMIT):
            return True, bn
    return False, ffn_gemm_route(m, dtype)


def _act_spec_in(spec, stepwise: bool = True) -> bool:
    """Whether the kernels compute ``spec``, by the JAX package's rule
    (``_eligible``): at most 6 bits, and border codes by
    ``compare_codes``, a piecewise function's predicate, or (kernels 4
    and 5) ``stepwise``'s codes; an activation with a kernel id.  A spec
    over 6 bits (a stepwise LUT of more than 64 levels) takes the plain
    path."""
    if spec.name not in ACT_IDS or not 1 <= spec.bits <= 6:
        return False
    if spec.code == "borders":
        return spec.codes is compare_codes
    if spec.code == "predicate":
        return spec.n_borders == 0
    return stepwise and spec.code == "stepwise"


def act_kernel_ok(spec, c: int, dtype) -> bool:
    """Where the callers take kernels 4 and 5 on an ``(R, C)`` view: C a
    multiple of 128, f32 or bf16, as ``_eligible`` in the JAX package.
    Kernel 4's wrapper itself takes any C."""
    return dtype in _DTYPES and c % 128 == 0 and _act_spec_in(spec)


def dense_act_ok(spec, kdim: int, m: int, dtype) -> bool:
    """Envelope of kernel 6: K and M multiples of 128, f32 or bf16; any N
    (ragged rows are masked); any spec of :func:`act_kernel_ok` but
    ``stepwise``, which no name resolves to (``resolve_activation``
    raises for it)."""
    return (dtype in _DTYPES and kdim % 128 == 0 and m % 128 == 0
            and _act_spec_in(spec, stepwise=False))


# Kernel 6 on the tensor cores: four schedules of one function
# (csrc/dense_act.cu, dense_act_direct.cu, dense_act_pipelined.cu), the
# counterparts of the four variants of the JAX package's
# tools/exp_megakernel.py.  Each takes any N, K and M multiples of 128 and
# the tile widths of FG_TILE_N; the direct and the emit schedule also need
# their weight panel to fit in shared memory.
DENSE_ACT_SCHEDULES = ("kloop", "direct", "emit", "pipelined")
PP_BM = 64  # rows of a tile of the pipelined schedule: one warpgroup's


def _out_dtype_ok(dtype, out_dtype) -> bool:
    """The type pairs of kernel 6's schedules: f32 -> f32, bf16 -> bf16 and
    bf16 -> f32."""
    return (dtype in _DTYPES and out_dtype in _DTYPES
            and (out_dtype == dtype or dtype == torch.bfloat16))


def _dense_act_resident_smem(dtype, out_dtype, kdim: int, bn: int,
                             tma_store: bool) -> int:
    """Dynamic shared memory of a block of the direct and the emit
    schedule, as ``da_resident_smem`` in the source: the ring of x tiles,
    the K x bn weight panel (f32: its two TF32 halves), with ``tma_store``
    the two staged tiles of y, the table, the barriers and 1024 bytes of
    alignment slack."""
    parts, elem = (2, 4) if dtype == torch.float32 else (1, 2)
    out = 4 if out_dtype == torch.float32 else 2
    return (FG_STAGES * FG_BM * 128 + parts * bn * kdim * elem
            + (2 * FG_BM * bn * out if tma_store else 0) + 64 * 4
            + (2 * FG_STAGES + 1) * 8 + 1024)


def _dense_act_pipelined_smem(dtype, bn: int) -> int:
    """Dynamic shared memory of a block of the pipelined schedule, as
    ``pp_smem`` in the source: the ring (64 rows of x and bn of w, for f32
    twice), the table, the barriers and the alignment slack."""
    parts = 2 if dtype == torch.float32 else 1
    return (FG_STAGES * (PP_BM + parts * bn) * 128 + 64 * 4
            + 2 * FG_STAGES * 8 + 1024)


def dense_act_kloop_route(m: int, dtype) -> int:
    """The k loop's tile width: kernel 2's (:func:`ffn_gemm_route`), 96
    where it divides M, else 64, which divides every M of kernel 6's
    envelope."""
    return ffn_gemm_route(m, dtype)


def _resident_route(kdim: int, m: int, dtype, out_dtype,
                    tma_store: bool) -> Optional[int]:
    out_dtype = dtype if out_dtype is None else out_dtype
    if not _out_dtype_ok(dtype, out_dtype) or kdim > 16384:
        return None
    for bn in FG_TILE_N:
        if (m % bn == 0 and _dense_act_resident_smem(
                dtype, out_dtype, kdim, bn, tma_store) <= FG_SMEM_LIMIT):
            return bn
    return None


@functools.lru_cache(maxsize=None)
def dense_act_direct_route(kdim: int, m: int, dtype,
                           out_dtype=None) -> Optional[int]:
    """Envelope of the direct schedule inside kernel 6's: the widest tile
    width that divides M and whose K x bn weight panel fits in shared
    memory beside the ring, or None where none does (f32, whose panel has
    two halves, from K = 512 on).  A function of shapes and types alone,
    never of a failed launch."""
    return _resident_route(kdim, m, dtype, out_dtype, False)


@functools.lru_cache(maxsize=None)
def dense_act_emit_route(kdim: int, m: int, dtype,
                         out_dtype=None) -> Optional[int]:
    """Envelope of the emit schedule: as :func:`dense_act_direct_route`,
    with the two staged tiles of y beside the panel."""
    return _resident_route(kdim, m, dtype, out_dtype, True)


@functools.lru_cache(maxsize=None)
def dense_act_pipelined_route(m: int, dtype) -> int:
    """The pipelined schedule's tile width: 96 where it divides M, else
    64; its block fits at either."""
    for bn in FG_TILE_N:
        if m % bn == 0 and _dense_act_pipelined_smem(dtype,
                                                     bn) <= FG_SMEM_LIMIT:
            return bn
    raise ValueError(f"M={m}: no tile width of {FG_TILE_N} divides it")


# From this many 64 x bn tiles on, some 15 per SM of an H100, the pipelined
# schedule beats the k loop in bf16 by 4-8% (8192 x 768 -> 3072: 0.245
# against 0.262 ms on an H100 SXM at 700 W); below it the two are level.
PIPELINED_MIN_TILES = 2048


def dense_act_schedule(n: int, m: int, dtype) -> str:
    """The schedule :func:`fused_dense_act` launches for a call inside
    :func:`dense_act_ok`, a rule of shapes and dtype alone: the fastest of
    the two that take the whole envelope, as measured on the H100.  The k
    loop, except for bf16 calls of at least ``PIPELINED_MIN_TILES`` tiles,
    where hiding the epilogue (half of the k loop's time in bf16) pays for
    the pipelined schedule's narrower tiles; in f32 it does not."""
    if dtype == torch.bfloat16:
        bn = dense_act_pipelined_route(m, dtype)
        if _cdiv(n, PP_BM) * (m // bn) >= PIPELINED_MIN_TILES:
            return "pipelined"
    return "kloop"


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of the f32-widened operands, in f32."""
    return torch.matmul(a.float(), b.float())


def countsketch_signed(mat: torch.Tensor, sigma: torch.Tensor, k_eff: int,
                       out_dtype=None) -> torch.Tensor:
    """Signed bucket sum ``sk[b] = sum_{r = b mod k_eff} sigma_r mat_r``:
    the stride partition shared by the plain paths and the kernels, so
    sketches from any path contract bucket for bucket.  Rows are cast to
    the storage dtype (:func:`sketch_dtype` of ``mat`` unless given),
    summed in f32, and stored."""
    n, d = mat.shape
    if out_dtype is None:
        out_dtype = sketch_dtype(mat.dtype)
    signed = mat.to(out_dtype) * sigma.to(out_dtype)[:, None]
    if k_eff >= n:
        return signed
    block = n // k_eff
    main = signed[:block * k_eff].reshape(block, k_eff, d).sum(
        0, dtype=torch.float32)
    rem = n - block * k_eff
    if rem:
        main[:rem] += signed[block * k_eff:].float()
    return main.to(out_dtype)


def matmul_input_sketch_plain(x, w, bias, sigma, k_eff: int,
                              want_colsum: bool = False):
    y = dot_f32(x, w)
    if bias is not None:
        y = y + bias.float()
    sk = countsketch_signed(x, sigma, k_eff)
    if want_colsum:
        return y.to(x.dtype), sk, x.float().sum(0)
    return y.to(x.dtype), sk


def input_sketch_plain(x, sigma, k_eff: int, want_colsum: bool = False):
    sk = countsketch_signed(x, sigma, k_eff)
    return (sk, x.float().sum(0)) if want_colsum else sk


def dense_act_sketch_plain(spec, x, w, bias, borders, sigma, k_eff: int,
                           sigma_x=None):
    z = dot_f32(x, w)
    if bias is not None:
        z = z + bias.float()
    args = spec_args(spec, torch.float32)
    packed = pack_codes(spec.codes(z, borders, args), spec.bits)
    y = spec.fwd(z, args).to(x.dtype)
    out = (y, packed, countsketch_signed(y, sigma, k_eff))
    if sigma_x is None:
        return out
    return (*out, countsketch_signed(x, sigma_x, k_eff))


def dense_act_sketch_x_plain(spec, x, w, bias, borders, sigma, k_eff: int,
                             sigma_x):
    return dense_act_sketch_plain(spec, x, w, bias, borders, sigma, k_eff,
                                  sigma_x)


def matmul_lut_backward_plain(spec, packed, levels, g, wt, sigma,
                              k_eff: int):
    codes = unpack_codes(packed, spec.bits, g.shape[0])
    dz32 = apply_lut(codes, levels, spec.bits) * dot_f32(g, wt)
    sk = countsketch_signed(dz32, sigma, k_eff, sketch_dtype(g.dtype))
    return dz32.to(g.dtype), sk, dz32.sum(0)


def act_forward_plain(spec, x, borders):
    """Kernel 4's function: the forward and the codes of the f32-widened
    ``x`` with the arguments in x's type (:func:`spec_args`), y stored
    once in x's type."""
    args, xf = spec_args(spec, x.dtype), x.float()
    packed = pack_codes(spec.codes(xf, borders, args), spec.bits)
    return spec.fwd(xf, args).to(x.dtype), packed


def act_backward_plain(spec, packed, levels, g):
    codes = unpack_codes(packed, spec.bits, g.shape[0])
    return (apply_lut(codes, levels, spec.bits) * g.float()).to(g.dtype)


def dense_act_plain(spec, x, w, bias, borders, out_dtype=None,
                    epilogue: bool = True):
    """The plain version of kernel 6 and of all four of its schedules.
    ``out_dtype``: y's type (x's unless given).  Without ``epilogue``, the
    ablation: ``(z, zero words of one plane)``."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    z = dot_f32(x, w)
    if bias is not None:
        z = z + bias.float()
    if not epilogue:
        return z.to(out_dtype), torch.zeros(
            packed_shape(x.shape[0], w.shape[1], 1), dtype=torch.int32,
            device=x.device)
    args = spec_args(spec, torch.float32)
    packed = pack_codes(spec.codes(z, borders, args), spec.bits)
    return spec.fwd(z, args).to(out_dtype), packed


# ---------------------------------------------------------------------------
# Wrapper checks.
# ---------------------------------------------------------------------------


def _lib():
    from fewbit_tpu_torch.ops._build import load_library

    return load_library()


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def _check(name: str, t: torch.Tensor, device, shape, dtype) -> None:
    _require(t.device == device, f"{name} on {t.device}, expected {device}")
    _require(tuple(t.shape) == tuple(shape),
             f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    _require(t.dtype == dtype, f"{name} is {t.dtype}, expected {dtype}")
    _require(t.is_contiguous(), f"{name} is not contiguous")


def _weight(name: str, w: torch.Tensor, device, shape, dtype) -> int:
    """Check a logical (K, M) operand; 1 when it is stored as the
    row-major transpose (a torch (out, in) weight seen through ``.t()``)."""
    if w.is_contiguous():
        trans = 0
    elif w.t().is_contiguous():
        trans = 1
    else:
        raise ValueError(f"{name} is neither row-major nor a transposed "
                         f"row-major tensor")
    _check(name, w if not trans else w.t(), device,
           shape if not trans else shape[::-1], dtype)
    return trans


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(fn_name: str, device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(_lib(), fn_name)(*args, stream)
    if rc < 0:
        raise RuntimeError(f"{fn_name}: refused before launch ({rc}; the "
                           f"codes are listed at its entry point)")
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc} after launch")


def _ffn_spec_ok(spec) -> None:
    _require(_act_spec_in(spec, stepwise=False),
             f"kernel 2 computes an activation with border or predicate "
             f"codes at 1..6 bits, not {spec.name!r} ({spec.code}) at "
             f"{spec.bits} bits")


def _tma_ok(a: torch.Tensor, a_name: str, w: torch.Tensor, w_name: str,
            trans: int) -> None:
    """TMA reads the left operand, and a bf16 ``.t()`` weight in place,
    from 16-byte aligned addresses."""
    _require(a.data_ptr() % 16 == 0
             and (a.dtype == torch.float32 or not trans
                  or w.data_ptr() % 16 == 0),
             f"{a_name} or {w_name} does not start on a 16-byte boundary")


def _weight_scratch(trans: int, m: int, kdim: int, dt, dev):
    """Scratch for the K-major B that the wgmma kernels read: f32 as TF32 hi
    and lo halves, bf16 as the transpose of a row-major weight; None for a
    bf16 ``.t()`` weight, which is K-major as it is."""
    if dt == torch.float32:
        return torch.empty(2, m, kdim, dtype=dt, device=dev)
    if not trans:
        return torch.empty(m, kdim, dtype=dt, device=dev)
    return None


def _outputs(out, specs, dev):
    """The tensors a kernel writes: new ones of ``specs`` (``(name, shape,
    dtype)`` each), or the caller's ``out``, checked against them (a check
    can fill them first and see every element written)."""
    if out is None:
        return [torch.empty(shape, dtype=dt, device=dev)
                for _, shape, dt in specs]
    _require(len(out) == len(specs),
             f"out must hold {[name for name, *_ in specs]}")
    for o, (name, shape, dt) in zip(out, specs):
        _check(f"out {name}", o, dev, shape, dt)
    return list(out)


def _ffn_rows_ok(n: int, m: int, k_eff: int) -> None:
    _require(n % FFN_BN == 0 and m % FFN_BM == 0,
             f"N={n} or M={m} not a multiple of {FFN_BN}")
    _require(k_eff % FFN_BN == 0 and k_eff <= n and n % k_eff == 0,
             f"k_eff={k_eff} is not a multiple of {FFN_BN} dividing N={n}")


# ---------------------------------------------------------------------------
# Kernel 1: matmul + input countsketch (+ column sum).
# ---------------------------------------------------------------------------


def fused_matmul_input_sketch(x: torch.Tensor, w: torch.Tensor,
                              bias: Optional[torch.Tensor],
                              sigma: torch.Tensor, k_eff: int,
                              want_colsum: bool = False, *, out=None):
    """``x @ w (+ b)`` plus the stride-partition countsketch of ``x``
    (``(k_eff, K)``, stored in :func:`sketch_dtype`) and, with
    ``want_colsum``, the f32 column sum of ``x``; written into ``out``
    (the same tuple) where given.

    ``x``: (N, K); ``w``: the logical (K, M) weight, row-major or the
    ``.t()`` of a row-major (M, K) tensor; ``sigma``: (N,) f32 signs.

    On the card the route is :func:`matmul_sketch_route`'s; the kernel
    reads B K-major from scratch (f32: its TF32 halves, 2 M K elements;
    bf16 row-major ``w``: its transpose), written by a prologue kernel.
    """
    if x.device.type == "cpu":
        return _into(out, matmul_input_sketch_plain(x, w, bias, sigma, k_eff,
                                                    want_colsum))
    _require(x.is_cuda, f"x on {x.device}: neither CPU nor CUDA")
    _require(x.ndim == 2 and w.ndim == 2, "x and w must be 2-D")
    n, kdim = x.shape
    m = w.shape[1]
    dev, dt = x.device, x.dtype
    _require(dt in _DTYPES, f"dtype {dt} not in {_DTYPES}")
    _check("x", x, dev, (n, kdim), dt)
    trans = _weight("w", w, dev, (kdim, m), dt)
    if bias is not None:
        _check("bias", bias, dev, (m,), dt)
    _check("sigma", sigma, dev, (n,), torch.float32)
    _require(matmul_sketch_keff(n, kdim, m, k_eff, dt) == k_eff,
             f"(N={n}, K={kdim}, M={m}, k_eff={k_eff}) outside the "
             f"envelope of matmul_sketch_keff")
    _tma_ok(x, "x", w, "w", trans)
    fused, bn = matmul_sketch_route(kdim, m, dt)
    specs = [("y", (n, m), dt), ("sketch", (k_eff, kdim), sketch_dtype(dt))]
    if want_colsum:
        specs.append(("colsum", (kdim,), torch.float32))
    got = _outputs(out, specs, dev)
    y, sk, cs = got + [None] * (3 - len(got))
    cs_partial = None
    w_prep = _weight_scratch(trans, m, kdim, dt, dev)
    if fused and want_colsum:
        cs_partial = torch.empty(k_eff // K1_BM, kdim, dtype=torch.float32,
                                 device=dev)
    _launch("fewbit_matmul_input_sketch", dev, x.data_ptr(), w.data_ptr(),
            trans, _ptr(bias), sigma.data_ptr(), y.data_ptr(),
            _ptr(sk if fused else None), _ptr(w_prep), _ptr(cs_partial),
            _ptr(cs if fused else None), n, kdim, m, k_eff, bn, int(fused),
            int(dt == torch.bfloat16))
    if not fused:
        input_sketch(x, sigma, k_eff, want_colsum,
                     out=(sk, cs) if want_colsum else (sk,))
    fused_matmul_input_sketch.launches += 1
    return (y, sk, cs) if want_colsum else (y, sk)


def input_sketch(x: torch.Tensor, sigma: torch.Tensor, k_eff: int,
                 want_colsum: bool = False, *, out=None):
    """The separate sketch pass of kernels 1 and 2': the stride-partition
    countsketch of ``x`` (``(k_eff, K)``, summed in f32, stored in
    :func:`sketch_dtype`) and, with ``want_colsum``, the f32 column sum of
    ``x``.  Returns ``sketch`` or ``(sketch, colsum)``, written into
    ``out`` (the same, as a tuple) where given.

    On the card one pass over x, each thread owning (bucket, column) pairs
    and summing their rows in pass order: what kernel 1 and kernel 2'
    launch after their GEMM where the sketch's slice does not fit its
    shared memory (:func:`matmul_sketch_route`,
    :func:`dense_act_sketch_x_route`)."""
    if x.device.type == "cpu":
        got = input_sketch_plain(x, sigma, k_eff, want_colsum)
        if out is None:
            return got
        got = _into(out, got if want_colsum else (got,))
        return got if want_colsum else got[0]
    _require(x.is_cuda, f"x on {x.device}: neither CPU nor CUDA")
    _require(x.ndim == 2, "x must be 2-D")
    n, kdim = x.shape
    dev, dt = x.device, x.dtype
    _require(dt in _DTYPES, f"dtype {dt} not in {_DTYPES}")
    _check("x", x, dev, (n, kdim), dt)
    _check("sigma", sigma, dev, (n,), torch.float32)
    _require(k_eff > 0 and k_eff % K1_BM == 0 and n % k_eff == 0,
             f"k_eff={k_eff} is not a multiple of {K1_BM} dividing N={n}")
    specs = [("sketch", (k_eff, kdim), sketch_dtype(dt))]
    if want_colsum:
        specs.append(("colsum", (kdim,), torch.float32))
    got = _outputs(out, specs, dev)
    cs_partial = (torch.empty(k_eff // K1_BM, kdim, dtype=torch.float32,
                              device=dev) if want_colsum else None)
    _launch("fewbit_input_sketch", dev, x.data_ptr(), sigma.data_ptr(),
            got[0].data_ptr(), _ptr(cs_partial),
            got[1].data_ptr() if want_colsum else None, n, kdim, k_eff,
            int(dt == torch.bfloat16))
    input_sketch.launches += 1
    return tuple(got) if want_colsum else got[0]


# ---------------------------------------------------------------------------
# Kernel 2: dense + activation + packed codes + output countsketch.
# ---------------------------------------------------------------------------


def _ffn_forward_args(spec, x, w, bias, borders, sigma, k_eff):
    """The checks kernels 2 and 2' share, on CUDA tensors; returns
    ``(n, kdim, m, dev, dt, trans)``."""
    _require(x.is_cuda, f"x on {x.device}: neither CPU nor CUDA")
    _ffn_spec_ok(spec)
    _require(x.ndim == 2 and w.ndim == 2, "x and w must be 2-D")
    n, kdim = x.shape
    m = w.shape[1]
    dev, dt = x.device, x.dtype
    _require(dt in _DTYPES, f"dtype {dt} not in {_DTYPES}")
    _require(kdim % 128 == 0, f"K={kdim} not a multiple of 128")
    _ffn_rows_ok(n, m, k_eff)
    _check("x", x, dev, (n, kdim), dt)
    trans = _weight("w", w, dev, (kdim, m), dt)
    if bias is not None:
        _check("bias", bias, dev, (m,), dt)
    _check("borders", borders, dev, (spec.n_borders,), torch.float32)
    _check("sigma", sigma, dev, (n,), torch.float32)
    return n, kdim, m, dev, dt, trans


def _ffn_forward_specs(spec, n, kdim, m, k_eff, dt, sketch_x: bool):
    """What kernels 2 and 2' write: y, the packed codes, the sketch of y
    and, for 2', the sketch of x."""
    specs = [("y", (n, m), dt),
             ("packed", packed_shape(n, m, spec.bits), torch.int32),
             ("sketch_y", (k_eff, m), sketch_dtype(dt))]
    if sketch_x:
        specs.append(("sketch_x", (k_eff, kdim), sketch_dtype(dt)))
    return specs


def fused_dense_act_sketch(spec, x: torch.Tensor, w: torch.Tensor,
                           bias: Optional[torch.Tensor],
                           borders: torch.Tensor, sigma: torch.Tensor,
                           k_eff: int, sigma_x: Optional[torch.Tensor] = None,
                           *, out=None):
    """``y = act(x @ w + b)`` with the packed codes of the pre-activation
    (``(bits, N / 32, M)`` int32) and the countsketch of ``y``
    (``(k_eff, M)``).  Returns ``(y, packed, sketch)``.

    On the card the product runs on the tensor cores (TMA ring and wgmma;
    f32 as three TF32 products) at :func:`ffn_gemm_route`'s tile width; the
    kernel reads B K-major from scratch (f32: its TF32 halves, 2 M K
    elements; bf16 row-major ``w``: its transpose), written by a prologue
    kernel.

    With ``sigma_x`` ((N,) f32 signs), kernel 2' (the TPU kernel's
    ``_kernel_skx``): also the countsketch of ``x`` (``(k_eff, K)``,
    summed in f32 over the raw x, stored in :func:`sketch_dtype`), counted
    as ``fused_dense_act_sketch_x``; returns ``(y, packed, sketch_y,
    sketch_x)``.  By :func:`dense_act_sketch_x_route`: from the same
    kernel's own read of x where its block has room for the sketch's
    slice, else kernel 2 and then :func:`input_sketch`.  No model path
    passes it, as in the JAX package.

    ``out``: tensors to write into, as this returns them (a check can fill
    them first and see every element written)."""
    if x.device.type == "cpu":
        return _into(out, dense_act_sketch_plain(spec, x, w, bias, borders,
                                                 sigma, k_eff, sigma_x))
    n, kdim, m, dev, dt, trans = _ffn_forward_args(spec, x, w, bias,
                                                   borders, sigma, k_eff)
    _tma_ok(x, "x", w, "w", trans)
    if sigma_x is None:
        fused, bn = False, ffn_gemm_route(m, dt)
    else:
        _check("sigma_x", sigma_x, dev, (n,), torch.float32)
        fused, bn = dense_act_sketch_x_route(kdim, m, dt)
    got = _outputs(out, _ffn_forward_specs(spec, n, kdim, m, k_eff, dt,
                                           sigma_x is not None), dev)
    w_prep = _weight_scratch(trans, m, kdim, dt, dev)
    _launch("fewbit_dense_act_sketch", dev, x.data_ptr(), w.data_ptr(),
            trans, _ptr(bias), borders.data_ptr(), spec.n_borders,
            ctypes.byref(_act_args(spec, torch.float32)),
            sigma.data_ptr(), *(t.data_ptr() for t in got[:3]),
            _ptr(sigma_x) if fused else None,
            got[3].data_ptr() if fused else None, _ptr(w_prep), n, kdim, m,
            k_eff, spec.bits, bn, int(dt == torch.bfloat16))
    if sigma_x is None:
        fused_dense_act_sketch.launches += 1
        return tuple(got)
    if not fused:
        input_sketch(x, sigma_x, k_eff, out=got[3:])
    fused_dense_act_sketch_x.launches += 1
    return tuple(got)


def fused_dense_act_sketch_x(spec, x, w, bias, borders, sigma, k_eff: int,
                             sigma_x: torch.Tensor, *, out=None):
    """Kernel 2': :func:`fused_dense_act_sketch` with ``sigma_x``."""
    return fused_dense_act_sketch(spec, x, w, bias, borders, sigma, k_eff,
                                  sigma_x, out=out)


def dense_act_sketch_x_simt(spec, x, w, bias, borders, sigma, k_eff: int,
                            sigma_x: torch.Tensor):
    """Kernel 2''s function by the first, CUDA-core kernel (``gemm_tile``,
    the sketch of x summed in a global f32 scratch by the first column
    tile's blocks): what the tensor-core kernel is measured against.  No
    model path runs it."""
    if x.device.type == "cpu":
        return dense_act_sketch_x_plain(spec, x, w, bias, borders, sigma,
                                        k_eff, sigma_x)
    n, kdim, m, dev, dt, trans = _ffn_forward_args(spec, x, w, bias,
                                                   borders, sigma, k_eff)
    _check("sigma_x", sigma_x, dev, (n,), torch.float32)
    got = _outputs(None, _ffn_forward_specs(spec, n, kdim, m, k_eff, dt,
                                            True), dev)
    skx_acc = (got[3] if dt == torch.float32 else
               torch.empty(k_eff, kdim, dtype=torch.float32, device=dev))
    _launch("fewbit_dense_act_sketch_x_simt", dev, x.data_ptr(),
            w.data_ptr(), trans, _ptr(bias), borders.data_ptr(),
            spec.n_borders, ctypes.byref(_act_args(spec, torch.float32)),
            sigma.data_ptr(),
            *(t.data_ptr() for t in got[:3]), sigma_x.data_ptr(),
            skx_acc.data_ptr(),
            None if skx_acc is got[3] else got[3].data_ptr(), n, kdim, m,
            k_eff, spec.bits, int(dt == torch.bfloat16))
    dense_act_sketch_x_simt.launches += 1
    return tuple(got)


# ---------------------------------------------------------------------------
# Kernel 3: matmul + LUT dequant + countsketch + bias gradient.
# ---------------------------------------------------------------------------


def fused_matmul_lut_backward(spec, packed: torch.Tensor,
                              levels: torch.Tensor, g: torch.Tensor,
                              wt: torch.Tensor, sigma: torch.Tensor,
                              k_eff: int, *, out=None):
    """``dz = levels[codes] * (g @ wt)`` with the countsketch of ``dz``
    (``(k_eff, M)``) and ``db = sum_n dz`` in f32.  ``g``: (N, H); ``wt``:
    the logical (H, M) operand (the down projection's weight transposed),
    row-major or the ``.t()`` of a row-major (M, H) tensor.  Returns
    ``(dz, sketch, db)``, written into ``out`` where given.

    On the card the product runs on the tensor cores as kernel 2's does;
    the model's ``wt`` is the row-major (H, M) parameter, which the
    prologue transposes (and for f32 splits) into the K-major scratch."""
    if g.device.type == "cpu":
        return _into(out, matmul_lut_backward_plain(spec, packed, levels, g,
                                                    wt, sigma, k_eff))
    _require(g.is_cuda, f"g on {g.device}: neither CPU nor CUDA")
    _require(1 <= spec.bits <= 6, f"bits={spec.bits} outside 1..6")
    _require(g.ndim == 2 and wt.ndim == 2, "g and wt must be 2-D")
    n, h = g.shape
    m = wt.shape[1]
    dev, dt = g.device, g.dtype
    _require(dt in _DTYPES, f"dtype {dt} not in {_DTYPES}")
    _require(h % 128 == 0, f"H={h} not a multiple of 128")
    _ffn_rows_ok(n, m, k_eff)
    _check("g", g, dev, (n, h), dt)
    trans = _weight("wt", wt, dev, (h, m), dt)
    _check("packed", packed, dev, packed_shape(n, m, spec.bits), torch.int32)
    _check("levels", levels, dev, (1 << spec.bits,), torch.float32)
    _check("sigma", sigma, dev, (n,), torch.float32)
    _tma_ok(g, "g", wt, "wt", trans)
    bn = ffn_gemm_route(m, dt)
    w_prep = _weight_scratch(trans, m, h, dt, dev)
    dz, sk, db = _outputs(out, [("dz", (n, m), dt),
                                ("sketch", (k_eff, m), sketch_dtype(dt)),
                                ("db", (m,), torch.float32)], dev)
    db_partial = torch.empty(k_eff // FG_BM, m, dtype=torch.float32,
                             device=dev)
    _launch("fewbit_matmul_lut_backward", dev, g.data_ptr(), wt.data_ptr(),
            trans, packed.data_ptr(), levels.data_ptr(), spec.bits,
            sigma.data_ptr(), dz.data_ptr(), sk.data_ptr(),
            db_partial.data_ptr(), db.data_ptr(), _ptr(w_prep), n, h, m,
            k_eff, bn, int(dt == torch.bfloat16))
    fused_matmul_lut_backward.launches += 1
    return dz, sk, db


# ---------------------------------------------------------------------------
# Kernel 4: elementwise activation + packed codes.
# ---------------------------------------------------------------------------


def _act_kernel_checks(spec, t: torch.Tensor, what: str,
                       any_width: bool = False) -> None:
    _require(t.is_cuda, f"{what} on {t.device}: neither CPU nor CUDA")
    _require(t.ndim == 2, f"{what} must be 2-D (R, C)")
    c, dt = t.shape[1], t.dtype
    ok = (dt in _DTYPES and _act_spec_in(spec) and c >= 1 if any_width
          else act_kernel_ok(spec, c, dt))
    _require(ok, f"{spec.name} at {spec.bits} bits, C={c}, {dt}: outside "
                 f"the envelope of " + ("kernel 4" if any_width
                                        else "act_kernel_ok"))


def fused_forward(spec, x: torch.Tensor, borders: torch.Tensor, *,
                  out=None):
    """``y = act(x)`` and the packed codes of ``x``
    (``(bits, R / 32, C)`` int32).  ``x``: (R, C), any R and C: the kernel
    moves 16 bytes of a row at a time where C and the addresses allow it,
    one element otherwise.  Returns ``(y, packed)``, written into ``out``
    where given."""
    if x.device.type == "cpu":
        return _into(out, act_forward_plain(spec, x, borders))
    _act_kernel_checks(spec, x, "x", any_width=True)
    r, c = x.shape
    dev = x.device
    _check("x", x, dev, (r, c), x.dtype)
    _check("borders", borders, dev, (spec.n_borders,), torch.float32)
    y, packed = _outputs(out, [("y", (r, c), x.dtype),
                               ("packed", packed_shape(r, c, spec.bits),
                                torch.int32)], dev)
    _launch("fewbit_act_forward", dev, x.data_ptr(), borders.data_ptr(),
            spec.n_borders, ctypes.byref(_act_args(spec, x.dtype)),
            y.data_ptr(),
            packed.data_ptr(), r, c, spec.bits,
            int(x.dtype == torch.bfloat16))
    fused_forward.launches += 1
    return y, packed


# ---------------------------------------------------------------------------
# Kernel 5: unpack + LUT + multiply.
# ---------------------------------------------------------------------------


def fused_backward(spec, packed: torch.Tensor, levels: torch.Tensor,
                   g: torch.Tensor, *, out=None) -> torch.Tensor:
    """``dx = levels[codes] * g`` (f32 product, stored in g's dtype), the
    codes decoded from ``packed`` (``(bits, R / 32, C)`` int32, from kernel
    4, kernel 6 or the plain pack).  ``g``: (R, C).  Written into ``out``
    (a 1-tuple) where given."""
    if g.device.type == "cpu":
        got = act_backward_plain(spec, packed, levels, g)
        return got if out is None else _into(out, (got,))[0]
    _act_kernel_checks(spec, g, "g")
    r, c = g.shape
    dev = g.device
    _check("g", g, dev, (r, c), g.dtype)
    _check("packed", packed, dev, packed_shape(r, c, spec.bits), torch.int32)
    _check("levels", levels, dev, (1 << spec.bits,), torch.float32)
    dx, = _outputs(out, [("dx", (r, c), g.dtype)], dev)
    _launch("fewbit_act_backward", dev, packed.data_ptr(), levels.data_ptr(),
            spec.bits, g.data_ptr(), dx.data_ptr(), r, c,
            int(g.dtype == torch.bfloat16))
    fused_backward.launches += 1
    return dx


# ---------------------------------------------------------------------------
# Kernel 6: dense + activation + packed codes.
# ---------------------------------------------------------------------------


def _dense_act_args(spec, x, w, bias, borders):
    """The checks kernel 6 and its schedules share; returns
    ``(n, kdim, m, dev, dt, trans)``."""
    _require(x.is_cuda, f"x on {x.device}: neither CPU nor CUDA")
    _require(x.ndim == 2 and w.ndim == 2, "x and w must be 2-D")
    n, kdim = x.shape
    m = w.shape[1]
    dev, dt = x.device, x.dtype
    _require(n >= 1, "x has no rows")
    _require(dense_act_ok(spec, kdim, m, dt),
             f"{spec.name} at {spec.bits} bits, K={kdim}, M={m}, {dt}: "
             f"outside the envelope of dense_act_ok")
    _check("x", x, dev, (n, kdim), dt)
    trans = _weight("w", w, dev, (kdim, m), dt)
    if bias is not None:
        _check("bias", bias, dev, (m,), dt)
    _check("borders", borders, dev, (spec.n_borders,), torch.float32)
    return n, kdim, m, dev, dt, trans


def _dense_act_tensor_core(schedule: str, spec, x, w, bias, borders,
                           out_dtype=None, epilogue: bool = True,
                           bn: Optional[int] = None, out=None):
    """Launch one tensor-core schedule of kernel 6 on CUDA tensors; raises
    outside its envelope.  Counts nothing: the public wrappers do."""
    n, kdim, m, dev, dt, trans = _dense_act_args(spec, x, w, bias, borders)
    out_dtype = dt if out_dtype is None else out_dtype
    _require(_out_dtype_ok(dt, out_dtype),
             f"{dt} -> {out_dtype}: the schedules take f32 -> f32, bf16 -> "
             f"bf16 and bf16 -> f32")
    _require(epilogue or schedule == "kloop",
             "only the k loop has the epilogue ablation")
    route = {"kloop": lambda: dense_act_kloop_route(m, dt),
             "direct": lambda: dense_act_direct_route(kdim, m, dt, out_dtype),
             "emit": lambda: dense_act_emit_route(kdim, m, dt, out_dtype),
             "pipelined": lambda: dense_act_pipelined_route(m, dt)}[schedule]()
    _require(route is not None,
             f"K={kdim}, M={m}, {dt} -> {out_dtype}: outside the envelope "
             f"of the {schedule} schedule (its weight panel does not fit)")
    if bn is None:
        bn = route
    else:
        # A narrower tile than the route's, where the schedule is built for
        # it: the route's width is the widest that fits.
        _require(bn in FG_TILE_N and bn <= route and m % bn == 0,
                 f"tile width {bn} outside the {schedule} schedule's "
                 f"envelope at M={m} (its route gives {route})")
    _tma_ok(x, "x", w, "w", trans)
    bits = spec.bits if epilogue else 1
    y, packed = _outputs(out, [("y", (n, m), out_dtype),
                               ("packed", packed_shape(n, m, bits),
                                torch.int32)], dev)
    w_prep = _weight_scratch(trans, m, kdim, dt, dev)
    args = [x.data_ptr(), w.data_ptr(), trans, _ptr(bias),
            borders.data_ptr(), spec.n_borders,
            ctypes.byref(_act_args(spec, torch.float32)), y.data_ptr(),
            packed.data_ptr(), _ptr(w_prep), n, kdim, m, bits,
            bn, int(dt == torch.bfloat16), int(out_dtype == torch.bfloat16)]
    if schedule == "kloop":
        args.append(int(epilogue))
    _launch(f"fewbit_dense_act_{schedule}", dev, *args)
    return y, packed


def dense_act_kloop(spec, x, w, bias, borders, out_dtype=None,
                    epilogue: bool = True):
    """Kernel 6's function by the k loop (the TPU tool's ``make_variant``):
    one block per 128 x bn tile of y, the k tiles through the TMA ring, the
    accumulator carried over them, the epilogue after the last.  Arguments
    as :func:`fused_dense_act`'s; ``out_dtype`` f32 for a bf16 ``x`` gives
    the tool's default rows.  Without ``epilogue``: ``(z, zero words of
    one plane)``, the ablation that measures the epilogue's share."""
    if x.device.type == "cpu":
        return dense_act_plain(spec, x, w, bias, borders, out_dtype,
                               epilogue)
    out = _dense_act_tensor_core("kloop", spec, x, w, bias, borders,
                                 out_dtype, epilogue)
    dense_act_kloop.launches += 1
    return out


def dense_act_direct(spec, x, w, bias, borders, out_dtype=None,
                     bn: Optional[int] = None):
    """Kernel 6's function with the weight panel resident in shared memory
    (the TPU tool's ``make_direct``): a persistent block walks the row
    tiles of its K x bn panel, only x streams.  ``bn``: a panel narrower
    than the route's (the experiment times both).  Raises outside
    :func:`dense_act_direct_route`'s envelope."""
    if x.device.type == "cpu":
        return dense_act_plain(spec, x, w, bias, borders, out_dtype)
    out = _dense_act_tensor_core("direct", spec, x, w, bias, borders,
                                 out_dtype, bn=bn)
    dense_act_direct.launches += 1
    return out


def dense_act_emit(spec, x, w, bias, borders, out_dtype=None,
                   bn: Optional[int] = None):
    """The direct schedule with the output pipelined too (the TPU tool's
    ``make_emit``): y staged in shared memory, written by TMA bulk stores
    under the next tile's product.  Raises outside
    :func:`dense_act_emit_route`'s envelope."""
    if x.device.type == "cpu":
        return dense_act_plain(spec, x, w, bias, borders, out_dtype)
    out = _dense_act_tensor_core("emit", spec, x, w, bias, borders,
                                 out_dtype, bn=bn)
    dense_act_emit.launches += 1
    return out


def dense_act_pipelined(spec, x, w, bias, borders, out_dtype=None):
    """Kernel 6's function with one tile's epilogue under the next tile's
    product (the TPU tool's ``make_pipelined``): a persistent grid whose
    two consumer warpgroups take 64-row tiles in turns."""
    if x.device.type == "cpu":
        return dense_act_plain(spec, x, w, bias, borders, out_dtype)
    out = _dense_act_tensor_core("pipelined", spec, x, w, bias, borders,
                                 out_dtype)
    dense_act_pipelined.launches += 1
    return out


def dense_act_simt(spec, x, w, bias, borders):
    """Kernel 6's function by the first, CUDA-core kernel: what the
    tensor-core schedules are measured against.  No model path runs it."""
    if x.device.type == "cpu":
        return dense_act_plain(spec, x, w, bias, borders)
    n, kdim, m, dev, dt, trans = _dense_act_args(spec, x, w, bias, borders)
    y = torch.empty(n, m, dtype=dt, device=dev)
    packed = torch.empty(packed_shape(n, m, spec.bits), dtype=torch.int32,
                         device=dev)
    _launch("fewbit_dense_act_simt", dev, x.data_ptr(), w.data_ptr(), trans,
            _ptr(bias), borders.data_ptr(), spec.n_borders,
            ctypes.byref(_act_args(spec, torch.float32)), y.data_ptr(),
            packed.data_ptr(), n, kdim, m,
            spec.bits, int(dt == torch.bfloat16))
    dense_act_simt.launches += 1
    return y, packed


def fused_dense_act(spec, x: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor], borders: torch.Tensor, *,
                    out=None):
    """``y = act(x @ w + b)`` with the packed codes of the pre-activation
    (``(bits, N / 32, M)`` int32).  ``x``: (N, K); ``w``: the logical
    (K, M) weight, row-major or the ``.t()`` of a row-major (M, K) tensor.
    Returns ``(y, packed)``, written into ``out`` where given.

    On the card the product runs on the tensor cores by the schedule
    :func:`dense_act_schedule` names; the kernel reads B K-major from
    scratch (f32: its TF32 halves, 2 M K elements; bf16 row-major ``w``:
    its transpose), written by a prologue kernel."""
    if x.device.type == "cpu":
        return _into(out, dense_act_plain(spec, x, w, bias, borders))
    _require(x.is_cuda and x.ndim == 2 and w.ndim == 2,
             "x and w must be 2-D CUDA tensors")
    got = _dense_act_tensor_core(
        dense_act_schedule(x.shape[0], w.shape[1], x.dtype), spec, x, w, bias,
        borders, out=out)
    fused_dense_act.launches += 1
    return got


# ---------------------------------------------------------------------------
# Flash attention F1-F3: forward, dK/dV, dQ.
# ---------------------------------------------------------------------------

# The head dimensions F1-F3 take: every d from 1 to 128 and every multiple
# of 128 above it, as JAX's TPU kernels take them.  Up to 128 they are
# instantiated at every multiple of 16 (csrc/flash_forward*.cu,
# csrc/flash_backward*.cu), and any other head dimension up to 128 runs on
# the instantiation at the next multiple of 16 (flash_instance), through
# zero-padded copies of its operands.  Above 128 the wide kernels
# (csrc/flash_forward_wide.cu, csrc/flash_backward_wide.cu) take d as
# d / 128 chunks of 128 columns, one instantiation per type and kernel.  The
# CUDA-core kernels they replaced take 64 only.
FLASH_MAX_HEAD_DIM = 128  # the largest of the instantiations by 16
FLASH_CHUNK = 128  # columns of a wide kernel's chunk
FLASH_INSTANCES = tuple(range(16, FLASH_MAX_HEAD_DIM + 1, 16))
FLASH_SIMT_HEAD_DIM = 64
FLASH_SMEM_LIMIT = 232448  # dynamic shared memory of a block (HB_SMEM_LIMIT)
_FLASH_KERNELS = ("flash_forward", "flash_backward_dkv", "flash_backward_dq")


class _FlashHeadDims:
    """Every d from 1 to 128 and every multiple of 128 above it: ``d in
    FLASH_HEAD_DIMS``.  Unbounded, so it is not iterated."""

    def __contains__(self, d) -> bool:
        return (isinstance(d, int) and not isinstance(d, bool)
                and (1 <= d <= FLASH_MAX_HEAD_DIM
                     or (d > FLASH_CHUNK and d % FLASH_CHUNK == 0)))

    def __str__(self) -> str:
        return (f"1 to {FLASH_MAX_HEAD_DIM} and every multiple of "
                f"{FLASH_CHUNK} above")


FLASH_HEAD_DIMS = _FlashHeadDims()


def _flash_wide(d: int) -> bool:
    """Whether head dimension ``d`` runs on the wide kernels."""
    return d > FLASH_MAX_HEAD_DIM


def flash_instance(d: int) -> int:
    """The instantiation of F1-F3 that runs head dimension ``d``: the next
    multiple of 16 up to 128, ``d`` itself above (the wide kernels, with
    ``d / 128`` chunks).  Raises for a ``d`` outside ``FLASH_HEAD_DIMS``,
    naming it."""
    _require(d in FLASH_HEAD_DIMS,
             f"head dimension {d}: the flash kernels take {FLASH_HEAD_DIMS}")
    return d if _flash_wide(d) else -(-d // 16) * 16


def _flash_tiles(kernel: str, dtype, d: int):
    """``(warpgroups, tile rows, stages)`` of a block of F1, F2 or F3 at
    the instantiation ``d`` (``FLASH_INSTANCES``, or a multiple of 128
    above 128), as ``hb_tiles``, ``hb_wide_fwd`` and ``hb_wide_bwd`` in
    ``csrc/flash_hopper.cuh``: a block loops over tiles of the other side
    through a ring of stages and owns 64 rows of its own side per consumer
    warpgroup, but in the wide F2 and F3 (:func:`_flash_wide_bwd`), whose
    two warpgroups share 64 rows.  The wide F1 (:func:`_flash_wide_fwd`)
    runs two warpgroups in bf16 and one in f32."""
    _require(kernel in _FLASH_KERNELS, f"kernel {kernel!r}")
    _require(d in FLASH_INSTANCES or (_flash_wide(d) and d in FLASH_HEAD_DIMS),
             f"head dimension {d}: no instantiation")
    bf16 = dtype == torch.bfloat16
    if _flash_wide(d):
        if kernel == "flash_forward":
            plan = _flash_wide_fwd(dtype, d)
            return 2 if bf16 else 1, plan.tile, plan.stages
        plan = _flash_wide_bwd(kernel, dtype, d)
        return 2, plan.tile, plan.stages
    if d > 64 and not bf16:
        return 1, 32, 2 if kernel == "flash_forward" else 1
    return 2, 64, 4 if bf16 else (2 if kernel == "flash_forward" else 1)


class WideFwdPlan(NamedTuple):
    """A wide F1 block, as ``hb_wide_fwd``: the rows of a kv tile, the
    ring's stages, the chunks of o a block owns, and whether its query rows
    stay resident."""
    tile: int
    stages: int
    nj: int
    res: bool


def _flash_wide_fwd(dtype, d: int) -> WideFwdPlan:
    """The plan of the wide F1 at head dimension ``d = 128 c``, as
    ``hb_wide_fwd`` in ``csrc/flash_hopper.cuh``: a block owns two chunks
    of 128 columns of o (128 registers a thread) and computes S over all of
    d.  bf16 (two warpgroups, no producer warps, 255 registers a thread):
    64-row kv tiles, a ring stage one chunk of K or V, the query rows
    resident up to c = 4 (eight stages, six at c = 4), above streamed
    beside K's chunk (four stages).  f32 (one consumer and one producer
    warpgroup): 32-row kv tiles, two stages of K's chunk as TF32 planes, V's
    chunks transposed into part 2, the query rows resident at c = 2 only."""
    _require(_flash_wide(d) and d in FLASH_HEAD_DIMS,
             f"head dimension {d}: not a wide one")
    c = d // FLASH_CHUNK
    if dtype == torch.bfloat16:
        return (WideFwdPlan(64, 8 if c <= 3 else 6, 2, True) if c <= 4
                else WideFwdPlan(64, 4, 2, False))
    return WideFwdPlan(32, 2, 2, c == 2)


class WideBwdPlan(NamedTuple):
    """A wide F2 or F3 block, as ``hb_wide_bwd``: the rows of a looped
    tile, the columns of d a ring stage carries, the ring's stages, the
    output chunks a block owns, and whether its own rows stay resident."""
    tile: int
    slice: int
    stages: int
    nj: int
    res: bool


def _flash_wide_bwd(kernel: str, dtype, d: int) -> WideBwdPlan:
    """The plan of the wide F2 (``flash_backward_dkv``) or F3 at head
    dimension ``d = 128 c``, as ``hb_wide_bwd`` in
    ``csrc/flash_hopper.cuh``: a block owns 64 own rows and ``nj`` chunks
    of 128 output columns; bf16 (no producer warps, 255 registers a thread)
    two chunks, 64-row tiles, a stage a chunk, and at c = 2 its own rows
    resident (four stages, the second products reading the looped chunks
    from the ring), above streamed (two stages; F3 four chunks); f32 (a
    producer warpgroup, 168 registers) F2 one chunk and F3 two, 32-row
    tiles and four stages of 32 columns."""
    _require(kernel in _FLASH_KERNELS[1:], f"kernel {kernel!r}")
    _require(_flash_wide(d) and d in FLASH_HEAD_DIMS,
             f"head dimension {d}: not a wide one")
    if dtype == torch.bfloat16:
        return (WideBwdPlan(64, FLASH_CHUNK, 4, 2, True)
                if d == 2 * FLASH_CHUNK
                else WideBwdPlan(64, FLASH_CHUNK, 2,
                                 2 if kernel == "flash_backward_dkv" else 4,
                                 False))
    return WideBwdPlan(32, 32, 4, 1 if kernel == "flash_backward_dkv" else 2,
                       False)


def _flash_wide_groups(kernel: str, dtype, d: int):
    """The output chunks of each block of a row tile of the wide F1, F2 or
    F3 at ``d``, in the order of ``blockIdx.x``: ``ceil(c / nj)`` blocks,
    block ``x`` the chunks ``nj x`` .. ``min(nj (x + 1), c) - 1``."""
    plan = (_flash_wide_fwd(dtype, d) if kernel == "flash_forward"
            else _flash_wide_bwd(kernel, dtype, d))
    c, nj = d // FLASH_CHUNK, plan.nj
    return [list(range(j0, min(j0 + nj, c))) for j0 in range(0, c, nj)]


def _flash_smem(kernel: str, dtype, d: int) -> int:
    """Dynamic shared memory of a block of F1, F2 or F3 at the
    instantiation ``d``, as ``ff_smem``, ``hb_smem``, ``wide_fwd_smem`` and
    ``wide_bwd_smem`` in the source: the block's own operands (F1 f32: Q's
    TF32 hi and lo planes), the ring, the f32 planes of the second products
    (F1: the staging of V), the per-tile row values, the barriers and 1024
    bytes of alignment slack.  The wide F1 keeps (:func:`_flash_wide_fwd`)
    its resident query rows (bf16 up to c = 4, f32 at c = 2), the ring (a
    stage: the query rows' chunk unless resident, and one 128-column chunk
    of K or V, f32's K as hi and lo planes), f32's part 2 (two slots of
    V's transposed planes) and staging of V, and no row values (the ids go
    to registers); the wide F2 and F3 keep (:func:`_flash_wide_bwd`) the
    resident own rows (bf16 at c = 2), the ring (a stage: the own rows' slice unless
    resident, the looped tile's, f32 as hi and lo planes), part 2 (unless
    resident: ``nj`` slots of the block's chunks of the second products'
    operands, F2 two operands and F3 one, f32 as transposed hi and lo
    planes) and the f32 exchange of P (F3: and dS); their row values stay
    in registers."""
    bf16 = dtype == torch.bfloat16
    elt, parts = (2, 1) if bf16 else (4, 2)
    if _flash_wide(d) and kernel != "flash_forward":
        _flash_tiles(kernel, dtype, d)  # refuses what is no instantiation
        w = _flash_wide_bwd(kernel, dtype, d)
        dkv = kernel == "flash_backward_dkv"
        stage = ((0 if w.res else 2 * 64 * w.slice * elt)
                 + 2 * parts * w.tile * w.slice * elt)
        slot = (2 if dkv else 1) * parts * w.tile * FLASH_CHUNK * elt
        return ((2 * 64 * d * elt if w.res else 0) + w.stages * stage
                + (0 if w.res else w.nj * slot)
                + (1 if dkv else 2) * 64 * w.tile * 4
                + (2 * w.stages + 2 * w.nj + 5) * 8 + 1024)
    wgs, tile, stages = _flash_tiles(kernel, dtype, d)
    if _flash_wide(d):
        w = _flash_wide_fwd(dtype, d)
        q_chunk = 64 * wgs * FLASH_CHUNK * elt
        loop = parts * tile * FLASH_CHUNK * elt
        return ((d // FLASH_CHUNK * q_chunk if w.res else 0)
                + stages * ((0 if w.res else q_chunk) + loop)
                + (0 if bf16 else (w.nj + 1) * loop)
                + (2 * stages + 2 * w.nj + 1) * 8 + 1024)
    plane = tile * d * elt
    if kernel == "flash_forward":
        return (parts * 64 * wgs * d * elt + stages * 2 * parts * plane
                + (0 if bf16 else 2 * plane) + stages * (tile + 4) * 4
                + (2 * stages + 1) * 8 + 1024)
    dkv = kernel == "flash_backward_dkv"
    return (2 * 64 * wgs * d * elt + stages * 2 * parts * plane
            + (0 if bf16 else (2 if dkv else 1) * 2 * plane)
            + (stages if bf16 else 2) * (3 * tile + 4) * 4 + 128 + 1024)


def _flash_checks(q, k, v, seg_q, seg_kv, head_dims=FLASH_HEAD_DIMS):
    """Envelope of the flash kernels: f32 or bf16 ``(b, h, s, d)``
    operands of one device and dtype, d in ``head_dims``, unit stride along
    d, int32 segment ids ``(b, s)`` for both sides or neither."""
    _require(q.is_cuda, f"q on {q.device}: neither CPU nor CUDA")
    _require(q.ndim == 4, f"q must be (b, h, s, d), not {tuple(q.shape)}")
    b, h, sq, d = q.shape
    sk = k.shape[2] if k.ndim == 4 else -1
    dev, dt = q.device, q.dtype
    _require(dt in _DTYPES, f"dtype {dt} not in {_DTYPES}")
    takes = (head_dims if head_dims is FLASH_HEAD_DIMS
             else f"{head_dims[0]} only")
    _require(d in head_dims,
             f"head dimension {d}: the flash kernels take {takes}")
    for name, t, shape in (("q", q, (b, h, sq, d)), ("k", k, (b, h, sk, d)),
                           ("v", v, (b, h, sk, d))):
        _require(t.device == dev, f"{name} on {t.device}, expected {dev}")
        _require(tuple(t.shape) == shape,
                 f"{name} has shape {tuple(t.shape)}, expected {shape}")
        _require(t.dtype == dt, f"{name} is {t.dtype}, expected {dt}")
        _require(t.stride(-1) == 1, f"{name} has stride {t.stride(-1)} "
                 f"along d, expected 1")
    _require((seg_q is None) == (seg_kv is None),
             "segment ids for both q and kv, or for neither")
    if seg_q is not None:
        _check("seg_q", seg_q, dev, (b, sq), torch.int32)
        _check("seg_kv", seg_kv, dev, (b, sk), torch.int32)
    return b, h, sq, sk, dev, dt


def _strides(*tensors):
    """The (b, h, s) strides of q, k, v, o, dO, dq, dk, dv (None for a
    tensor the kernel does not take), as the C array the kernels read."""
    vals = [x for t in tensors
            for x in (t.stride()[:3] if t is not None else (0, 0, 0))]
    return (ctypes.c_longlong * len(vals))(*vals)


def _into(out, got):
    """The plain version's results, copied into the caller's ``out``."""
    if out is None:
        return got
    for o, g in zip(out, got):
        o.copy_(g)
    return tuple(out)


def _head_dims(tensor_core):
    return FLASH_HEAD_DIMS if tensor_core else (FLASH_SIMT_HEAD_DIM,)


def _flash_operands(tensor_core, ins, outs):
    """The operands and outputs a kernel takes: ``ins`` and ``outs`` as
    given, or, at a head dimension d that is not a multiple of 16, copies
    of ``ins`` of ``flash_instance(d)`` columns, zeros past d, and new
    outputs of as many columns (``_flash_copy_back`` copies them into
    ``outs``)."""
    d = ins[0].shape[-1]
    pad = flash_instance(d) - d if tensor_core else 0
    if pad:
        return (tuple(torch.nn.functional.pad(t, (0, pad)) for t in ins),
                tuple(o.new_empty(*o.shape[:-1], d + pad) for o in outs))
    if tensor_core:
        _flash_tma_checks(*ins)
    return ins, outs


def _flash_copy_back(outs, got):
    for o, g in zip(outs, got):
        if g is not o:
            o.copy_(g[..., :o.shape[-1]])


def _flash_forward(fn_name, tensor_core, q, k, v, seg_q, seg_kv, causal,
                   sm_scale, out):
    b, h, sq, sk, dev, dt = _flash_checks(q, k, v, seg_q, seg_kv,
                                          _head_dims(tensor_core))
    if out is None:
        o = torch.empty_like(q)
        lse = torch.empty(b, h, sq, dtype=torch.float32, device=dev)
    else:
        _require(len(out) == 2, "out must hold o and lse")
        o, = _flash_outputs(out[:1], (q,), ("o",))
        lse = out[1]
        _check("out lse", lse, dev, (b, h, sq), torch.float32)
    (q, k, v), (o_k,) = _flash_operands(tensor_core, (q, k, v), (o,))
    strides = _strides(q, k, v, o_k, None, None, None, None)
    _launch(fn_name, dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _ptr(seg_q), _ptr(seg_kv), o_k.data_ptr(), lse.data_ptr(),
            ctypes.addressof(strides), b, h, sq, sk, q.shape[-1],
            int(causal), float(sm_scale), int(dt == torch.bfloat16))
    _flash_copy_back((o,), (o_k,))
    return o, lse


def flash_forward(q, k, v, seg_q=None, seg_kv=None, causal: bool = False,
                  sm_scale: float = 1.0, *, out=None):
    """F1: ``(o, lse)``, the attention output (q's dtype and strides, or
    written into ``out = (o, lse)``) and the f32 log-sum-exp of each row's
    masked logits ``(b, h, sq)``, contiguous.  On the card both products
    run on the tensor cores (bf16, or f32 as three TF32 products), fed by
    TMA: bases and strides are multiples of 16 bytes, and the head
    dimension one of ``FLASH_HEAD_DIMS`` (1 to 128, those that are not a
    multiple of 16 through zero-padded copies, and every multiple of 128
    above on the wide kernels)."""
    if q.device.type == "cpu":
        return _into(out, flash_forward_plain(q, k, v, seg_q, seg_kv, causal,
                                              sm_scale))
    out = _flash_forward("fewbit_flash_forward", True, q, k, v, seg_q,
                         seg_kv, causal, sm_scale, out)
    flash_forward.launches += 1
    return out


def flash_forward_simt(q, k, v, seg_q=None, seg_kv=None, causal: bool = False,
                       sm_scale: float = 1.0):
    """F1's function by the first, CUDA-core kernel: what the tensor-core
    kernel is measured against at head dimension 64, the one it takes.  No
    model path runs it."""
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, seg_q, seg_kv, causal, sm_scale)
    out = _flash_forward("fewbit_flash_forward_simt", False, q, k, v, seg_q,
                         seg_kv, causal, sm_scale, None)
    flash_forward_simt.launches += 1
    return out


def _flash_backward_checks(q, k, v, seg_q, seg_kv, lse, do, di,
                           head_dims=FLASH_HEAD_DIMS):
    b, h, sq, sk, dev, dt = _flash_checks(q, k, v, seg_q, seg_kv, head_dims)
    _require(do.device == dev and do.dtype == dt
             and tuple(do.shape) == tuple(q.shape) and do.stride(-1) == 1,
             f"dO {tuple(do.shape)} {do.dtype} on {do.device} does not fit "
             f"q with unit stride along d")
    _check("lse", lse, dev, (b, h, sq), torch.float32)
    _check("di", di, dev, (b, h, sq), torch.float32)
    return b, h, sq, sk, dev, dt


def flash_backward_envelope(dtype, shape, strides) -> None:
    """What the tensor-core F2 and F3 (csrc/flash_backward.cu) ask of an
    operand beyond _flash_checks, from its dtype, ``(b, h, s)`` shape and
    strides (in elements) alone: TMA reads strides that are positive
    multiples of 16 bytes, in every dimension of more than one element.
    There is one route, whatever the sequence: outside the envelope this
    raises."""
    _require(dtype in _DTYPES, f"dtype {dtype} not in {_DTYPES}")
    per16 = 16 * 8 // torch.finfo(dtype).bits
    for n, st in zip(shape, strides):
        _require(n >= 1, f"shape {tuple(shape)}")
        _require(n == 1 or (st > 0 and st % per16 == 0),
                 f"stride {st}: TMA reads strides that are positive "
                 f"multiples of 16 bytes ({per16} elements)")


def _flash_tma_checks(*tensors):
    """The envelope of the tensor-core backward beyond _flash_checks: 16-byte
    aligned bases and (b, h, s) strides of q, k, v and dO."""
    for t in tensors:
        _require(t.data_ptr() % 16 == 0,
                 "q, k, v and dO must be 16-byte aligned (TMA reads them)")
        flash_backward_envelope(t.dtype, t.shape[:3], t.stride()[:3])


def _flash_outputs(out, likes, names):
    """The tensors a backward kernel writes: new ones with the strides of
    ``likes``, or the caller's ``out`` (a check can fill them first and see
    every element written)."""
    if out is None:
        return tuple(torch.empty_like(t) for t in likes)
    _require(len(out) == len(likes), f"out must hold {names}")
    for name, o, t in zip(names, out, likes):
        _require(o.device == t.device and o.dtype == t.dtype
                 and o.shape == t.shape and o.stride(-1) == 1,
                 f"out {name} {tuple(o.shape)} {o.dtype} on {o.device} does "
                 f"not fit {tuple(t.shape)} {t.dtype} with unit stride "
                 f"along d")
    return tuple(out)


def _flash_backward_dkv(fn_name, tensor_core, q, k, v, seg_q, seg_kv, lse,
                        do, di, causal, sm_scale, out):
    b, h, sq, sk, dev, dt = _flash_backward_checks(
        q, k, v, seg_q, seg_kv, lse, do, di, _head_dims(tensor_core))
    dk, dv = _flash_outputs(out, (k, v), ("dk", "dv"))
    (q, k, v, do), (dk_k, dv_k) = _flash_operands(tensor_core, (q, k, v, do),
                                                   (dk, dv))
    strides = _strides(q, k, v, None, do, None, dk_k, dv_k)
    _launch(fn_name, dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _ptr(seg_q), _ptr(seg_kv), lse.data_ptr(), do.data_ptr(),
            di.data_ptr(), dk_k.data_ptr(), dv_k.data_ptr(),
            ctypes.addressof(strides), b, h, sq, sk, q.shape[-1],
            int(causal), float(sm_scale), int(dt == torch.bfloat16))
    _flash_copy_back((dk, dv), (dk_k, dv_k))
    return dk, dv


def _flash_backward_dq(fn_name, tensor_core, q, k, v, seg_q, seg_kv, lse, do,
                       di, causal, sm_scale, out):
    b, h, sq, sk, dev, dt = _flash_backward_checks(
        q, k, v, seg_q, seg_kv, lse, do, di, _head_dims(tensor_core))
    dq, = _flash_outputs(out, (q,), ("dq",))
    (q, k, v, do), (dq_k,) = _flash_operands(tensor_core, (q, k, v, do),
                                              (dq,))
    strides = _strides(q, k, v, None, do, dq_k, None, None)
    _launch(fn_name, dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _ptr(seg_q), _ptr(seg_kv), lse.data_ptr(), do.data_ptr(),
            di.data_ptr(), dq_k.data_ptr(), ctypes.addressof(strides), b, h,
            sq, sk, q.shape[-1], int(causal), float(sm_scale),
            int(dt == torch.bfloat16))
    _flash_copy_back((dq,), (dq_k,))
    return dq


def flash_backward_dkv(q, k, v, seg_q, seg_kv, lse, do, di,
                       causal: bool = False, sm_scale: float = 1.0, *,
                       out=None):
    """F2: ``(dk, dv)`` from the forward's ``lse``, the output gradient
    ``do`` and ``di = sum(do * o, -1)`` (f32); k's and v's strides, or
    written into ``out = (dk, dv)``.  On the card every product runs on the
    tensor cores (bf16, or f32 as three TF32 products), fed by TMA: bases
    and strides are multiples of 16 bytes."""
    if q.device.type == "cpu":
        return _into(out, flash_backward_dkv_plain(
            q, k, v, seg_q, seg_kv, lse, do, di, causal, sm_scale))
    out = _flash_backward_dkv("fewbit_flash_backward_dkv", True, q, k, v,
                              seg_q, seg_kv, lse, do, di, causal, sm_scale,
                              out)
    flash_backward_dkv.launches += 1
    return out


def flash_backward_dq(q, k, v, seg_q, seg_kv, lse, do, di,
                      causal: bool = False, sm_scale: float = 1.0, *,
                      out=None):
    """F3: ``dq`` (q's strides, or written into ``out = (dq,)``), from the
    arguments of F2, on the tensor cores as F2."""
    if q.device.type == "cpu":
        return _into(out, (flash_backward_dq_plain(
            q, k, v, seg_q, seg_kv, lse, do, di, causal, sm_scale),))[0]
    out = _flash_backward_dq("fewbit_flash_backward_dq", True, q, k, v, seg_q,
                             seg_kv, lse, do, di, causal, sm_scale, out)
    flash_backward_dq.launches += 1
    return out


def flash_backward_dkv_simt(q, k, v, seg_q, seg_kv, lse, do, di,
                            causal: bool = False, sm_scale: float = 1.0):
    """F2's function by the first, CUDA-core kernel: what the tensor-core
    kernel is measured against.  No model path runs it."""
    if q.device.type == "cpu":
        return flash_backward_dkv_plain(q, k, v, seg_q, seg_kv, lse, do, di,
                                        causal, sm_scale)
    out = _flash_backward_dkv("fewbit_flash_backward_dkv_simt", False, q, k,
                              v, seg_q, seg_kv, lse, do, di, causal, sm_scale,
                              None)
    flash_backward_dkv_simt.launches += 1
    return out


def flash_backward_dq_simt(q, k, v, seg_q, seg_kv, lse, do, di,
                           causal: bool = False, sm_scale: float = 1.0):
    """F3's function by the first, CUDA-core kernel; on no model path."""
    if q.device.type == "cpu":
        return flash_backward_dq_plain(q, k, v, seg_q, seg_kv, lse, do, di,
                                       causal, sm_scale)
    out = _flash_backward_dq("fewbit_flash_backward_dq_simt", False, q, k, v,
                             seg_q, seg_kv, lse, do, di, causal, sm_scale,
                             None)
    flash_backward_dq_simt.launches += 1
    return out


# name -> (wrapper, plain version, TPU kernel it replaces, CUDA source).
KERNELS = {
    "matmul_input_sketch": (
        fused_matmul_input_sketch, matmul_input_sketch_plain,
        "fewbit_tpu/ops/pallas_kernels.py:1013",
        "fewbit_tpu_torch/csrc/matmul_input_sketch.cu"),
    "dense_act_sketch": (
        fused_dense_act_sketch, dense_act_sketch_plain,
        "fewbit_tpu/ops/pallas_kernels.py:687",
        "fewbit_tpu_torch/csrc/dense_act_sketch.cu"),  # + ffn_gemm.cuh
    "matmul_lut_backward": (
        fused_matmul_lut_backward, matmul_lut_backward_plain,
        "fewbit_tpu/ops/pallas_kernels.py:799",
        "fewbit_tpu_torch/csrc/matmul_lut_backward.cu"),
    "fused_forward": (
        fused_forward, act_forward_plain,
        "fewbit_tpu/ops/pallas_kernels.py:215",
        "fewbit_tpu_torch/csrc/activation.cu"),
    "fused_backward": (
        fused_backward, act_backward_plain,
        "fewbit_tpu/ops/pallas_kernels.py:285",
        "fewbit_tpu_torch/csrc/activation.cu"),
    "dense_act": (  # by dense_act_schedule; also dense_act_pipelined.cu
        fused_dense_act, dense_act_plain,
        "fewbit_tpu/ops/pallas_kernels.py:411",
        "fewbit_tpu_torch/csrc/dense_act.cu"),
    # The four schedules of kernel 6's function.
    "dense_act_kloop": (
        dense_act_kloop, dense_act_plain, "tools/exp_megakernel.py:88",
        "fewbit_tpu_torch/csrc/dense_act.cu"),
    "dense_act_direct": (
        dense_act_direct, dense_act_plain, "tools/exp_megakernel.py:186",
        "fewbit_tpu_torch/csrc/dense_act_direct.cu"),
    "dense_act_emit": (
        dense_act_emit, dense_act_plain, "tools/exp_megakernel.py:246",
        "fewbit_tpu_torch/csrc/dense_act_direct.cu"),
    "dense_act_pipelined": (
        dense_act_pipelined, dense_act_plain, "tools/exp_megakernel.py:312",
        "fewbit_tpu_torch/csrc/dense_act_pipelined.cu"),
    "dense_act_sketch_x": (
        fused_dense_act_sketch_x, dense_act_sketch_x_plain,
        "fewbit_tpu/ops/pallas_kernels.py:687 (_kernel_skx)",
        "fewbit_tpu_torch/csrc/dense_act_sketch.cu"),
    # JAX's library kernel, jax/experimental/pallas/ops/tpu/
    # flash_attention.py (jax 0.9.0), by pallas_call line.
    "flash_forward": (
        flash_forward, flash_forward_plain,
        "jax/experimental/pallas/ops/tpu/flash_attention.py:758",
        "fewbit_tpu_torch/csrc/flash_forward.cu"),
    "flash_backward_dkv": (
        flash_backward_dkv, flash_backward_dkv_plain,
        "jax/experimental/pallas/ops/tpu/flash_attention.py:1121",
        "fewbit_tpu_torch/csrc/flash_backward.cu"),
    "flash_backward_dq": (
        flash_backward_dq, flash_backward_dq_plain,
        "jax/experimental/pallas/ops/tpu/flash_attention.py:1456",
        "fewbit_tpu_torch/csrc/flash_backward.cu"),
}


def reset_launch_counts() -> None:
    for wrapper, *_ in KERNELS.values():
        wrapper.launches = 0
    # Not among KERNELS: the separate sketch pass of kernels 1 and 2', and
    # the CUDA-core kernels replaced, on no path.
    for wrapper in (input_sketch, dense_act_simt, dense_act_sketch_x_simt,
                    flash_forward_simt, flash_backward_dkv_simt,
                    flash_backward_dq_simt):
        wrapper.launches = 0


def launch_counts() -> dict:
    return {name: entry[0].launches for name, entry in KERNELS.items()}


reset_launch_counts()
