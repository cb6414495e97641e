"""Kernel 1's design on the CPU: why f32 takes three TF32 products, and the
route (fused sketch or a separate pass, and the tile width) that the host
chooses from the shapes against the kernel's shared-memory budget.

The 3xTF32 emulation rounds to nearest with TF32's 10 mantissa bits, as
``cvt.rna.tf32.f32`` does on the card, and sums the products of the halves
with the CPU's f32 matmul.  It bounds the error of the split alone, at a
tenth of the f32 tolerance of the kernel tests (1e-4 of max(1, max |y|)).
It does not model the card's accumulation: on the H100 the kernel's error
is several times the emulation's on the same data (PERF.md, kernel 1).
"""

import numpy as np
import pytest
import torch

from fewbit_tpu_torch.ops import kernels as K


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """Round f32 to nearest, ties away from zero, at 10 mantissa bits."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


@pytest.mark.parametrize("kdim", [768, 1024])
def test_3xtf32_keeps_f32_accuracy_and_one_pass_does_not(kdim):
    rng = np.random.RandomState(kdim)
    a = rng.randn(256, kdim).astype(np.float32)
    b = (rng.randn(kdim, 768) * kdim ** -0.5).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = max(1.0, float(np.abs(ref).max()))
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    a_hi, b_hi = _tf32(at), _tf32(bt)
    a_lo, b_lo = _tf32(at - a_hi), _tf32(bt - b_hi)
    for half in (a_hi, a_lo, b_hi, b_lo):
        assert not (half.view(torch.int32) & 0x1FFF).any()
    # hi + lo carries a to about 2^-22 of its magnitude.
    assert ((a_hi + a_lo - at).abs() <= at.abs() * 2.0 ** -21).all()

    def err(y):
        return float(np.abs(y.double().numpy() - ref).max())

    three = a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi
    one = a_hi @ b_hi
    assert err(three) <= 1e-5 * scale, err(three)
    assert err(one) > 1e-4 * scale, err(one)
    # Plain f32 for comparison: 3xTF32 is of its order.
    assert err(three) <= 4 * err(at @ bt) + 1e-6 * scale


def _envelope():
    """Every (n, K, M, k_eff) of matmul_sketch_keff's envelope at these
    n: K and M multiples of 128 up to 1024, k_eff an aligned bucket count
    of at most n / 2."""
    for n in (1024, 2048, 8192, 16384):
        for k_eff in range(512, n // 2 + 1, 512):
            if n % k_eff:
                continue
            for kdim in range(128, 1025, 128):
                for m in range(128, 1025, 128):
                    yield n, kdim, m, k_eff


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_sketch_route_fits_shared_memory(dtype):
    count = 0
    for n, kdim, m, k_eff in _envelope():
        assert K.matmul_sketch_keff(n, kdim, m, k_eff, dtype) == k_eff
        fused, bn = K.matmul_sketch_route(kdim, m, dtype)
        assert bn in K.K1_TILE_N and m % bn == 0
        assert K._k1_smem(dtype, bn, kdim, m, fused) <= K.K1_SMEM_LIMIT
        widths = [w for w in K.K1_TILE_N if m % w == 0]
        fits = [w for w in widths
                if K._k1_smem(dtype, w, kdim, m, True) <= K.K1_SMEM_LIMIT]
        # Separate only when no tile width leaves room for the slice; the
        # first width that does (96 before 64) otherwise.
        assert fused == bool(fits)
        assert bn == (fits or widths)[0]
        count += 1
    assert count == 12 * 64  # 12 (n, k_eff) pairs


def test_matmul_sketch_route_at_the_path_shapes():
    # The attention projections: N = 8192, 768 -> 768, k_eff 2048: 16 slabs
    # x 8 column tiles of 96 = 128 blocks on 132 SMs, the sketch fused.
    for dt in (torch.float32, torch.bfloat16):
        assert K.matmul_sketch_route(768, 768, dt) == (True, 96)
    # The budget, term by term (f32: A rows, B_hi and B_lo rows, 4 stages;
    # 136 accumulator rows of 96 columns; 8 barriers; alignment slack).
    assert K._k1_smem(torch.float32, 96, 768, 768, True) == (
        4 * (128 + 2 * 96) * 128 + 136 * 96 * 4 + 8 * 8 + 1024)
    # A wide K over one narrow column tile: the slice does not fit, the
    # sketch takes the separate pass.
    assert K.matmul_sketch_route(1024, 128, torch.float32) == (False, 64)
    assert not K.matmul_sketch_route(1024, 128, torch.bfloat16)[0]
    # At M = 384 the slice of K = 1024 fits beside 64-wide tiles only.
    for dt in (torch.float32, torch.bfloat16):
        assert K.matmul_sketch_route(1024, 384, dt) == (True, 64)
    # 96 does not divide M = 1024.
    assert K.matmul_sketch_route(128, 1024, torch.float32) == (True, 64)
