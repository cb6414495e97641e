"""The design of the tensor-core GEMM kernels (1, 2 and 3) on the CPU: why
f32 takes three TF32 products, the route that the host chooses from the
shapes against each kernel's shared-memory budget (kernel 1: fused sketch
or a separate pass, and the tile width; kernels 2 and 3: the tile width),
the index arithmetic by which kernel 2 packs and kernel 3 decodes codes
from a wgmma accumulator fragment, and how few codes a 3xTF32 z flips.

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

from fewbit_tpu_torch.functional.activations import resolve_activation
from fewbit_tpu_torch.ops import kernels as K
from fewbit_tpu_torch.ops.bitpack import pack_codes


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


def _ffn_envelope():
    """Every (n, M, k_eff) of the FFN kernels' envelope (_ffn_rows_ok) at
    these n: M a multiple of 512, k_eff a multiple of 512 dividing n."""
    for n in (512, 2048, 8192):
        for k_eff in range(512, n + 1, 512):
            if n % k_eff:
                continue
            for m in range(512, 8193, 512):
                yield n, m, k_eff


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ffn_gemm_route_fits_shared_memory(dtype):
    count = 0
    for n, m, k_eff in _ffn_envelope():
        K._ffn_rows_ok(n, m, k_eff)
        bn = K.ffn_gemm_route(m, dtype)
        # 96 wherever it divides M, else 64, which divides every M of the
        # envelope; the block fits at either.
        assert bn == (96 if m % 96 == 0 else 64) and m % bn == 0
        assert K._ffn_smem(dtype, bn) <= K.FG_SMEM_LIMIT
        assert k_eff % K.FG_BM == 0 and n % K.FG_BM == 0
        count += 1
    assert count == (1 + 3 + 5) * 16
    # The budget at the path's tile, term by term (f32: A rows, B_hi and
    # B_lo rows, 4 stages; 48 sketch accumulators for each of 256 consumer
    # threads; 8 db rows; the table; 8 barriers; alignment slack).
    assert K.ffn_gemm_route(3072, torch.float32) == 96
    assert K._ffn_smem(torch.float32, 96) == (
        4 * (128 + 2 * 96) * 128 + 48 * 256 * 4 + 8 * 96 * 4 + 256 + 64
        + 1024)
    assert K.ffn_gemm_route(512, torch.bfloat16) == 64
    with pytest.raises(ValueError):
        K.ffn_gemm_route(100, torch.float32)


def _fragment_threads():
    """The 256 consumer threads of a block as (wg, warp, g, t): thread
    (g, t) of warp ``warp`` of warpgroup ``wg`` holds accumulator elements
    d[4 i + 2 h + e] at tile row 64 wg + 16 warp + g + 8 h, column
    8 i + 2 t + e (csrc/hopper_gemm.cuh)."""
    for wg in range(2):
        for warp in range(4):
            for g in range(8):
                for t in range(4):
                    yield wg, warp, g, t


@pytest.mark.parametrize("bn", [96, 64])
@pytest.mark.parametrize("bits", [1, 3, 6])
def test_fragment_code_packing_is_pack_codes_layout(bn, bits):
    """Kernel 2's epilogue arithmetic, emulated: each thread puts the plane
    bits of its rows g and g + 8 at bits g and g + 8 of a 16-bit half (two
    planes to a register), the halves are ORed over the 8 lanes that share
    a column, and the even / odd warp of a 32-row group stores the low /
    high half of the word.  Over a 128 x bn tile of the second pass of a
    (256, 2 bn) problem, every (row, column, plane) lands exactly once,
    where pack_codes puts it; kernel 3's decode reads it back."""
    n, m, k_eff = 256, 2 * bn, 128
    r0, col0 = k_eff, bn          # pass 1, bucket tile 0, column tile 1
    words = n // 32
    rng = np.random.RandomState(bn + bits)
    codes = rng.randint(0, 2 ** bits, size=(n, m))
    halves = np.zeros((bits, words, m, 2), np.uint16)
    writes = np.zeros((bits, words, m, 2), np.int64)
    for i in range(bn // 8):
        for q in range((bits + 1) // 2):     # planes 2 q and 2 q + 1
            for e in range(2):
                reduced = {}                 # (wg, warp, t) -> OR over g
                for wg, warp, g, t in _fragment_threads():
                    row = r0 + 64 * wg + 16 * warp + g
                    col = col0 + 8 * i + 2 * t + e
                    rows = int(codes[row, col]) | int(codes[row + 8, col]) << 8
                    v = ((((rows >> (2 * q)) & 0x101) << g)
                         | (((rows >> (2 * q + 1)) & 0x101) << (g + 16)))
                    reduced[wg, warp, t] = reduced.get((wg, warp, t), 0) | v
                for wg, warp, g, t in _fragment_threads():
                    if g != i % 8:           # one lane of the 8 stores
                        continue
                    col = col0 + 8 * i + 2 * t + e
                    word_row = (r0 + 64 * wg + 32 * (warp // 2)) // 32
                    for o in range(2):
                        b = 2 * q + o
                        if b < bits:
                            at = (b, word_row, col, warp & 1)
                            halves[at] = (reduced[wg, warp, t]
                                          >> (16 * o)) & 0xFFFF
                            writes[at] += 1
    tile = np.zeros((n, m), bool)
    tile[r0:r0 + 128, col0:col0 + bn] = True
    touched = tile.reshape(words, 32, m)[:, ::16].transpose(0, 2, 1)
    assert (writes == touched[None]).all()     # each half once, no other
    got = (halves[..., 0].astype(np.int64)
           | halves[..., 1].astype(np.int64) << 16)
    want = pack_codes(torch.from_numpy(codes * tile), bits).numpy()
    assert (got == want.astype(np.int64) % 2 ** 32).all()
    # Kernel 3's decode: bit 16 (warp % 2) + g + 8 h of the group's word.
    for wg, warp, g, t in _fragment_threads():
        word_row = (r0 + 64 * wg + 32 * (warp // 2)) // 32
        for h in range(2):
            bit = 16 * (warp & 1) + g + 8 * h
            row = r0 + 64 * wg + 16 * warp + g + 8 * h
            for i in range(bn // 8):
                for e in range(2):
                    col = col0 + 8 * i + 2 * t + e
                    code = sum(((int(got[b, word_row, col]) >> bit) & 1) << b
                               for b in range(bits))
                    assert code == codes[row, col]


def test_3xtf32_flips_few_codes_at_ffn_width():
    """The codes of a 3xTF32 pre-activation against those of the f32 one,
    at the up projection's K = 768 and M = 3072: they may differ only
    within 1e-3 of a border and on at most 1e-4 of the elements, the
    limits the kernels are held to on the card."""
    flip_band, flip_fraction = 1e-3, 1e-4
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(512, 768).astype(np.float32))
    w = torch.from_numpy((rng.randn(768, 3072) * 768 ** -0.5)
                         .astype(np.float32))
    bias = torch.from_numpy((rng.randn(3072) * 0.1).astype(np.float32))
    spec, borders, _ = resolve_activation("gelu", bits=3)
    x_hi, w_hi = _tf32(x), _tf32(w)
    x_lo, w_lo = _tf32(x - x_hi), _tf32(w - w_hi)
    z3 = x_hi @ w_hi + x_hi @ w_lo + x_lo @ w_hi + bias
    z0 = x @ w + bias
    flips = spec.codes(z3, borders, spec.args) != spec.codes(z0, borders,
                                                             spec.args)
    assert flips.float().mean().item() <= flip_fraction
    if flips.any():
        near = (z0[flips][:, None] - borders[None, :]).abs().min(1)[0]
        assert near.max().item() <= flip_band
    # The split itself moves z by far less than the band.
    assert (z3 - z0).abs().max().item() <= 1e-2 * flip_band
