"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  These tests need an NVIDIA GPU and skip elsewhere; the file imports
no JAX, so it also runs where JAX is missing:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances, as a fraction of max(1, max |plain|): f32 differs only by the
order of the f32 sums (1e-4); bf16 outputs may differ by one bf16 rounding
step where the f32 sums differ (2e-2); the f32 column sums and db add
thousands of rows (1e-3).  Codes may flip only where z lies within
rounding of a border, on at most 1e-4 of the elements.
"""

import math

import pytest
import torch

from fewbit_tpu_torch.functional.activations import resolve_activation
from fewbit_tpu_torch.ops import kernels as K
from fewbit_tpu_torch.ops.bitpack import unpack_codes
from fewbit_tpu_torch.ops.flash_attention import (SegmentIds,
                                                  flash_attention,
                                                  flash_backward_dkv_plain,
                                                  flash_backward_dq_plain,
                                                  flash_backward_plain,
                                                  flash_forward_plain)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernels are CUDA only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_on_cuda(cuda, dtype):
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    gen = torch.Generator(device=cuda).manual_seed(0)
    n, kdim, m, k_eff = 2048, 256, 512, 1024

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=cuda)
                * scale).to(dtype)

    def close(a, b, t=tol):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= t * max(1.0, b.float().abs().max().item()), err

    sigma = torch.randint(0, 2, (n,), generator=gen,
                          device=cuda).float() * 2 - 1
    x, w, bias = rand(n, kdim), rand(m, kdim, scale=0.06), rand(m, scale=0.1)
    spec, borders, levels = resolve_activation("gelu", bits=3, device=cuda)
    K.reset_launch_counts()
    for args in ((x, w.t(), bias, sigma, k_eff // 2),
                 (rand(n, m), w, None, sigma, k_eff // 2, True)):
        for a, b in zip(K.fused_matmul_input_sketch(*args),
                        K.matmul_input_sketch_plain(*args)):
            close(a, b, tol if a.dtype == dtype else 1e-3)
    args = (spec, x, w.t(), bias, borders, sigma, k_eff)
    y, packed, sk = K.fused_dense_act_sketch(*args)
    y0, packed0, sk0 = K.dense_act_sketch_plain(*args)
    close(y, y0)
    close(sk, sk0)
    flips = (unpack_codes(packed, 3, n) != unpack_codes(packed0, 3, n))
    assert flips.float().mean().item() <= 1e-4
    args = (spec, packed, levels, rand(n, kdim), rand(kdim, m, scale=0.06),
            sigma, k_eff)
    dz, sk, db = K.fused_matmul_lut_backward(*args)
    dz0, sk0, db0 = K.matmul_lut_backward_plain(*args)
    close(dz, dz0)
    close(sk, sk0)
    close(db, db0, 1e-3)
    torch.cuda.synchronize()
    assert K.launch_counts() == {name: 0 for name in K.KERNELS} | {
        "matmul_input_sketch": 2, "dense_act_sketch": 1,
        "matmul_lut_backward": 1}


def _k1_inputs(cuda, dtype, n, kdim, m, trans, seed):
    """Kernel 1's operands: x, the logical (K, M) weight (an (out, in)
    parameter seen through .t() when trans, else row-major), a bias and
    signs."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(n, kdim, generator=gen, device=cuda).to(dtype)
    weight = (torch.randn(m, kdim, generator=gen, device=cuda)
              * kdim ** -0.5).to(dtype)
    w = weight.t() if trans else weight.t().contiguous()
    bias = (torch.randn(m, generator=gen, device=cuda) * 0.1).to(dtype)
    sigma = torch.randint(0, 2, (n,), generator=gen,
                          device=cuda).float() * 2 - 1
    return x, w, bias, sigma


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("keff_div", [2, 4])
@pytest.mark.parametrize("colsum", [False, True])
@pytest.mark.parametrize("trans", [1, 0])
@pytest.mark.parametrize("kdim,m", [(768, 768), (128, 1024), (1024, 128),
                                    (256, 512)])
def test_matmul_input_sketch_matches_plain_on_cuda(cuda, kdim, m, trans,
                                                   colsum, keff_div, dtype):
    """Kernel 1 on every route: fused sketch at 96-wide (768 -> 768) and
    64-wide tiles, and the separate sketch pass (K = 1024 over M = 128)."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    n = 8192
    k_eff = n // keff_div
    x, w, bias, sigma = _k1_inputs(cuda, dtype, n, kdim, m, trans,
                                   kdim + m + trans)
    fused, _ = K.matmul_sketch_route(kdim, m, dtype)
    assert fused == ((kdim, m) != (1024, 128))
    args = (x, w, bias if trans else None, sigma, k_eff, colsum)
    K.reset_launch_counts()
    got = K.fused_matmul_input_sketch(*args)
    want = K.matmul_input_sketch_plain(*args)
    torch.cuda.synchronize()
    assert len(got) == len(want) == 2 + colsum
    for name, a, b in zip(("y", "sketch", "colsum"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        t = 1e-3 if name == "colsum" else tol
        err = (a.float() - b.float()).abs().max().item()
        assert err <= t * max(1.0, b.float().abs().max().item()), (name, err)
    assert K.launch_counts()["matmul_input_sketch"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_input_sketch_is_deterministic_on_cuda(cuda, dtype):
    """Two calls on the same inputs give bitwise-equal y, sketch and
    column sum: every sum has one owner and a fixed order."""
    for trans, colsum in ((1, False), (0, True)):
        x, w, bias, sigma = _k1_inputs(cuda, dtype, 8192, 768, 768, trans, 3)
        args = (x, w, bias, sigma, 2048, colsum)
        first = K.fused_matmul_input_sketch(*args)
        second = K.fused_matmul_input_sketch(*args)
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_sketch_route_budget_is_the_kernels(cuda, dtype):
    """The host's route sizes shared memory as the kernel lays it out: over
    the whole (K, M) envelope, both tile widths and both routes, _k1_smem
    and K1_SMEM_LIMIT give what the kernel's own k1_smem gives (-1 where
    the kernel would refuse the launch)."""
    from fewbit_tpu_torch.ops._build import load_library

    query = load_library().fewbit_matmul_sketch_smem
    for kdim in range(128, 1025, 128):
        for m in range(128, 1025, 128):
            for bn in K.K1_TILE_N:
                for fused in (False, True):
                    want = K._k1_smem(dtype, bn, kdim, m, fused)
                    if m % bn or want > K.K1_SMEM_LIMIT:
                        want = -1
                    got = query(kdim, m, bn, int(fused),
                                int(dtype == torch.bfloat16))
                    assert got == want, (kdim, m, bn, fused)


def _lut(cuda, bits):
    """The builtin GELU LUT, or for 5 bits a custom 32-level one."""
    if bits <= 4:
        return resolve_activation("gelu", bits=bits, device=cuda)
    borders = torch.linspace(-3.0, 3.0, 31).tolist()
    values = torch.linspace(-0.1, 1.1, 32).tolist()
    return resolve_activation("gelu", borders=borders, values=values,
                              device=cuda)


def _ffn_inputs(cuda, dtype, n, kdim, m, trans, seed):
    """The FFN block's operands at (N, K) -> M -> H = K: x, the up weight
    as the logical (K, M) operand and the down weight as the logical (H, M)
    operand (each a ``.t()`` view of its row-major transpose when trans,
    else row-major), the up bias, an (N, H) gradient and signs."""
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=cuda)
                * scale).to(dtype)

    x, g = rand(n, kdim), rand(n, kdim)
    up, down = rand(m, kdim, scale=kdim ** -0.5), rand(m, kdim,
                                                       scale=m ** -0.5)
    if not trans:
        up, down = up.t().contiguous().t(), down.t().contiguous().t()
    sigma = torch.randint(0, 2, (n,), generator=gen,
                          device=cuda).float() * 2 - 1
    return x, g, up.t(), down.t(), rand(m, scale=0.1), sigma


def _close(name, a, b, tol):
    assert a.dtype == b.dtype and a.shape == b.shape, name
    err = (a.float() - b.float()).abs().max().item()
    assert err <= tol * max(1.0, b.float().abs().max().item()), (name, err)


def _flips_ok(packed, packed0, z0, borders, bits):
    """Codes differ from the plain version's only within 1e-3 of a border,
    on at most 1e-4 of the elements (chip_smoke's FLIP_BAND and
    FLIP_FRACTION)."""
    n = z0.shape[0]
    flips = unpack_codes(packed, bits, n) != unpack_codes(packed0, bits, n)
    assert flips.float().mean().item() <= 1e-4
    if flips.any():
        near = (z0[flips][:, None] - borders[None, :]).abs().min(1)[0]
        assert near.max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [1, 3, 5])
@pytest.mark.parametrize("passes", [1, 2, 4])
@pytest.mark.parametrize("trans", [1, 0])
@pytest.mark.parametrize("kdim", [128, 768, 1024])
@pytest.mark.parametrize("m", [512, 1536, 3072])
def test_ffn_kernels_match_plain_on_cuda(cuda, m, kdim, trans, passes, bits,
                                         dtype):
    """Kernels 2 and 3 (TMA ring and wgmma) against their plain versions:
    64-wide (M = 512) and 96-wide tiles, both weight layouts, one to four
    passes of the stride partition, 1, 3 and 5 (custom LUT) bits; kernel 3
    decodes kernel 2's own codes."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    n = 2048
    k_eff = n // passes
    spec, borders, levels = _lut(cuda, bits)
    x, g, w_up, wt_down, bias, sigma = _ffn_inputs(cuda, dtype, n, kdim, m,
                                                   trans, m + kdim + bits)
    assert K.ffn_gemm_route(m, dtype) == (64 if m == 512 else 96)
    K.reset_launch_counts()
    args = (spec, x, w_up, bias, borders, sigma, k_eff)
    y, packed, sk = K.fused_dense_act_sketch(*args)
    y0, packed0, sk0 = K.dense_act_sketch_plain(*args)
    _close("y", y, y0, tol)
    _close("sketch_y", sk, sk0, tol)
    assert packed.dtype == packed0.dtype and packed.shape == packed0.shape
    _flips_ok(packed, packed0, K.dot_f32(x, w_up) + bias.float(), borders,
              spec.bits)
    args = (spec, packed, levels, g, wt_down, sigma, k_eff)
    dz, sk, db = K.fused_matmul_lut_backward(*args)
    dz0, sk0, db0 = K.matmul_lut_backward_plain(*args)
    torch.cuda.synchronize()
    _close("dz", dz, dz0, tol)
    _close("sketch_dz", sk, sk0, tol)
    _close("db", db, db0, 1e-3)
    assert K.launch_counts() == {name: 0 for name in K.KERNELS} | {
        "dense_act_sketch": 1, "matmul_lut_backward": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ffn_kernels_are_deterministic_on_cuda(cuda, dtype):
    """Two calls on the same inputs give bitwise-equal y, codes, sketches,
    dz and db: every sum has one owner and a fixed order."""
    spec, borders, levels = _lut(cuda, 3)
    for trans, m in ((1, 3072), (0, 512)):
        x, g, w_up, wt_down, bias, sigma = _ffn_inputs(cuda, dtype, 8192,
                                                       768, m, trans, 11)
        runs = []
        for _ in range(2):
            y, packed, sk = K.fused_dense_act_sketch(spec, x, w_up, bias,
                                                     borders, sigma, 2048)
            runs.append((y, packed, sk, *K.fused_matmul_lut_backward(
                spec, packed, levels, g, wt_down, sigma, 2048)))
        torch.cuda.synchronize()
        for a, b in zip(*runs):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ffn_gemm_budget_is_the_kernels(cuda, dtype):
    """The host sizes the FFN kernels' shared memory as the source lays it
    out: _ffn_smem and FG_SMEM_LIMIT give what fg_smem gives, and a width
    that is not built is refused."""
    from fewbit_tpu_torch.ops._build import load_library

    query = load_library().fewbit_ffn_gemm_smem
    for bn in K.FG_TILE_N:
        want = K._ffn_smem(dtype, bn)
        assert want <= K.FG_SMEM_LIMIT
        assert query(bn, int(dtype == torch.bfloat16)) == want
    assert query(128, int(dtype == torch.bfloat16)) == -1


@pytest.mark.cuda
def test_ffn_kernels_refuse_a_misaligned_base_on_cuda(cuda):
    """TMA reads x, g and a bf16 .t() weight in place: a base off a 16-byte
    boundary raises, and nothing is launched."""
    spec, borders, levels = _lut(cuda, 3)
    n, kdim, m = 512, 128, 512
    dt = torch.bfloat16
    x, g, w_up, wt_down, bias, sigma = _ffn_inputs(cuda, dt, n, kdim, m, 1, 0)

    def shifted(t):
        """The same values, starting 2 bytes past a 16-byte boundary."""
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = flat[1:].view(t.shape)
        out.copy_(t)
        assert out.data_ptr() % 16 and out.is_contiguous()
        return out

    _, packed, _ = K.fused_dense_act_sketch(spec, x, w_up, bias, borders,
                                            sigma, n)
    K.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        K.fused_dense_act_sketch(spec, shifted(x), w_up, bias, borders,
                                 sigma, n)
    with pytest.raises(ValueError, match="16-byte"):
        K.fused_dense_act_sketch(spec, x, shifted(w_up.t()).t(), bias,
                                 borders, sigma, n)
    with pytest.raises(ValueError, match="16-byte"):
        K.fused_matmul_lut_backward(spec, packed, levels, shifted(g),
                                    wt_down, sigma, n)
    with pytest.raises(ValueError, match="16-byte"):
        K.fused_matmul_lut_backward(spec, packed, levels, g,
                                    shifted(wt_down.t()).t(), sigma, n)
    assert K.launch_counts() == {name: 0 for name in K.KERNELS}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,c,bits", [(1000, 256, 3), (2048, 384, 5)])
def test_elementwise_kernels_match_plain_on_cuda(cuda, dtype, r, c, bits):
    """Kernels 4 and 5, ragged R included: y within the GELU tolerance
    (erff against torch's erf), the packed words and dx equal."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    gen = torch.Generator(device=cuda).manual_seed(r)
    spec, borders, levels = _lut(cuda, bits)
    x = (torch.randn(r, c, generator=gen, device=cuda) * 2).to(dtype)
    g = torch.randn(r, c, generator=gen, device=cuda).to(dtype)
    K.reset_launch_counts()
    y, packed = K.fused_forward(spec, x, borders)
    y0, packed0 = K.act_forward_plain(spec, x, borders)
    assert (y.float() - y0.float()).abs().max().item() <= tol
    assert torch.equal(packed, packed0)
    dx = K.fused_backward(spec, packed, levels, g)
    assert torch.equal(dx, K.act_backward_plain(spec, packed0, levels, g))
    torch.cuda.synchronize()
    assert (K.fused_forward.launches, K.fused_backward.launches) == (1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,c,bits", [(1000, 100, 3), (77, 12, 1),
                                      (2049, 3076, 5), (33, 1, 2),
                                      (8192, 3072, 3)])
@pytest.mark.parametrize("offset", [0, 1])
def test_act_forward_takes_any_width_on_cuda(cuda, dtype, r, c, bits,
                                             offset):
    """Kernel 4 at any (R, C): R % 32 != 0, C not a multiple of 8 (or of
    4), a base one element off 16 bytes (each element read alone), and the
    path's shape; builtin LUTs and a custom 32-level one.  The decoded codes
    equal the plain version's, y within the tolerance, and the values at a
    border, +-inf and NaN code as compare_codes says."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    gen = torch.Generator(device=cuda).manual_seed(r + c)
    spec, borders, _ = _lut(cuda, bits)
    flat = torch.randn(r * c + offset, generator=gen, device=cuda) * 2
    special = torch.cat([borders, torch.tensor(
        [float("inf"), -float("inf"), float("nan")], device=cuda)])
    n = min(special.numel(), r * c)
    flat[offset:offset + n] = special[:n]
    x = flat.to(dtype)[offset:].view(r, c)
    assert (x.data_ptr() % 16 != 0) == bool(offset)
    y, packed = K.fused_forward(spec, x, borders)
    y0, packed0 = K.act_forward_plain(spec, x, borders)
    assert torch.equal(unpack_codes(packed, spec.bits, r),
                       unpack_codes(packed0, spec.bits, r))
    assert torch.equal(packed, packed0)  # rows past R: zero bits in both
    fin = torch.isfinite(y0)
    assert torch.equal(fin, torch.isfinite(y))
    err = (y.float() - y0.float())[fin].abs().max().item()
    assert err <= tol * max(1.0, y0.float()[fin].abs().max().item()), err
    # Two launches, equal bits.
    y2, packed2 = K.fused_forward(spec, x, borders)
    assert torch.equal(packed2, packed)
    assert torch.equal(y2.view(torch.int16 if dtype == torch.bfloat16
                               else torch.int32),
                       y.view(torch.int16 if dtype == torch.bfloat16
                              else torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,trans", [(1000, True), (512, False)])
def test_dense_act_kernel_matches_plain_on_cuda(cuda, dtype, n, trans):
    """Kernel 6 with ragged N and either weight layout; its codes decode
    with kernel 5."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    gen = torch.Generator(device=cuda).manual_seed(n)
    kdim, m = 256, 384
    spec, borders, levels = resolve_activation("gelu", bits=3, device=cuda)
    x = torch.randn(n, kdim, generator=gen, device=cuda).to(dtype)
    w = (torch.randn(m, kdim, generator=gen, device=cuda) * 0.06).to(dtype)
    w = w.t() if trans else w.t().contiguous()
    bias = (torch.randn(m, generator=gen, device=cuda) * 0.1).to(dtype)
    y, packed = K.fused_dense_act(spec, x, w, bias, borders)
    y0, packed0 = K.dense_act_plain(spec, x, w, bias, borders)
    err = (y.float() - y0.float()).abs().max().item()
    assert err <= tol * max(1.0, y0.float().abs().max().item()), err
    flips = unpack_codes(packed, 3, n) != unpack_codes(packed0, 3, n)
    assert flips.float().mean().item() <= 1e-4
    g = torch.randn(n, m, generator=gen, device=cuda).to(dtype)
    dz = K.fused_backward(spec, packed, levels, g)
    dz0 = K.act_backward_plain(spec, packed, levels, g)
    assert torch.equal(dz, dz0)


@pytest.mark.cuda
def test_wrappers_refuse_outside_envelope_on_cuda(cuda):
    x = torch.randn(1000, 128, device=cuda)
    w = torch.randn(128, 128, device=cuda)
    sigma = torch.ones(1000, device=cuda)
    with pytest.raises(ValueError):
        K.fused_matmul_input_sketch(x, w, None, sigma, 512)
    with pytest.raises(ValueError):
        K.fused_matmul_input_sketch(x[:512].double(), w.double(), None,
                                    sigma[:512], 256)
    spec, borders, levels = resolve_activation("gelu", bits=3, device=cuda)
    # Kernel 4 takes any C (test_act_forward_takes_any_width_on_cuda);
    # kernel 5 C a multiple of 128.
    _, narrow = K.fused_forward(spec, x[:, :100].contiguous(), borders)
    with pytest.raises(ValueError):  # C not a multiple of 128
        K.fused_backward(spec, narrow, levels, x[:, :100].contiguous())
    with pytest.raises(ValueError):
        K.fused_forward(spec, x.double(), borders)
    _, packed = K.fused_forward(spec, x, borders)
    with pytest.raises(ValueError):  # packed for other rows
        K.fused_backward(spec, packed, levels, x[:512])
    with pytest.raises(ValueError):  # K not a multiple of 128
        K.fused_dense_act(spec, x[:, :100].contiguous(), w[:100], None,
                          borders)
    wide, wb, wv = resolve_activation(
        "gelu", borders=torch.linspace(-3, 3, 127).tolist(),
        values=torch.linspace(0, 1, 128).tolist(), device=cuda)
    with pytest.raises(ValueError):  # 7 bits
        K.fused_forward(wide, x, wb)


# Kernel 2' cases: (K, M) -> its route per dtype.  768 -> 3072 is the
# path shape (96-wide, half the f32 slices straddle two k tiles); 1024 ->
# 3072 takes 64 in f32 (96 in bf16); 256 -> 512 is 64-wide; 1024 -> 512
# has no room for the f32 slice (kernel 2, then the separate pass).
SKETCH_X_ROUTES = {
    (768, 3072): {torch.float32: (True, 96), torch.bfloat16: (True, 96)},
    (1024, 3072): {torch.float32: (True, 64), torch.bfloat16: (True, 96)},
    (256, 512): {torch.float32: (True, 64), torch.bfloat16: (True, 64)},
    (1024, 512): {torch.float32: (False, 64), torch.bfloat16: (True, 64)},
}


# Kernel 2''s activations: GELU's own build, and the build for any other
# spec with a predicate (relu) and a continuous id on border codes (silu).
SKETCH_X_ACTS = ("gelu", "relu", "silu")


def _sketch_x_args(cuda, dtype, n, kdim, m, k_eff, seed, act="gelu"):
    spec, borders, _ = (_lut(cuda, 3) if act == "gelu"
                        else resolve_activation(act, device=cuda))
    x, _, w_up, _, bias, sigma = _ffn_inputs(cuda, dtype, n, kdim, m, 1,
                                             seed)
    gen = torch.Generator(device=cuda).manual_seed(seed + 1)
    sigma_x = torch.randint(0, 2, (n,), generator=gen,
                            device=cuda).float() * 2 - 1
    return (spec, x, w_up, bias, borders, sigma, k_eff, sigma_x)


def _nan_outputs(like):
    """Outputs filled so that an element a kernel leaves unwritten cannot
    pass: NaN, and all bits set in the code words."""
    return tuple(torch.full_like(t, -1 if t.dtype == torch.int32
                                 else float("nan")) for t in like)


@pytest.mark.cuda
@pytest.mark.parametrize("act", SKETCH_X_ACTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("passes", [1, 4])
@pytest.mark.parametrize("kdim,m", list(SKETCH_X_ROUTES))
def test_dense_act_sketch_x_matches_plain_on_cuda(cuda, kdim, m, passes,
                                                  dtype, act):
    """Kernel 2': the sketch of x beside kernel 2's outputs, on the route
    dense_act_sketch_x_route gives (fused at 96 or 64, or the separate
    pass), into outputs filled first, two launches equal to the bit; codes
    flipped only near a border or a predicate's threshold."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    n = 2048
    args = _sketch_x_args(cuda, dtype, n, kdim, m, n // passes,
                          kdim + m + passes, act)
    fused, bn = K.dense_act_sketch_x_route(kdim, m, dtype)
    assert (fused, bn) == SKETCH_X_ROUTES[kdim, m][dtype]
    want = K.dense_act_sketch_x_plain(*args)
    K.reset_launch_counts()
    got = K.fused_dense_act_sketch_x(*args, out=_nan_outputs(want))
    again = K.fused_dense_act_sketch_x(*args, out=_nan_outputs(want))
    torch.cuda.synchronize()
    spec, x, w_up, bias, borders = args[:5]
    for name, a, b in zip(("y", "packed", "sketch_y", "sketch_x"), got,
                          want):
        if name == "packed":
            assert a.dtype == b.dtype and a.shape == b.shape
            _flips_ok(a, b, K.dot_f32(x, w_up) + bias.float(),
                      _edges(spec, borders), spec.bits)
        else:
            _close(name, a, b, tol)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    assert K.launch_counts() == {name: 0 for name in K.KERNELS} | {
        "dense_act_sketch_x": 2}
    assert K.input_sketch.launches == (0 if fused else 2)


@pytest.mark.cuda
@pytest.mark.parametrize("act", SKETCH_X_ACTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_act_sketch_x_simt_matches_plain_on_cuda(cuda, dtype, act):
    """The first, CUDA-core kernel of 2' (on no path) against the plain
    version; codes flipped only near a border or a predicate's
    threshold."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    args = _sketch_x_args(cuda, dtype, 2048, 256, 512, 512, 2, act)
    K.reset_launch_counts()
    got = K.dense_act_sketch_x_simt(*args)
    want = K.dense_act_sketch_x_plain(*args)
    torch.cuda.synchronize()
    spec, x, w_up, bias, borders = args[:5]
    for name, a, b in zip(("y", "packed", "sketch_y", "sketch_x"), got,
                          want):
        if name == "packed":
            _flips_ok(a, b, K.dot_f32(x, w_up) + bias.float(),
                      _edges(spec, borders), spec.bits)
        else:
            _close(name, a, b, tol)
    assert K.dense_act_sketch_x_simt.launches == 1
    assert K.launch_counts() == {name: 0 for name in K.KERNELS}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("colsum", [False, True])
def test_input_sketch_matches_plain_on_cuda(cuda, dtype, colsum):
    """The separate sketch pass alone, with and without the column sum,
    into outputs filled first."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    n, kdim, k_eff = 8192, 768, 2048
    x = torch.randn(n, kdim, generator=gen, device=cuda).to(dtype)
    sigma = torch.randint(0, 2, (n,), generator=gen,
                          device=cuda).float() * 2 - 1
    want = K.input_sketch_plain(x, sigma, k_eff, colsum)
    want = want if colsum else (want,)
    K.reset_launch_counts()
    got = K.input_sketch(x, sigma, k_eff, colsum, out=_nan_outputs(want))
    torch.cuda.synchronize()
    got = got if colsum else (got,)
    _close("sketch", got[0], want[0],
           1e-4 if dtype == torch.float32 else 2e-2)
    if colsum:
        _close("colsum", got[1], want[1], 1e-3)
    assert K.input_sketch.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_act_sketch_x_budget_is_the_kernels(cuda, dtype):
    """The host sizes kernel 2''s shared memory as the source lays it out:
    over K up to 4096 and M up to 8192, both widths, _sketch_x_smem within
    FG_SMEM_LIMIT gives what sketch_x_smem gives, and -1 beyond it or for
    a width that does not divide M or is not built."""
    from fewbit_tpu_torch.ops._build import load_library

    query = load_library().fewbit_dense_act_sketch_x_smem
    bf16 = int(dtype == torch.bfloat16)
    for kdim in range(128, 4097, 128):
        for m in range(512, 8193, 512):
            for bn in K.FG_TILE_N:
                want = K._sketch_x_smem(dtype, bn, kdim, m)
                if m % bn or want > K.FG_SMEM_LIMIT:
                    want = -1
                assert query(kdim, m, bn, bf16) == want, (kdim, m, bn)
    assert query(768, 3072, 128, bf16) == -1


def _flash_inputs(cuda, dtype, b, h, s, seed, sk=None, contiguous=False,
                  d=64):
    """(b, h, s, d) q and dO, (b, h, sk, d) k and v, as the models pass
    them (transposed views of (b, s, h, d) tensors) or contiguous, and
    padded segment ids of both sides (every batch row keeps at least one
    padded position where the two lengths differ)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    sk = s if sk is None else sk

    def rand(n):
        if contiguous:
            return torch.randn(b, h, n, d, generator=gen,
                               device=cuda).to(dtype)
        return (torch.randn(b, n, h, d, generator=gen, device=cuda)
                .to(dtype).transpose(1, 2))

    def ids(n):
        top = n + 1 if sk == s else n
        lengths = torch.randint(n // 2, max(top, n // 2 + 1), (b,),
                                generator=gen, device=cuda)
        return (torch.arange(n, device=cuda)[None] < lengths[:, None]).int()

    q, k, v, do = rand(s), rand(sk), rand(sk), rand(s)
    ids_q = ids(s)
    return (q, k, v, do), ids_q, (ids_q if sk == s else ids(sk))


_FLASH_SHAPES = [
    (1000, 1000, True, True, False), (1000, 1000, False, False, False),
    (256, 256, True, False, False), (128, 128, False, True, False),
    (64, 64, True, False, False), (65, 65, False, False, True),
    (127, 127, True, True, True), (2048, 2048, True, False, False),
    (2048, 2048, False, True, True), (300, 1000, False, True, False),
    (1000, 300, True, False, False), (65, 127, False, False, True),
    (127, 64, True, False, True), (1, 1, True, True, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,sk,causal,seg,contiguous", _FLASH_SHAPES)
def test_flash_kernels_match_plain_on_cuda(cuda, dtype, s, sk, causal, seg,
                                           contiguous):
    """F1-F3 against their plain versions: ragged sequences, sq != sk,
    transposed views and contiguous operands, segment ids with and without
    the causal mask.  F1-F3 on the tensor cores, into outputs filled with
    NaN so that an element left unwritten cannot pass, twice for equal bits,
    and by the CUDA-core kernels they replaced."""
    _flash_against_plain(cuda, dtype, s, sk, causal, seg, contiguous, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,sk,causal,seg,contiguous", _FLASH_SHAPES)
def test_flash_kernels_match_plain_at_other_head_dims(
        cuda, dtype, s, sk, causal, seg, contiguous, d):
    """The same at head dimensions 32 and 128 (bf16 rows of 64 bytes and
    the 64-byte swizzle at 32; one consumer warpgroup and 32-row tiles in
    f32 at 128), without the CUDA-core kernels, which take 64 only."""
    _flash_against_plain(cuda, dtype, s, sk, causal, seg, contiguous, d)


# Head dimensions of every instantiation but 32, 64 and 128 (the tests
# above), and head dimensions that are not multiples of 16, which the
# wrappers copy into zero-padded operands of the next instantiation's
# width and copy back (40, 72, 20, 100, 6 and 1).
NEW_HEAD_DIMS = [16, 48, 80, 96, 112, 40, 72, 20, 100, 6, 1]
_NEW_HEAD_DIM_SHAPES = [(1000, 1000, True, True, False),
                        (300, 1000, False, True, False),
                        (1000, 300, True, False, False),
                        (127, 127, True, True, True),
                        (65, 127, False, False, True),
                        (1, 1, True, True, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", NEW_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,sk,causal,seg,contiguous", _NEW_HEAD_DIM_SHAPES)
def test_flash_kernels_match_plain_at_every_head_dim(
        cuda, dtype, s, sk, causal, seg, contiguous, d):
    """The same at the other instantiations (16, 48, 80, 96 and 112: rows
    in 32- and 64-byte sub-tiles, wgmma's N = d) and at head dimensions
    below their instantiation, through zero-padded copies; the outputs are
    views of wider buffers filled with NaN, whose columns past d must stay
    NaN: nothing is stored past d."""
    _flash_against_plain(cuda, dtype, s, sk, causal, seg, contiguous, d,
                         wide=True)


# Head dimensions of the wide kernels (every multiple of 128 above 128, as
# d / 128 chunks of 128 columns: F1 two chunks a block, F2 and F3 one to
# four, K._flash_wide_groups): 256 (Pythia-1B's heads), 384 and 512.
WIDE_HEAD_DIMS = [256, 384, 512]
_WIDE_HEAD_DIM_SHAPES = [(1000, 1000, True, True, False),
                         (1000, 1000, False, True, True),
                         (300, 1000, False, True, False),
                         (1000, 300, True, False, False),
                         (127, 127, True, True, True),
                         (65, 127, False, False, True),
                         (1, 1, True, True, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", WIDE_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,sk,causal,seg,contiguous", _WIDE_HEAD_DIM_SHAPES)
def test_flash_kernels_match_plain_at_wide_head_dims(
        cuda, dtype, s, sk, causal, seg, contiguous, d):
    """The same on the wide kernels at head dimensions 256, 384 and 512:
    ragged sequences, sq != sk, causal, padded and segment ids, into views
    of NaN-filled buffers 16 columns wider whose columns past d must stay
    NaN, twice for equal bits (the blocks of a row tile share nothing but
    their inputs)."""
    _flash_against_plain(cuda, dtype, s, sk, causal, seg, contiguous, d,
                         wide=True)


# The wide backward's own tiles and grids (64 own rows a block; looped
# tiles of 64 rows in bf16 and 32 in f32; two output chunks a block): sq !=
# sk with tails of both sides that no tile divides, segment ids (three
# documents) and padding at c = 2 (bf16: the own rows resident, the ring
# held for the second products) and c = 4 (two blocks a row tile, the
# chunks again in part 2), and the odd c = 3 (a block of one chunk).
_WIDE_BWD_CASES = [(256, 333, 517, False, "segments"),
                   (256, 517, 333, True, "padded"),
                   (256, 200, 200, True, "segments"),
                   (512, 200, 200, False, "padded"),
                   (512, 333, 517, True, "segments"),
                   (384, 97, 301, True, "padded"),
                   (384, 301, 97, False, "segments")]


def _wide_ids(b, n, n0, mask, cuda):
    """``(b, n)`` int32 ids: three documents of unequal length, or the
    padding of a batch row that keeps 3 n0 / 4 of its positions.  Their
    borders lie at the same positions on both sides (n0 = min(sq, sk)), so
    that every query row keeps a key: a row whose every key is masked is
    left to the tiles a kernel skips, as in the library's kernels, and its
    gradient is not the plain version's."""
    pos = torch.arange(n, device=cuda)
    if mask == "segments":
        ids = (pos >= n0 // 5).int() + (pos >= n0 // 2).int()
    else:
        ids = (pos < n0 * 3 // 4).int()
    return ids[None].repeat(b, 1).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,sq,sk,causal,mask", _WIDE_BWD_CASES,
                         ids=[f"d{c[0]}_{c[1]}x{c[2]}_"
                              f"{'causal' if c[3] else 'full'}_{c[4]}"
                              for c in _WIDE_BWD_CASES])
def test_flash_wide_backward_tails_and_masks(cuda, dtype, d, sq, sk, causal,
                                             mask):
    """The wide F2 and F3 at those shapes against their plain versions
    (on the kernel's own lse and di) and against an f64 evaluation of the
    function, both within TOL (1e-4 in f32, 2e-2 in bf16, of the largest
    element), into NaN-filled views whose columns past d stay NaN, and a
    second launch to the bit."""
    _backward_tails_and_masks(cuda, dtype, d, sq, sk, causal, mask)


# F2 and F3 at the instantiations above 64 and at head dimensions that run
# on them through zero-padded copies (72, 100): bf16 on the wide
# backward's schedule at one chunk of d columns (64 own rows a block, two
# warpgroups splitting the products by operand, F3's dQ columns split
# between them unevenly at 80, 96 and 112), f32 on one warpgroup over
# 32-row tiles; a causal sequence of 1000 (a tail of 40 rows past the last
# 64-row tile), sq != sk both ways with padding and segment ids.
_NARROW_BWD_CASES = [(1000, 1000, True, "padded"),
                     (1000, 1000, False, "segments"),
                     (333, 517, True, "segments"),
                     (517, 333, False, "padded")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [72, 80, 96, 100, 112, 128])
@pytest.mark.parametrize("sq,sk,causal,mask", _NARROW_BWD_CASES,
                         ids=[f"{c[0]}x{c[1]}_"
                              f"{'causal' if c[2] else 'full'}_{c[3]}"
                              for c in _NARROW_BWD_CASES])
def test_flash_backward_tails_and_masks_above_64(cuda, dtype, d, sq, sk,
                                                 causal, mask):
    """F2 and F3 at head dimensions 72 to 128 as the wide ones above:
    against their plain versions and f64 within TOL, every element written
    (NaN-filled views, nothing stored past d), two launches to the bit."""
    _backward_tails_and_masks(cuda, dtype, d, sq, sk, causal, mask)


def _backward_tails_and_masks(cuda, dtype, d, sq, sk, causal, mask):
    """F2 and F3 at one shape and mask, as the two tests above hold them."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    b, h = 2, 3
    gen = torch.Generator(device=cuda).manual_seed(d + sq)
    q, k, v, do = (torch.randn(b, n, h, d, generator=gen, device=cuda)
                   .to(dtype).transpose(1, 2) for n in (sq, sk, sk, sq))
    n0 = min(sq, sk)
    seg_q, seg_kv = (_wide_ids(b, n, n0, mask, cuda) for n in (sq, sk))
    scale = d ** -0.5
    o, lse = K.flash_forward(q, k, v, seg_q, seg_kv, causal, scale)
    di = (o.float() * do.float()).sum(-1)
    bargs = (q, k, v, seg_q, seg_kv, lse, do, di, causal, scale)
    nan, bufs = _flash_nan_outputs((k, v, q), True)
    dk, dv = K.flash_backward_dkv(*bargs, out=nan[:2])
    dq = K.flash_backward_dq(*bargs, out=nan[2:])
    plain = {"dk": None, "dv": None}
    plain["dk"], plain["dv"] = flash_backward_dkv_plain(*bargs)
    plain["dq"] = flash_backward_dq_plain(*bargs)
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    o64, lse64 = flash_forward_plain(q64, k64, v64, seg_q, seg_kv, causal,
                                     scale)
    exact = dict(zip(("dq", "dk", "dv"), flash_backward_plain(
        q64, k64, v64, seg_q, seg_kv, o64, lse64, do64, causal, scale)))
    torch.cuda.synchronize()
    for buf in bufs:
        assert bool(buf[..., d:].isnan().all()), "stored past d"
    for name, got in (("dq", dq), ("dk", dk), ("dv", dv)):
        for ref, want in (("plain", plain[name]), ("f64", exact[name])):
            err = (got.double() - want.double()).abs().max().item()
            bound = tol * max(1.0, want.double().abs().max().item())
            assert err <= bound, (name, ref, err, bound)
    dk2, dv2 = K.flash_backward_dkv(*bargs)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert torch.equal(dq, K.flash_backward_dq(*bargs))


# The wide forward's own tiles and grids (64 query rows per consumer
# warpgroup, two of them in bf16; kv tiles of 64 rows in bf16 and 32 in
# f32; two chunks of o a block, K._flash_wide_fwd): sq != sk with tails of
# both sides that no tile divides, segment ids and padding at c = 2 (one
# block a row tile, the query rows resident), the odd c = 3 (a block of
# one chunk), c = 4 (bf16: resident beside six stages) and c = 5 (the
# query rows streamed in both types).
_WIDE_FWD_CASES = [(256, 333, 517, True, "segments"),
                   (256, 517, 333, False, "padded"),
                   (384, 333, 517, False, "segments"),
                   (384, 517, 333, True, "padded"),
                   (512, 200, 200, True, "segments"),
                   (512, 333, 517, False, "padded"),
                   (640, 301, 97, True, "segments"),
                   (640, 97, 301, False, "padded")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,sq,sk,causal,mask", _WIDE_FWD_CASES,
                         ids=[f"d{c[0]}_{c[1]}x{c[2]}_"
                              f"{'causal' if c[3] else 'full'}_{c[4]}"
                              for c in _WIDE_FWD_CASES])
def test_flash_wide_forward_tails_and_masks(cuda, dtype, d, sq, sk, causal,
                                            mask):
    """The wide F1 at those shapes against its plain version and against
    an f64 evaluation of the function, both within TOL (1e-4 in f32, 2e-2
    in bf16, of the largest element), into a NaN-filled view whose columns
    past d stay NaN and a NaN-filled lse, a second launch to the bit; and
    with V's chunks all equal, o's chunks are equal to the bit: the blocks
    of a row tile (and a block's two chunks) hold the same m and l."""
    (q, k, v, seg_q, seg_kv, causal, scale), o, lse = _forward_tails_and_masks(
        cuda, dtype, d, sq, sk, causal, mask)
    chunks = d // 128
    same_v = v[..., :128].repeat(1, 1, 1, chunks)
    o3, lse3 = K.flash_forward(q, k, same_v, seg_q, seg_kv, causal, scale)
    assert torch.equal(lse3, lse)
    for j in range(1, chunks):
        assert torch.equal(o3[..., 128 * j:128 * (j + 1)], o3[..., :128]), j
    assert K.launch_counts()["flash_forward"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [72, 80, 96, 100, 112, 128])
@pytest.mark.parametrize("sq,sk,causal,mask", _NARROW_BWD_CASES,
                         ids=[f"{c[0]}x{c[1]}_"
                              f"{'causal' if c[2] else 'full'}_{c[3]}"
                              for c in _NARROW_BWD_CASES])
def test_flash_forward_tails_and_masks_above_64(cuda, dtype, d, sq, sk,
                                                causal, mask):
    """F1 at head dimensions 72 to 128 (bf16: its producer warp reads the
    segment ids a tile ahead; 72 and 100 through zero-padded copies) at
    the backward's shapes above: a causal sequence of 1000 (a tail past
    the last kv tile and the last block of query rows), sq != sk both ways
    with padding and segment ids; against the plain version and f64 within
    TOL, every element written (NaN-filled views, nothing stored past d),
    two launches to the bit."""
    _forward_tails_and_masks(cuda, dtype, d, sq, sk, causal, mask)


def _forward_tails_and_masks(cuda, dtype, d, sq, sk, causal, mask):
    """F1 at one shape and mask, as the two tests above hold it; returns
    its arguments, o and lse (two launches counted)."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    b, h = 2, 3
    gen = torch.Generator(device=cuda).manual_seed(d + sq + 1)
    q, k, v = (torch.randn(b, n, h, d, generator=gen, device=cuda)
               .to(dtype).transpose(1, 2) for n in (sq, sk, sk))
    n0 = min(sq, sk)
    seg_q, seg_kv = (_wide_ids(b, n, n0, mask, cuda) for n in (sq, sk))
    scale = d ** -0.5
    fargs = (q, k, v, seg_q, seg_kv, causal, scale)
    (o_out,), bufs = _flash_nan_outputs((q,), True)
    lse_out = torch.full((b, h, sq), float("nan"), device=cuda)
    K.reset_launch_counts()
    o, lse = K.flash_forward(*fargs, out=(o_out, lse_out))
    assert o is o_out and lse is lse_out
    o0, lse0 = flash_forward_plain(*fargs)
    o64, lse64 = flash_forward_plain(*(t.double() for t in (q, k, v)),
                                     seg_q, seg_kv, causal, scale)
    torch.cuda.synchronize()
    assert bool(bufs[0][..., d:].isnan().all()), "stored past d"
    for name, got, pair in (("o", o, (o0, o64)), ("lse", lse, (lse0, lse64))):
        for ref, want in zip(("plain", "f64"), pair):
            err = (got.double() - want.double()).abs().max().item()
            bound = tol * max(1.0, want.double().abs().max().item())
            assert err <= bound, (name, ref, err, bound)
    o2, lse2 = K.flash_forward(*fargs)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert K.launch_counts()["flash_forward"] == 2
    return fargs, o, lse


def _flash_nan_outputs(likes, wide):
    """NaN-filled outputs like ``likes``; with ``wide``, views of the first
    d columns of buffers 16 columns wider (and the buffers)."""
    if not wide:
        outs = [torch.full_like(t, float("nan")) for t in likes]
        return outs, outs
    bufs = [torch.full((*t.shape[:-1], t.shape[-1] + 16), float("nan"),
                       dtype=t.dtype, device=t.device) for t in likes]
    return [b[..., :t.shape[-1]] for b, t in zip(bufs, likes)], bufs


def _flash_against_plain(cuda, dtype, s, sk, causal, seg, contiguous, d,
                         wide=False):
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    simt = d == 64
    (q, k, v, do), ids_q, ids_kv = _flash_inputs(cuda, dtype, 2, 3, s,
                                                 s + causal, sk, contiguous,
                                                 d)
    seg_q, seg_kv = (ids_q, ids_kv) if seg else (None, None)
    scale = d ** -0.5 if wide else 0.125
    K.reset_launch_counts()
    o0, lse0 = flash_forward_plain(q, k, v, seg_q, seg_kv, causal, scale)
    (o_out,), bufs = _flash_nan_outputs((q,), wide)
    fout = (o_out, torch.full_like(lse0, float("nan")))
    o, lse = K.flash_forward(q, k, v, seg_q, seg_kv, causal, scale,
                             out=fout)
    assert o is fout[0] and lse is fout[1]
    assert wide or o.stride() == q.stride()
    o2, lse2 = K.flash_forward(q, k, v, seg_q, seg_kv, causal, scale)
    assert o2.stride() == q.stride()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    if simt:
        os_, lses = K.flash_forward_simt(q, k, v, seg_q, seg_kv, causal,
                                         scale)
    di = (o.float() * do.float()).sum(-1)
    bargs = (q, k, v, seg_q, seg_kv, lse, do, di, causal, scale)
    nan, more = _flash_nan_outputs((k, v, q), wide)
    bufs += more
    dk, dv = K.flash_backward_dkv(*bargs, out=nan[:2])
    dq = K.flash_backward_dq(*bargs, out=nan[2:])
    assert all(a is b for a, b in zip((dk, dv, dq), nan))
    dq0, dk0, dv0 = flash_backward_plain(q, k, v, seg_q, seg_kv, o0, lse0,
                                         do, causal, scale)
    pairs = [("o", o, o0), ("lse", lse, lse0), ("dq", dq, dq0),
             ("dk", dk, dk0), ("dv", dv, dv0)]
    if simt:
        dks, dvs = K.flash_backward_dkv_simt(*bargs)
        dqs = K.flash_backward_dq_simt(*bargs)
        pairs += [("o simt", os_, o0), ("lse simt", lses, lse0),
                  ("dq simt", dqs, dq0), ("dk simt", dks, dk0),
                  ("dv simt", dvs, dv0)]
    torch.cuda.synchronize()
    if wide:
        for buf in bufs:
            assert bool(buf[..., d:].isnan().all()), "stored past d"
    else:
        assert (dk.stride(), dv.stride(), dq.stride()) == (
            k.stride(), v.stride(), q.stride())
    for name, a, b in pairs:
        err = (a.float() - b.float()).abs().max().item()
        assert err <= tol * max(1.0, b.float().abs().max().item()), \
            (name, err)
    # Nothing is summed across blocks: a second launch gives the same bits.
    dk2, dv2 = K.flash_backward_dkv(*bargs)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    assert torch.equal(dq, K.flash_backward_dq(*bargs))
    assert [K.launch_counts()[n] for n in ("flash_forward",
                                           "flash_backward_dkv",
                                           "flash_backward_dq")] == [2, 2, 2]
    assert K.flash_forward_simt.launches == int(simt)
    assert K.flash_backward_dkv_simt.launches == int(simt)
    assert K.flash_backward_dq_simt.launches == int(simt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [129, 144, 192, 200])
def test_flash_kernels_refuse_other_head_dims(cuda, dtype, d):
    """Outside FLASH_HEAD_DIMS (1 to 128 and every multiple of 128 above)
    every tensor-core wrapper raises,
    with the head dimension in its message: nothing falls back to a plain
    version; the CUDA-core kernels take 64 only."""
    (q, k, v, do), _, _ = _flash_inputs(cuda, dtype, 2, 2, 96, 3,
                                        contiguous=True, d=d)
    lse = torch.zeros(2, 2, 96, device=cuda)
    before = K.launch_counts()
    with pytest.raises(ValueError, match=f"head dimension {d}"):
        K.flash_forward(q, k, v, None, None, True, 0.125)
    for wrapper in (K.flash_backward_dkv, K.flash_backward_dq,
                    K.flash_backward_dkv_simt, K.flash_backward_dq_simt):
        with pytest.raises(ValueError, match=f"head dimension {d}"):
            wrapper(q, k, v, None, None, lse, do, lse, True, 0.125)
    assert K.launch_counts() == before
    (q, k, v, do), _, _ = _flash_inputs(cuda, dtype, 2, 2, 96, 3, d=32)
    with pytest.raises(ValueError, match="head dimension 32"):
        K.flash_forward_simt(q, k, v, None, None, True, 0.125)


@pytest.mark.cuda
def test_flash_smem_matches_the_source(cuda):
    """_flash_smem, the host's mirror, gives what the source's ff_smem and
    hb_smem give for every kernel, type and instantiation, each within the
    232,448 bytes a block may have; -1 for another head dimension."""
    from fewbit_tpu_torch.ops._build import load_library

    query = load_library().fewbit_flash_smem
    for i, name in enumerate(("flash_forward", "flash_backward_dkv",
                              "flash_backward_dq")):
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = int(dtype == torch.bfloat16)
            for d in (*K.FLASH_INSTANCES, 256, 384, 512, 1280):
                want = K._flash_smem(name, dtype, d)
                assert query(i, bf16, d) == want, (name, dtype, d)
                assert want <= K.FLASH_SMEM_LIMIT
            for d in (0, 8, 136, 144, 192, 200, 257):
                assert query(i, bf16, d) == -1, (name, dtype, d)
            for d in (100, 144):
                assert query(i, bf16, d) == -1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_refuses_what_tma_cannot_read(cuda, dtype):
    """A base or a stride that is not a multiple of 16 bytes: the
    tensor-core wrappers of F1-F3 raise (nothing falls back); the CUDA-core
    kernels take such operands."""
    b, h, s = 2, 2, 96
    (q, k, v, do), _, _ = _flash_inputs(cuda, dtype, b, h, s, 11,
                                        contiguous=True)
    o, lse = K.flash_forward(q, k, v, None, None, True, 0.125)
    di = (o.float() * do.float()).sum(-1)
    # Rows of 66 elements: unit stride along d, 264 (132) bytes a row.
    wide = torch.zeros(b, h, s, 66, dtype=dtype, device=cuda)[..., :64]
    wide.copy_(k)
    # The same values one element off a 16-byte boundary.
    flat = torch.zeros(k.numel() + 1, dtype=dtype, device=cuda)
    shifted = flat[1:].view(b, h, s, 64)
    shifted.copy_(k)
    want = K.flash_backward_dkv(q, k, v, None, None, lse, do, di, True, 0.125)
    for bad in (wide, shifted):
        with pytest.raises(ValueError, match="16"):
            K.flash_forward(q, bad, v, None, None, True, 0.125)
        for got, ref in zip(K.flash_forward_simt(q, bad, v, None, None, True,
                                                 0.125), (o, lse)):
            err = (got.float() - ref.float()).abs().max().item()
            tol = 1e-4 if dtype == torch.float32 else 2e-2
            assert err <= tol * max(1.0, ref.float().abs().max().item())
        args = (q, bad, v, None, None, lse, do, di, True, 0.125)
        for wrapper in (K.flash_backward_dkv, K.flash_backward_dq):
            with pytest.raises(ValueError, match="16"):
                wrapper(*args)
        for got, ref in zip(K.flash_backward_dkv_simt(*args), want):
            err = (got.float() - ref.float()).abs().max().item()
            tol = 1e-4 if dtype == torch.float32 else 2e-2
            assert err <= tol * max(1.0, ref.float().abs().max().item())
    wide = [torch.zeros(b, h, s, 144, dtype=dtype, device=cuda)
            for _ in range(4)]
    with pytest.raises(ValueError, match="head dimension 144"):
        K.flash_backward_dq(*wide[:3], None, None, lse, wide[3], di)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_repeats_its_bits_under_load(cuda, dtype, causal):
    """Long sequences (up to 64 looped tiles a block, the f32 producers
    refilling their stages while the consumers multiply), F1-F3 launched on
    three streams at once and again and again, so that a block's warps are
    held up differently each time: every launch gives the first one's bits,
    and those agree with the plain versions."""
    _repeats_under_load(cuda, dtype, causal, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_repeats_its_bits_under_load_at_other_head_dims(cuda, dtype,
                                                              causal, d):
    """The same at head dimensions 32 and 128 (at 128 in f32: 128 tiles of
    32 rows a block, through one stage in F2 and F3)."""
    _repeats_under_load(cuda, dtype, causal, d)


def _repeats_under_load(cuda, dtype, causal, d):
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    s = 4096
    (q, k, v, do), _, _ = _flash_inputs(cuda, dtype, 2, 4, s, 21, d=d)
    scale = 0.125
    fargs = (q, k, v, None, None, causal, scale)
    o, lse = K.flash_forward(*fargs)
    di = (o.float() * do.float()).sum(-1)
    bargs = (q, k, v, None, None, lse, do, di, causal, scale)
    first = (*K.flash_backward_dkv(*bargs), K.flash_backward_dq(*bargs), o,
             lse)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda) for _ in range(3)]
    for _ in range(4):
        got = []
        for stream in streams:
            with torch.cuda.stream(stream):
                nan = [torch.full_like(t, float("nan"))
                       for t in (k, v, q, q, lse)]
                K.flash_backward_dkv(*bargs, out=nan[:2])
                K.flash_backward_dq(*bargs, out=nan[2:3])
                K.flash_forward(*fargs, out=nan[3:])
                got.append(nan)
        torch.cuda.synchronize()
        for outs in got:
            for name, a, b in zip(("dk", "dv", "dq", "o", "lse"), outs,
                                  first):
                assert torch.equal(a, b), name
    want = []
    for i in range(q.shape[0]):  # one batch row at a time: (h, s, s) f32
        qi, ki, vi, lsei, doi, dii = (t[i:i + 1]
                                      for t in (q, k, v, lse, do, di))
        pargs = (qi, ki, vi, None, None, lsei, doi, dii, causal, scale)
        want.append((*K.flash_backward_dkv_plain(*pargs),
                     K.flash_backward_dq_plain(*pargs),
                     *flash_forward_plain(qi, ki, vi, None, None, causal,
                                          scale)))
    for j, name in enumerate(("dk", "dv", "dq", "o", "lse")):
        b = torch.cat([w[j] for w in want])
        err = (first[j].float() - b.float()).abs().max().item()
        assert err <= tol * max(1.0, b.float().abs().max().item()), (name,
                                                                     err)


@pytest.mark.cuda
def test_flash_attention_function_on_cuda(cuda):
    """The autograd op on the card: gradients of the plain autograd path,
    and the wrappers refuse what the kernels do not take."""
    (q, k, v, do), ids, _ = _flash_inputs(cuda, torch.float32, 2, 2, 200, 5)
    grads = []
    for use_op in (True, False):
        ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        if use_op:
            out = flash_attention(*ins, SegmentIds(ids, ids), causal=True,
                                  sm_scale=0.125)
        else:
            out = flash_forward_plain(*ins, ids, ids, True, 0.125)[0]
        (out * do).sum().backward()
        grads.append([out.detach()] + [t.grad for t in ins])
    for a, b in zip(*grads):
        err = (a - b).abs().max().item()
        assert err <= 1e-4 * max(1.0, b.abs().max().item()), err
    wide = torch.zeros(*q.shape[:3], 144, device=cuda)
    with pytest.raises(ValueError, match="head dimension 144"):
        K.flash_forward(wide, wide, wide)
    with pytest.raises(ValueError):  # float64
        K.flash_forward(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):  # segment ids for one side only
        K.flash_forward(q, k, v, ids, None)


@pytest.mark.cuda
@pytest.mark.parametrize("loss", ["sum", "sum_over_s"])
def test_flash_attention_backward_takes_expanded_gradients(cuda, loss):
    """A loss whose gradient reaches the op expanded (stride 0 along some or
    all dimensions, which TMA cannot read) is copied first, not refused."""
    (q, k, v, _), ids, _ = _flash_inputs(cuda, torch.float32, 2, 2, 130, 9)
    w = torch.randn(2, 2, 64, device=cuda)
    grads = []
    for use_op in (True, False):
        ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        if use_op:
            out = flash_attention(*ins, SegmentIds(ids, ids), causal=True,
                                  sm_scale=0.125)
        else:
            out = flash_forward_plain(*ins, ids, ids, True, 0.125)[0]
        (out.sum() if loss == "sum" else (out.sum(2) * w).sum()).backward()
        grads.append([t.grad for t in ins])
    for a, b in zip(*grads):
        err = (a - b).abs().max().item()
        assert err <= 1e-4 * max(1.0, b.abs().max().item()), err


# ---------------------------------------------------------------------------
# The four tensor-core schedules of kernel 6.
# ---------------------------------------------------------------------------

_SCHEDULES = {"kloop": K.dense_act_kloop, "direct": K.dense_act_direct,
              "emit": K.dense_act_emit, "pipelined": K.dense_act_pipelined}
_PAIRS = {"f32": (torch.float32, torch.float32),
          "bf16_f32": (torch.bfloat16, torch.float32),
          "bf16": (torch.bfloat16, torch.bfloat16)}


def _schedule_route(schedule, kdim, m, dt, out_dt):
    """The tile width the schedule's envelope gives, None outside it."""
    if schedule == "kloop":
        return K.dense_act_kloop_route(m, dt)
    if schedule == "pipelined":
        return K.dense_act_pipelined_route(m, dt)
    route = (K.dense_act_direct_route if schedule == "direct"
             else K.dense_act_emit_route)
    return route(kdim, m, dt, out_dt)


def _dense_act_inputs(cuda, dt, n, kdim, m, trans, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(n, kdim, generator=gen, device=cuda).to(dt)
    w = (torch.randn(m, kdim, generator=gen, device=cuda)
         * kdim ** -0.5).to(dt)
    w = w.t() if trans else w.t().contiguous()
    bias = (torch.randn(m, generator=gen, device=cuda) * 0.1).to(dt)
    return x, w, bias


@pytest.mark.cuda
@pytest.mark.parametrize("pair", list(_PAIRS))
@pytest.mark.parametrize("bits", [1, 3, 5])
@pytest.mark.parametrize("trans", [1, 0])
@pytest.mark.parametrize("kdim", [128, 768, 1024])
@pytest.mark.parametrize("m", [128, 512, 3072])
@pytest.mark.parametrize("schedule", list(_SCHEDULES))
def test_dense_act_schedules_match_plain_on_cuda(cuda, schedule, m, kdim,
                                                 trans, bits, pair):
    """Each schedule against the one plain version: 64- and 96-wide tiles,
    both weight layouts, with and without bias, 1, 3 and 5 (custom LUT)
    bits, the three type pairs, N = 8192, a ragged N and an N under one
    tile.  Outside its envelope a schedule raises and launches nothing."""
    dt, out_dt = _PAIRS[pair]
    tol = 1e-4 if out_dt == torch.float32 else 2e-2
    wrapper = _SCHEDULES[schedule]
    spec, borders, _ = _lut(cuda, bits)
    x, w, bias = _dense_act_inputs(cuda, dt, 8192, kdim, m, trans,
                                   m + kdim + bits)
    K.reset_launch_counts()
    name = f"dense_act_{schedule}"
    if _schedule_route(schedule, kdim, m, dt, out_dt) is None:
        assert schedule in ("direct", "emit")
        with pytest.raises(ValueError, match="envelope"):
            wrapper(spec, x, w, bias, borders, out_dt)
        assert K.launch_counts() == {k: 0 for k in K.KERNELS}
        return
    calls = 0
    for n in (8192, 1000, 100):
        for b in (bias, None):
            y, packed = wrapper(spec, x[:n], w, b, borders, out_dt)
            y0, packed0 = K.dense_act_plain(spec, x[:n], w, b, borders,
                                            out_dt)
            torch.cuda.synchronize()
            calls += 1
            _close(f"y n={n}", y, y0, tol)
            assert packed.dtype == packed0.dtype
            assert packed.shape == packed0.shape
            z0 = K.dot_f32(x[:n], w)
            if b is not None:
                z0 = z0 + b.float()
            _flips_ok(packed, packed0, z0, borders, spec.bits)
    assert K.launch_counts() == {k: 0 for k in K.KERNELS} | {name: calls}


@pytest.mark.cuda
@pytest.mark.parametrize("pair", list(_PAIRS))
@pytest.mark.parametrize("n,m", [(8192, 3072), (1000, 512)])
def test_dense_act_kloop_ablation_on_cuda(cuda, pair, n, m):
    """The k loop without its epilogue: z and one plane of zero words."""
    dt, out_dt = _PAIRS[pair]
    tol = 1e-4 if out_dt == torch.float32 else 2e-2
    spec, borders, _ = _lut(cuda, 3)
    x, w, bias = _dense_act_inputs(cuda, dt, n, 768, m, 1, n)
    z, packed = K.dense_act_kloop(spec, x, w, bias, borders, out_dt,
                                  epilogue=False)
    z0, packed0 = K.dense_act_plain(spec, x, w, bias, borders, out_dt,
                                    epilogue=False)
    torch.cuda.synchronize()
    _close("z", z, z0, tol)
    assert packed.shape == packed0.shape == (1, -(-n // 32), m)
    assert torch.equal(packed, packed0)
    with pytest.raises(ValueError, match="ablation"):
        K._dense_act_tensor_core("pipelined", spec, x, w, bias, borders,
                                 out_dt, epilogue=False)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("schedule", list(_SCHEDULES) + ["simt", "shipped"])
def test_dense_act_schedules_are_deterministic_on_cuda(cuda, schedule,
                                                       dtype):
    """Two calls give bitwise-equal y and codes (no sum is shared between
    threads), and the codes decode with kernel 5 as the plain ones do."""
    spec, borders, levels = _lut(cuda, 3)
    kdim = 768 if dtype == torch.bfloat16 else 128  # inside every envelope
    x, w, bias = _dense_act_inputs(cuda, dtype, 1000, kdim, 384, 1, 17)
    wrapper = {**_SCHEDULES, "simt": K.dense_act_simt,
               "shipped": K.fused_dense_act}[schedule]
    first = wrapper(spec, x, w, bias, borders)
    second = wrapper(spec, x, w, bias, borders)
    g = torch.randn(1000, 384, device=cuda).to(dtype)
    dz = K.fused_backward(spec, first[1], levels, g)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert torch.equal(dz, K.act_backward_plain(spec, first[1], levels, g))
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    y0, packed0 = K.dense_act_plain(spec, x, w, bias, borders)
    _close("y", first[0], y0, tol)
    _flips_ok(first[1], packed0, K.dot_f32(x, w) + bias.float(), borders, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_act_schedule_budgets_are_the_kernels(cuda, dtype):
    """The host sizes the schedules' shared memory as the sources lay it
    out, over the whole range of K and both tile widths: the resident
    panel's (direct and emit) and the pipelined ring's; -1 where the kernel
    refuses."""
    from fewbit_tpu_torch.ops._build import load_library

    lib = load_library()
    bf16 = int(dtype == torch.bfloat16)
    for out_dt in (torch.float32, torch.bfloat16):
        if not K._out_dtype_ok(dtype, out_dt):
            continue
        for kdim in range(128, 4097, 128):
            for bn in K.FG_TILE_N:
                for tma in (False, True):
                    want = K._dense_act_resident_smem(dtype, out_dt, kdim,
                                                      bn, tma)
                    if want > K.FG_SMEM_LIMIT:
                        want = -1
                    got = lib.fewbit_dense_act_resident_smem(
                        kdim, bn, bf16, int(out_dt == torch.bfloat16),
                        int(tma))
                    assert got == want, (kdim, bn, out_dt, tma)
    for bn in K.FG_TILE_N:
        want = K._dense_act_pipelined_smem(dtype, bn)
        assert want <= K.FG_SMEM_LIMIT
        assert lib.fewbit_dense_act_pipelined_smem(bn, bf16) == want
    assert lib.fewbit_dense_act_pipelined_smem(128, bf16) == -1
    assert lib.fewbit_dense_act_resident_smem(768, 128, bf16, bf16, 0) == -1


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", list(_SCHEDULES) + ["shipped"])
def test_dense_act_schedules_refuse_a_misaligned_base_on_cuda(cuda,
                                                              schedule):
    """TMA reads x and a bf16 .t() weight in place: a base off a 16-byte
    boundary raises, and nothing is launched."""
    spec, borders, _ = _lut(cuda, 3)
    x, w, bias = _dense_act_inputs(cuda, torch.bfloat16, 512, 128, 256, 1, 0)
    wrapper = {**_SCHEDULES, "shipped": K.fused_dense_act}[schedule]

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = flat[1:].view(t.shape)
        out.copy_(t)
        assert out.data_ptr() % 16 and out.is_contiguous()
        return out

    K.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        wrapper(spec, shifted(x), w, bias, borders)
    with pytest.raises(ValueError, match="16-byte"):
        wrapper(spec, x, shifted(w.t()).t(), bias, borders)
    assert K.launch_counts() == {name: 0 for name in K.KERNELS}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [8192, 2048])
def test_shipped_dense_act_takes_its_rule_on_cuda(cuda, dtype, n):
    """fused_dense_act on both sides of dense_act_schedule's rule (bf16 at
    N = 8192 x M = 3072 takes the pipelined schedule, everything else the k
    loop): the plain version's y and codes either way, counted as kernel 6
    alone."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    spec, borders, _ = _lut(cuda, 3)
    x, w, bias = _dense_act_inputs(cuda, dtype, n, 768, 3072, 1, n)
    want = ("pipelined" if dtype == torch.bfloat16 and n == 8192
            else "kloop")
    assert K.dense_act_schedule(n, 3072, dtype) == want
    K.reset_launch_counts()
    y, packed = K.fused_dense_act(spec, x, w, bias, borders)
    torch.cuda.synchronize()
    y0, packed0 = K.dense_act_plain(spec, x, w, bias, borders)
    _close("y", y, y0, tol)
    _flips_ok(packed, packed0, K.dot_f32(x, w) + bias.float(), borders, 3)
    assert K.launch_counts() == {k: 0 for k in K.KERNELS} | {"dense_act": 1}


# Every activation id, with its default arguments and (for the ids that take
# them) another set that bf16 cannot hold exactly; stepwise by parity, with
# a shift, a 5-level LUT and a 6-bit one.
ACT_OTHER_ARGS = {"hardshrink": (0.3,), "hardtanh": (-0.7, 0.3),
                  "leaky_relu": (0.1,), "softshrink": (0.3,),
                  "threshold": (0.3, -0.2), "celu": (0.5,), "elu": (1.5,),
                  "softplus": (2.0, 5.0)}
ACT_NAMES = [n for n in K.ACT_IDS if n != "stepwise"]
ACT_CASES = ([(n, ()) for n in ACT_NAMES]
             + [(n, a) for n, a in ACT_OTHER_ARGS.items()])
STEPWISE_CUDA = {
    "none+shift": ([-1.0, 0.0, 0.7, 1.4], [0.1, 0.3, 0.5, 0.7, 0.9], None,
                   (0.1, 0.5)),
    "even": ([0.4, 0.8, 1.6], [1.0, 0.6, 0.3, 0.1], False, None),
    "odd+shift": ([0.3, 0.9, 1.6, 2.4], [1.0, 0.8, 0.5, 0.2, 0.05], True,
                  (0.1, 0.25)),
    "odd 6-bit": (torch.linspace(0.1, 3.1, 31).tolist(),
                  torch.linspace(1.0, 0.0, 32).tolist(), True, None),
}


def _act(cuda, case):
    from fewbit_tpu_torch.functional.activations import stepwise_triple

    if case in STEPWISE_CUDA:
        return stepwise_triple(*STEPWISE_CUDA[case], device=cuda)
    name, args = case
    return resolve_activation(name, args=args, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ACT_CASES + list(STEPWISE_CUDA),
                         ids=[f"{n}{a}" for n, a in ACT_CASES]
                         + [f"stepwise {k}" for k in STEPWISE_CUDA])
def test_every_activation_kernels_4_5_match_plain_on_cuda(cuda, dtype, case):
    """Kernels 4 and 5 for every activation id and code kind, ragged R and
    C not a multiple of 128 for kernel 4: the packed words and dx equal to
    the plain version's, y within the tolerance."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    gen = torch.Generator(device=cuda).manual_seed(7)
    spec, borders, levels = _act(cuda, case)
    for r, c in ((1000, 384), (77, 100)):
        x = (torch.randn(r, c, generator=gen, device=cuda) * 2.5).to(dtype)
        y, packed = K.fused_forward(spec, x, borders)
        y0, packed0 = K.act_forward_plain(spec, x, borders)
        assert torch.equal(packed, packed0)
        err = (y.float() - y0.float()).abs().max().item()
        assert err <= tol * max(1.0, y0.float().abs().max().item()), err
    x = (torch.randn(1000, 384, generator=gen, device=cuda) * 2.5).to(dtype)
    _, packed = K.fused_forward(spec, x, borders)
    g = torch.randn(1000, 384, generator=gen, device=cuda).to(dtype)
    assert torch.equal(K.fused_backward(spec, packed, levels, g),
                       K.act_backward_plain(spec, packed, levels, g))


def _edges(spec, borders):
    """Where a code may flip: the borders, or a predicate's thresholds."""
    from fewbit_tpu_torch.ops.activations import kernel_args

    if spec.code != "predicate":
        return borders
    lo, hi, on_abs = kernel_args(spec, torch.float32)[4:7]
    edges = [lo] + ([] if math.isnan(hi) else [hi]) + ([-lo] if on_abs
                                                       else [])
    return torch.tensor(edges, device=borders.device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ACT_CASES,
                         ids=[f"{n}{a}" for n, a in ACT_CASES])
def test_every_activation_kernels_6_5_match_plain_on_cuda(cuda, dtype, case):
    """Kernel 6 on every schedule its envelope admits, for every id but
    stepwise, ragged N: y within the tolerance (away from a jump of the
    forward), codes flipped only near a border or threshold, and kernel 5
    on its codes equal to plain."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    gen = torch.Generator(device=cuda).manual_seed(3)
    n, kdim, m = 1000, 256, 384
    spec, borders, levels = _act(cuda, case)
    x = torch.randn(n, kdim, generator=gen, device=cuda).to(dtype)
    w = (torch.randn(m, kdim, generator=gen, device=cuda) * 0.1).to(dtype)
    bias = (torch.randn(m, generator=gen, device=cuda) * 0.1).to(dtype)
    z = K.dot_f32(x, w.t()) + bias.float()
    g = torch.randn(n, m, generator=gen, device=cuda).to(dtype)
    y0, packed0 = K.dense_act_plain(spec, x, w.t(), bias, borders)
    wrappers = [K.fused_dense_act, K.dense_act_kloop, K.dense_act_pipelined]
    if K.dense_act_direct_route(kdim, m, dtype) is not None:
        wrappers.append(K.dense_act_direct)
    if K.dense_act_emit_route(kdim, m, dtype) is not None:
        wrappers.append(K.dense_act_emit)
    # y may take either side of a jump of the forward (hardshrink and
    # threshold at their thresholds, softplus at threshold / beta) where z
    # lies within rounding of it, as a code does at a border.
    a = spec.args
    jumps = ([a[0], -a[0]] if spec.name == "hardshrink" else
             [a[0]] if spec.name == "threshold" else
             [a[1] / a[0]] if spec.name == "softplus" else [])
    far = torch.ones_like(z, dtype=torch.bool)
    for edge in jumps:
        far &= (z - edge).abs() > 1e-3
    for wrapper in wrappers:
        y, packed = wrapper(spec, x, w.t(), bias, borders)
        err = (y.float() - y0.float())[far].abs().max().item()
        assert err <= tol * max(1.0, y0.float().abs().max().item()), err
        _flips_ok(packed, packed0, z, _edges(spec, borders), spec.bits)
        assert torch.equal(K.fused_backward(spec, packed, levels, g),
                           K.act_backward_plain(spec, packed, levels, g))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [("relu", ()), ("silu", ()),
                                  ("hardtanh", (-0.7, 0.3)), ("mish", ())],
                         ids=["relu", "silu", "hardtanh", "mish"])
def test_non_gelu_ffn_kernels_2_3_match_plain_on_cuda(cuda, dtype, case):
    """Kernels 2 and 3 with other activations than GELU, kernel 3 on kernel
    2's codes; and fewbit_ffn takes them for such a spec."""
    from fewbit_tpu_torch.functional import ffn as port_ffn

    tol = 1e-4 if dtype == torch.float32 else 2e-2
    n, kdim, m, k_eff = 2048, 256, 512, 1024
    spec, borders, levels = _act(cuda, case)
    x, g, w_up, w_down, bias, sigma = _ffn_inputs(cuda, dtype, n, kdim, m, 1,
                                                  5)
    args = (spec, x, w_up, bias, borders, sigma, k_eff)
    y, packed, sk = K.fused_dense_act_sketch(*args)
    y0, packed0, sk0 = K.dense_act_sketch_plain(*args)
    _close("y", y, y0, tol)
    _close("sketch", sk, sk0, tol)
    z = K.dot_f32(x, w_up) + bias.float()
    _flips_ok(packed, packed0, z, _edges(spec, borders), spec.bits)
    args = (spec, packed, levels, g, w_down, sigma, k_eff)
    for name, a, b, t in zip(("dz", "sketch", "db"),
                             K.fused_matmul_lut_backward(*args),
                             K.matmul_lut_backward_plain(*args),
                             (tol, tol, 1e-3)):
        _close(name, a, b, t)
    cfg = port_ffn._FFNConfig(spec, k_eff, True, True)
    assert port_ffn._kernel_ok(cfg, n, kdim, m, kdim, dtype)


@pytest.mark.cuda
def test_converted_roberta_equals_u_on_cuda(cuda):
    """A vanilla RoBERTa converted by map_module + convert_linear
    (countsketch at 0.2) under the few-bit GELU patch launches path U's
    kernels as often as the config-built U model and gives the same
    logits, loss and gradients to the bit."""
    from fewbit_tpu_torch.models import (RobertaConfig,
                                         RobertaForSequenceClassification)
    from fewbit_tpu_torch.modules import RandomizedDense
    from fewbit_tpu_torch.patch import use_fewbit_activation
    from fewbit_tpu_torch.train import classification_loss, synthetic_glue
    from fewbit_tpu_torch.util import convert_linear, map_module

    small = dict(vocab_size=1000, hidden_size=256, num_layers=2,
                 num_heads=4, intermediate_size=1024,
                 max_position_embeddings=130, sketch="countsketch",
                 fused_ffn=False)
    gen = torch.Generator(device=cuda).manual_seed(0)
    vanilla = RobertaForSequenceClassification(RobertaConfig(**small),
                                               device=cuda, generator=gen)
    model = map_module(vanilla, lambda m, p: convert_linear(
        m, RandomizedDense, proj_dim_ratio=0.2, matmul="countsketch"))
    u = RobertaForSequenceClassification(
        RobertaConfig(**small, gelu_bits=3, proj_dim_ratio=0.2), device=cuda)
    u.load_state_dict(model.state_dict())
    # N = 2048 rows: kernel 1's envelope at this width.
    batch = {k: torch.from_numpy(v).to(cuda).long() for k, v in next(
        synthetic_glue(16, 128, vocab_size=1000)).items()}

    def run(m):
        K.reset_launch_counts()
        logits = m(batch["input_ids"], batch["attention_mask"],
                   deterministic=False,
                   dropout_generator=torch.Generator(
                       device=cuda).manual_seed(1),
                   sketch_generator=torch.Generator(
                       device=cuda).manual_seed(2))
        loss = classification_loss(logits, batch["labels"])
        loss.backward()
        torch.cuda.synchronize()
        return (logits, loss, {n: p.grad for n, p in m.named_parameters()},
                K.launch_counts())

    # torch's CUDA embedding backward sums the rows of a repeated index
    # (the one token type) in an order that may change from run to run.
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        want = run(u)
        with use_fewbit_activation("gelu", bits=3):
            got = run(model)
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)
    assert want[3]["matmul_input_sketch"] > 0
    assert want[3]["fused_forward"] == want[3]["fused_backward"] == 2
    assert got[3] == want[3]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert list(got[2]) == list(want[2])
    for name in want[2]:
        assert torch.equal(got[2][name], want[2][name]), name


@pytest.mark.cuda
def test_peak_memory_bytes_on_cuda(cuda):
    from fewbit_tpu_torch.util import device_memory_stats, peak_memory_bytes

    torch.cuda.reset_peak_memory_stats(cuda)
    held = torch.cuda.memory_allocated(cuda)
    t = torch.empty(1 << 24, device=cuda)
    assert peak_memory_bytes() >= held + t.numel() * 4
    assert peak_memory_bytes(cuda) == torch.cuda.max_memory_allocated(cuda)
    stats = device_memory_stats(cuda)
    assert stats["allocated_bytes.all.peak"] == peak_memory_bytes(cuda)
    assert peak_memory_bytes("cpu") is None
    assert device_memory_stats("cpu") == {}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tp_width_kernels_write_every_output_on_cuda(cuda, dtype):
    """Kernels 1, 3, 5 and 6 at one tp=2 rank's widths of RoBERTa-base and
    GPT-2 small (768 <-> 384 projections, 768 <-> 1536 FFN) write every
    element of outputs filled with NaN, and hold their plain versions."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    gen = torch.Generator(device=cuda).manual_seed(0)
    n, k_eff = 1024, 512

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=cuda)
                * scale).to(dtype)

    def held(got, want):
        for a, b in zip(got, want):
            if a.dtype == torch.int32:
                continue
            t = tol if a.dtype == dtype else 1e-3
            err = (a.float() - b.float()).abs().max().item()
            assert err <= t * max(1.0, b.float().abs().max().item()), err

    sigma = torch.randint(0, 2, (n,), generator=gen,
                          device=cuda).float() * 2 - 1
    spec, borders, levels = resolve_activation("gelu", bits=3, device=cuda)
    x, g = rand(n, 768), rand(n, 768)
    w_col, w_row = rand(384, 768, scale=0.036), rand(768, 384, scale=0.05)
    for args in ((x, w_col.t(), rand(384, scale=0.1), sigma, k_eff),
                 (rand(n, 384), w_row.t(), None, sigma, k_eff),
                 (rand(n, 384), w_col, None, sigma, k_eff, True),
                 (g, w_row, None, sigma, k_eff, True)):
        want = K.matmul_input_sketch_plain(*args)
        held(K.fused_matmul_input_sketch(*args, out=_nan_outputs(want)),
             want)
    up_w, up_b = rand(1536, 768, scale=0.036), rand(1536, scale=0.1)
    args = (spec, x, up_w.t(), up_b, borders)
    want = K.dense_act_plain(*args)
    y, packed = K.fused_dense_act(*args, out=_nan_outputs(want))
    held((y,), want)
    flips = unpack_codes(packed, 3, n) != unpack_codes(want[1], 3, n)
    assert flips.float().mean().item() <= 1e-4
    args = (spec, packed, levels, g, rand(768, 1536, scale=0.025), sigma,
            k_eff)
    want = K.matmul_lut_backward_plain(*args)
    held(K.fused_matmul_lut_backward(*args, out=_nan_outputs(want)), want)
    args = (spec, packed, levels, rand(n, 1536))
    want = K.act_backward_plain(*args)
    held((K.fused_backward(*args, out=_nan_outputs((want,))),), (want,))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_example_width_kernels_write_every_output_on_cuda(cuda, dtype):
    """Kernels 1-6 at the examples' width (hidden 128, FFN 512, 4096 rows:
    one 128-wide k-block against the multi-stage ring) write every element
    of outputs filled with NaN, and hold their plain versions; kernel 4's
    codes are equal."""
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    gen = torch.Generator(device=cuda).manual_seed(1)
    n, k_eff = 4096, 1024

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=cuda)
                * scale).to(dtype)

    def held(got, want):
        for a, b in zip(got, want):
            if a.dtype == torch.int32:
                continue
            t = tol if a.dtype == dtype else 1e-3
            err = (a.float() - b.float()).abs().max().item()
            assert err <= t * max(1.0, b.float().abs().max().item()), err

    sigma = torch.randint(0, 2, (n,), generator=gen,
                          device=cuda).float() * 2 - 1
    spec, borders, levels = resolve_activation("gelu", bits=3, device=cuda)
    x, g = rand(n, 128), rand(n, 128)
    for kdim, m in ((128, 128), (128, 512), (512, 128)):
        w = rand(m, kdim, scale=kdim ** -0.5)
        for args in ((rand(n, kdim), w.t(), rand(m, scale=0.1), sigma,
                      k_eff),
                     (rand(n, m), w, None, sigma, k_eff, True)):
            want = K.matmul_input_sketch_plain(*args)
            held(K.fused_matmul_input_sketch(*args, out=_nan_outputs(want)),
                 want)
    up_w, up_b = rand(512, 128, scale=128 ** -0.5), rand(512, scale=0.1)
    args = (spec, x, up_w.t(), up_b, borders, sigma, k_eff)
    want = K.dense_act_sketch_plain(*args)
    y, packed, sk = K.fused_dense_act_sketch(*args,
                                             out=_nan_outputs(want))
    held((y, sk), (want[0], want[2]))
    args = (spec, packed, levels, g, rand(128, 512, scale=512 ** -0.5),
            sigma, k_eff)
    want = K.matmul_lut_backward_plain(*args)
    held(K.fused_matmul_lut_backward(*args, out=_nan_outputs(want)), want)
    args = (spec, x, up_w.t(), up_b, borders)
    want = K.dense_act_plain(*args)
    y, packed = K.fused_dense_act(*args, out=_nan_outputs(want))
    held((y,), want)
    for codes in (packed, None):
        if codes is None:
            args = (spec, rand(n, 512, scale=1.5), borders)
            want = K.act_forward_plain(*args)
            y, codes = K.fused_forward(*args, out=_nan_outputs(want))
            held((y,), want)
            assert torch.equal(codes, want[1])
        args = (spec, codes, levels, rand(n, 512))
        want = K.act_backward_plain(*args)
        held((K.fused_backward(*args, out=_nan_outputs((want,))),), (want,))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_step_on_cuda_matches_cpu(cuda, dtype):
    """make_train_step on the card, where AdamW runs fused, against the same
    step on the CPU (torch's default AdamW), which tests/test_torch_train.py
    holds against JAX's: three steps of a vanilla GPT (no dropout, no
    sketch: nothing drawn) from the same f32 weights on the same batches,
    Adam's eps 1 and the first step's learning rate 0, as that file's
    max_grad_norm test.  f32: the parameters within its tolerances (rtol
    1e-5, atol 1e-7).  bf16 compute (the parameters and AdamW stay f32):
    the joined parameter updates' relative error against the CPU's f32
    step at most 2.5 times the CPU bf16 step's, as tests/test_torch_bf16.py
    bounds the bf16 path against JAX's own bf16 run."""
    from fewbit_tpu_torch.models import GPTConfig, GPTForCausalLM
    from fewbit_tpu_torch.train import (TrainConfig, causal_lm_loss,
                                        make_optimizer, make_train_step,
                                        synthetic_lm)

    widths = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
                  intermediate_size=512, max_position_embeddings=64,
                  hidden_dropout=0.0, attention_dropout=0.0)
    train = TrainConfig(total_steps=4, learning_rate=1e-2, eps=1.0)
    batches = [next(synthetic_lm(4, 64, vocab_size=256, seed=s))
               for s in range(3)]

    def fresh(dt):
        # The same f32 weights whatever the compute dtype.
        return GPTForCausalLM(GPTConfig(**widths, dtype=dt), device="cpu",
                              generator=torch.Generator().manual_seed(0))

    before = [p.detach().clone() for p in fresh(torch.float32).parameters()]

    def run(dt, device):
        model = fresh(dt).to(device)
        assert all(torch.equal(p.cpu(), b)
                   for p, b in zip(model.parameters(), before))
        if device.type == "cuda":
            opt, _ = make_optimizer(train, list(model.parameters()))
            assert opt.defaults["fused"]
        step = make_train_step(model, train, loss_fn=causal_lm_loss)
        gen = torch.Generator().manual_seed(0)
        for b in batches:
            loss = step({k: torch.as_tensor(v, device=device)
                         for k, v in b.items()}, gen)["loss"]
            assert math.isfinite(loss.item())
        return [p.detach().float().cpu() for p in model.parameters()]

    truth = run(torch.float32, torch.device("cpu"))
    got = run(dtype, cuda)
    assert all(not torch.equal(t, b) for t, b in zip(truth, before))
    if dtype == torch.float32:
        for g, t in zip(got, truth):
            torch.testing.assert_close(g, t, rtol=1e-5, atol=1e-7)
        return

    def update_err(params):
        num = sum(((p - b) - (t - b)).double().pow(2).sum()
                  for p, t, b in zip(params, truth, before))
        den = sum((t - b).double().pow(2).sum()
                  for t, b in zip(truth, before))
        return math.sqrt(num / den)

    cpu_err = update_err(run(dtype, torch.device("cpu")))
    assert update_err(got) <= 2.5 * cpu_err, (update_err(got), cpu_err)
