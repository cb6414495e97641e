"""The design of the tensor-core flash backward kernels (F2 and F3,
``csrc/flash_backward.cu``) on the CPU: the arithmetic they run (f32 operands
as three TF32 products, bf16 operands with P and dS rounded to bf16 before
the second product, ``exp2`` on logits scaled by log2 e, ``sm_scale`` applied
to dK and dQ at the store) against an f64 evaluation; the index arithmetic
by which the accumulator fragment of the first product becomes the A operand
of the second from registers; and the one route of the kernels over their
envelope against the 16-byte rule of TMA (the shared-memory budget is held
by a static_assert where the source is compiled).

The emulation rounds where the kernels round and sums with the CPU's f32
matmul.  It does not model the card's accumulation order; the tolerances are
``chip_smoke.py``'s (1e-4 of max(1, max |want|) in f32, 2e-2 in bf16), which
the kernels meet on the card against the same f64 evaluation.
"""

import numpy as np
import pytest
import torch

from fewbit_tpu_torch.ops import kernels as K
from fewbit_tpu_torch.ops.flash_attention import (DEFAULT_MASK_VALUE,
                                                  flash_backward_dkv_plain,
                                                  flash_backward_dq_plain,
                                                  flash_forward_plain)

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LOG2E = 1.4426950408889634
HEAD_DIM = K.FLASH_HEAD_DIM


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """Round f32 to nearest, ties away from zero, at 10 mantissa bits."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _product(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """``a @ b`` as the kernels multiply operands of ``dtype``: f32 as hi hi
    + hi lo + lo hi of the TF32 halves, bf16 values exactly, f32 sums."""
    a, b = a.float(), b.float()
    if dtype == torch.bfloat16:
        return a @ b
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi


def _mask(seg_q, seg_kv, causal, sq, sk):
    keep = torch.ones(sq, sk, dtype=torch.bool)
    if seg_q is not None:
        keep &= seg_q[:, None] == seg_kv[None, :]
    if causal:
        keep &= torch.arange(sk)[None, :] <= torch.arange(sq)[:, None]
    return keep


def _emulate(q, k, v, do, lse, di, keep, scale, dtype):
    """One head of F2 and F3 as the kernels compute it: ``(dk, dv, dq)``."""
    val = _product(q, k.t(), dtype) * scale
    val = torch.where(keep, val, val + DEFAULT_MASK_VALUE)
    p = torch.exp2((val - lse[:, None]) * LOG2E)
    ds = p * (_product(do, v.t(), dtype) - di[:, None])
    if dtype == torch.bfloat16:  # the packed A fragments of the second product
        p, ds = p.bfloat16(), ds.bfloat16()
    dv = _product(p.t(), do, dtype)
    dk = _product(ds.t(), q, dtype) * scale
    dq = _product(ds, k, dtype) * scale
    return dk.to(dtype), dv.to(dtype), dq.to(dtype)


def _f64(q, k, v, do, lse, di, keep, scale):
    q, k, v, do, lse, di = (t.double() for t in (q, k, v, do, lse, di))
    s = q @ k.t() * scale
    s = s + torch.where(keep, 0.0, DEFAULT_MASK_VALUE)
    p = torch.exp(s - lse[:, None])
    ds = p * (do @ v.t() - di[:, None]) * scale
    return ds.t() @ q, p.t() @ do, ds @ k


def _head(seq, mode, dtype, seed):
    """One head's inputs from a seed, with the plain forward's lse and di."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(1, 1, seq, HEAD_DIM)
                                    .astype(np.float32)).to(dtype)
                   for _ in range(4))
    seg = None
    if mode == "segments":  # three documents of unequal length
        ids = np.searchsorted([seq // 5, seq // 2], np.arange(seq),
                              side="right").astype(np.int32)
        seg = torch.from_numpy(ids)[None]
    causal = mode == "causal" or seq == 1024  # segments: with and without
    scale = HEAD_DIM ** -0.5
    o, lse = flash_forward_plain(q, k, v, seg, seg, causal, scale)
    di = (o.float() * do.float()).sum(-1)
    return q, k, v, do, seg, lse, di, causal, scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["causal", "segments"])
@pytest.mark.parametrize("seq", [1024, 200])
def test_emulated_arithmetic_against_f64(seq, mode, dtype):
    q, k, v, do, seg, lse, di, causal, scale = _head(seq, mode, dtype,
                                                     seed=seq)
    ids = None if seg is None else seg[0]
    keep = _mask(ids, ids, causal, seq, seq)
    args = (q[0, 0], k[0, 0], v[0, 0], do[0, 0], lse[0, 0], di[0, 0], keep,
            scale)
    want = _f64(*args)
    got = _emulate(*args, dtype)
    plain = (*flash_backward_dkv_plain(q, k, v, seg, seg, lse, do, di, causal,
                                       scale),
             flash_backward_dq_plain(q, k, v, seg, seg, lse, do, di, causal,
                                     scale))
    for name, g, p0, w in zip(("dk", "dv", "dq"), got, plain, want):
        bound = TOL[dtype] * max(1.0, float(w.abs().max()))
        err = float((g.double() - w).abs().max())
        # Another order of sums and other roundings than f64: never 0, and
        # inside the tolerance the card's check uses.
        assert 0 < err <= bound, (name, err, bound)
        assert float((p0[0, 0].double() - w).abs().max()) <= bound, name


def test_one_tf32_product_would_not_do():
    """The reason for 3xTF32: a single TF32 product of the f32 operands
    leaves the f32 tolerance at the GPT shape's sequence length."""
    q, k, v, do, seg, lse, di, causal, scale = _head(1024, "causal",
                                                     torch.float32, seed=7)
    keep = _mask(None, None, True, 1024, 1024)
    args = (q[0, 0], k[0, 0], v[0, 0], do[0, 0], lse[0, 0], di[0, 0], keep,
            scale)
    want = _f64(*args)

    def one_pass(a, b):
        return _tf32(a.float()) @ _tf32(b.float())

    val = one_pass(args[0], args[1].t()) * scale
    val = torch.where(keep, val, val + DEFAULT_MASK_VALUE)
    p = torch.exp2((val - args[4][:, None]) * LOG2E)
    dv = one_pass(p.t(), args[3])
    err = float((dv.double() - want[1]).abs().max())
    assert err > TOL[torch.float32] * max(1.0, float(want[1].abs().max()))


# ---------------------------------------------------------------------------
# The accumulator fragment of the first product as the A operand of the
# second, from registers.
# ---------------------------------------------------------------------------


def _accumulator_fragments(x):
    """frag[thread, 4 i + 2 h + e] = x[16 warp + g + 8 h, 8 i + 2 t + e]:
    what each of a warpgroup's 128 threads holds of a 64 x 64 wgmma
    accumulator (``hopper_gemm.cuh``)."""
    frag = np.zeros((128, 32), x.dtype)
    for thread in range(128):
        warp, g, t = thread // 32, (thread % 32) // 4, thread % 4
        for i in range(8):
            for h in range(2):
                for e in range(2):
                    frag[thread, 4 * i + 2 * h + e] = x[
                        16 * warp + g + 8 * h, 8 * i + 2 * t + e]
    return frag


def _permuted_k(rr):
    """``permuted_k`` of the source: where the transposed B tile keeps
    looped row rr within its group of eight."""
    a = rr & 7
    return (rr & ~7) + (4 + (a >> 1) if a & 1 else a >> 1)


def test_tf32_fragment_feeds_the_second_product():
    """tf32, m64k8: register r of step j is accumulator element
    4 j + 2 (r & 1) + (r >> 1); the hardware reads it as A[row + 8 (r & 1),
    t + 4 (r >> 1)].  With B's k index permuted by ``permuted_k`` the sum
    over the eight steps is the plain product."""
    rng = np.random.RandomState(0)
    x = rng.randn(64, 64)       # P^T or dS^T (F2), dS (F3): 64 x 64 looped
    b = rng.randn(64, HEAD_DIM)  # the looped tile: 64 rows x d
    frag = _accumulator_fragments(x)
    # B as the producer writes it: K-major, bt[d, permuted_k(row)].
    bt = np.zeros((HEAD_DIM, 64))
    for row in range(64):
        bt[:, _permuted_k(row)] = b[row]
    assert sorted(_permuted_k(r) for r in range(64)) == list(range(64))
    out = np.zeros((64, HEAD_DIM))
    for j in range(8):
        a_step = np.zeros((64, 8))
        for thread in range(128):
            warp, g, t = thread // 32, (thread % 32) // 4, thread % 4
            for r in range(4):
                a_step[16 * warp + g + 8 * (r & 1), t + 4 * (r >> 1)] = frag[
                    thread, 4 * j + 2 * (r & 1) + (r >> 1)]
        out += a_step @ bt[:, 8 * j:8 * j + 8].T
    np.testing.assert_allclose(out, x @ b, rtol=1e-12, atol=1e-12)


def test_bf16_fragment_feeds_the_second_product():
    """bf16, m64k16: register r of step j packs accumulator elements
    8 j + 2 r and 8 j + 2 r + 1; the hardware reads them as A[row + 8 (r &
    1), 2 t + 8 (r >> 1) + {0, 1}].  B is the tile as it lies in memory
    (MN-major, the transpose bit): step j is its rows 16 j .. 16 j + 15."""
    rng = np.random.RandomState(1)
    x = rng.randn(64, 64)
    b = rng.randn(64, HEAD_DIM)
    frag = _accumulator_fragments(x)
    out = np.zeros((64, HEAD_DIM))
    for j in range(4):
        a_step = np.zeros((64, 16))
        for thread in range(128):
            warp, g, t = thread // 32, (thread % 32) // 4, thread % 4
            for r in range(4):
                for half in range(2):
                    a_step[16 * warp + g + 8 * (r & 1),
                           2 * t + 8 * (r >> 1) + half] = frag[
                        thread, 8 * j + 2 * r + half]
        out += a_step @ b[16 * j:16 * j + 16]
    np.testing.assert_allclose(out, x @ b, rtol=1e-12, atol=1e-12)


def test_swizzled_plane_offsets_are_a_permutation():
    """``plane_chunk`` of the source: the 16-byte chunks of a 64 x 64 f32
    plane (two sub-tiles of 32 floats a row, chunk q of row r at q ^ (r %
    8)) each land on a place of their own, and a quarter warp's eight
    chunks of one row cover all 32 banks."""
    def plane_chunk(row, c16):
        return (c16 >> 3) * 64 * 128 + row * 128 + (((c16 & 7) ^ (row & 7))
                                                    << 4)

    offsets = {plane_chunk(r, c) for r in range(64) for c in range(16)}
    assert offsets == set(range(0, 64 * 64 * 4, 16))
    for row in range(64):
        banks = {(plane_chunk(row, c) // 4 + w) % 32
                 for c in range(8) for w in range(4)}
        assert len(banks) == 32


# ---------------------------------------------------------------------------
# The envelope: one route whatever the sequence, strides TMA reads.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["transposed", "contiguous"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_route_over_the_envelope(dtype, layout):
    per16 = 4 if dtype == torch.float32 else 8
    b, h = 8, 12
    for s in (*range(1, 130), 255, 256, 257, 1000, 1024, 2047, 2048, 4096):
        # The strides of a transposed (b, s, h, d) view or of a contiguous
        # (b, h, s, d) tensor.
        strides = ((s * h * HEAD_DIM, HEAD_DIM, h * HEAD_DIM)
                   if layout == "transposed"
                   else (h * s * HEAD_DIM, s * HEAD_DIM, HEAD_DIM))
        # Nothing comes back: no plan to choose from, nothing is rerouted.
        assert K.flash_backward_envelope(dtype, (b, h, s), strides) is None
    for bad in (0, -64, 1, per16 - 1, per16 + 1, 3 * per16 // 2):
        for dim in range(3):
            strides = [768 * 128, 64, 768]
            strides[dim] = bad
            with pytest.raises(ValueError, match="16 bytes"):
                K.flash_backward_envelope(dtype, (b, h, 128), strides)
            # A dimension of one element may have any stride.
            shape = [b, h, 128]
            shape[dim] = 1
            K.flash_backward_envelope(dtype, shape, strides)
    with pytest.raises(ValueError):
        K.flash_backward_envelope(dtype, (b, h, 0), (768, 64, 768))
    with pytest.raises(ValueError):
        K.flash_backward_envelope(torch.float16, (b, h, 128), (768, 64, 768))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_tma_checks_raise_on_misaligned_operands(dtype):
    b, h, s = 2, 3, 40
    q, k, v, do = (torch.zeros(b, s, h, HEAD_DIM, dtype=dtype).transpose(1, 2)
                   for _ in range(4))
    K._flash_tma_checks(q, k, v, do)
    # A base 4 (f32) or 2 (bf16) bytes off a 16-byte boundary.
    flat = torch.zeros(b * s * h * HEAD_DIM + 1, dtype=dtype)
    off = flat[1:].view(b, s, h, HEAD_DIM).transpose(1, 2)
    with pytest.raises(ValueError, match="16-byte aligned"):
        K._flash_tma_checks(q, off, v, do)
    # A row stride that is not a multiple of 16 bytes (unit stride along d
    # kept): rows of 66 elements.
    wide = torch.zeros(b, h, s, HEAD_DIM + 2, dtype=dtype)[..., :HEAD_DIM]
    assert wide.stride(-1) == 1 and wide.stride(2) == HEAD_DIM + 2
    if (HEAD_DIM + 2) * wide.element_size() % 16:
        with pytest.raises(ValueError, match="16 bytes"):
            K._flash_tma_checks(q, k, wide, do)
    # A dimension of one element may have any stride.
    one = torch.zeros(1, 1, s, HEAD_DIM, dtype=dtype).as_strided(
        (1, 1, s, HEAD_DIM), (3, 5, HEAD_DIM, 1))
    K._flash_tma_checks(one, one, one, one)


@pytest.mark.parametrize("wrapper,n_out", [(K.flash_backward_dkv, 2),
                                           (K.flash_backward_dq, 1)],
                         ids=["dkv", "dq"])
def test_outputs_given_by_the_caller_are_written(wrapper, n_out):
    q, k, v, do, seg, lse, di, causal, scale = _head(96, "segments",
                                                     torch.float32, seed=5)
    args = (q, k, v, seg, seg, lse, do, di, causal, scale)
    want = wrapper(*args)
    out = tuple(torch.full_like(q, float("nan")) for _ in range(n_out))
    got = wrapper(*args, out=out)
    if n_out == 1:
        got, want = (got,), (want,)
    for g, o, w in zip(got, out, want):
        assert g is o and torch.equal(o, w)


def test_outputs_that_do_not_fit_are_refused():
    k = torch.zeros(2, 3, 40, HEAD_DIM)
    good = torch.empty_like(k)
    assert K._flash_outputs((good, good), (k, k), ("dk", "dv")) == (good,
                                                                    good)
    for bad in (torch.empty(2, 3, 41, HEAD_DIM), good.bfloat16(),
                torch.empty(2, 3, 40, 2 * HEAD_DIM)[..., ::2]):
        with pytest.raises(ValueError, match="out dv"):
            K._flash_outputs((good, bad), (k, k), ("dk", "dv"))
    with pytest.raises(ValueError, match="must hold"):
        K._flash_outputs((good,), (k, k), ("dk", "dv"))
    fresh = K._flash_outputs(None, (k.transpose(1, 2),), ("dq",))
    assert fresh[0].stride() == k.transpose(1, 2).stride()


@pytest.mark.parametrize("wrapper,plain", [
    (K.flash_backward_dkv, flash_backward_dkv_plain),
    (K.flash_backward_dkv_simt, flash_backward_dkv_plain),
    (K.flash_backward_dq, flash_backward_dq_plain),
    (K.flash_backward_dq_simt, flash_backward_dq_plain)],
    ids=["dkv", "dkv_simt", "dq", "dq_simt"])
def test_wrappers_take_the_plain_version_on_the_cpu(wrapper, plain):
    q, k, v, do, seg, lse, di, causal, scale = _head(96, "segments",
                                                     torch.float32, seed=3)
    args = (q, k, v, seg, seg, lse, do, di, causal, scale)
    before = wrapper.launches
    got, want = wrapper(*args), plain(*args)
    if isinstance(want, torch.Tensor):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert wrapper.launches == before  # no kernel was launched


def test_kernels_table_names_the_new_source():
    for name in ("flash_backward_dkv", "flash_backward_dq"):
        wrapper, plain, replaces, source = K.KERNELS[name]
        assert source == "fewbit_tpu_torch/csrc/flash_backward.cu"
        assert wrapper is getattr(K, name)
    assert len(K.KERNELS) == 14
    assert "flash_backward_dkv_simt" not in K.KERNELS
    K.reset_launch_counts()
    assert K.flash_backward_dkv_simt.launches == 0
    assert K.flash_backward_dq_simt.launches == 0
