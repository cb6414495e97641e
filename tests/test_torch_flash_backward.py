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
HEAD_DIM = 64


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


def _head(seq, mode, dtype, seed, d=HEAD_DIM):
    """One head's inputs from a seed, with the plain forward's lse and di."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(1, 1, seq, d)
                                    .astype(np.float32)).to(dtype)
                   for _ in range(4))
    seg = None
    if mode == "segments":  # three documents of unequal length
        ids = np.searchsorted([seq // 5, seq // 2], np.arange(seq),
                              side="right").astype(np.int32)
        seg = torch.from_numpy(ids)[None]
    causal = mode == "causal" or seq == 1024  # segments: with and without
    scale = d ** -0.5
    o, lse = flash_forward_plain(q, k, v, seg, seg, causal, scale)
    di = (o.float() * do.float()).sum(-1)
    return q, k, v, do, seg, lse, di, causal, scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["causal", "segments"])
@pytest.mark.parametrize("seq", [1024, 200])
def test_emulated_arithmetic_against_f64(seq, mode, dtype):
    _emulated_against_f64(seq, mode, dtype, HEAD_DIM)


@pytest.mark.parametrize("d", [32, 128], ids=["d32", "d128"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["causal", "segments"])
@pytest.mark.parametrize("seq", [1024, 200])
def test_emulated_arithmetic_against_f64_at_head_dims(seq, mode, dtype, d):
    """The same at head dimensions 32 and 128: the products contract over
    d in the first products and over the looped rows in the second, so the
    tile rows change the order of the sums only."""
    _emulated_against_f64(seq, mode, dtype, d)


def _emulated_against_f64(seq, mode, dtype, d):
    q, k, v, do, seg, lse, di, causal, scale = _head(seq, mode, dtype,
                                                     seed=seq, d=d)
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
    _plane_offsets(64, 64)


# The f32 planes of each instantiation: (tile rows, head dimension).
F32_PLANES = [(64, 16), (64, 32), (64, 48), (64, 64), (32, 80), (32, 96),
              (32, 112), (32, 128)]


def _row_bytes(d, elt):
    """``HbShape::RB``: the largest of 128, 64 and 32 that divides a row."""
    return next(rb for rb in (128, 64, 32) if d * elt % rb == 0)


@pytest.mark.parametrize("tile,d", F32_PLANES,
                         ids=[f"tile{t}_d{d}" for t, d in F32_PLANES])
def test_swizzled_plane_offsets_at_every_f32_instantiation(tile, d):
    """The same for every f32 plane the kernels keep (``K._flash_tiles``),
    in sub-tiles of 128- or 64-byte rows, and the producer's thread layouts
    over it: ``fetch_tile`` and ``split_fetched`` (128 threads, ``tile d /
    512`` chunks each, row = chunk / (d / 4) unsigned) and
    ``transpose_planes`` (a warp's lanes on 32 different rows, ``tile / 32``
    row groups by ``d / 16`` chunk columns a warp) each visit every chunk
    once; the transposed plane (d rows x tile floats, sub-tiles of 32 k) is
    a permutation of its bytes too."""
    assert {(K._flash_tiles(name, torch.float32, dd)[1], dd)
            for name in ("flash_forward", "flash_backward_dkv",
                         "flash_backward_dq") for dd in K.FLASH_INSTANCES} \
        == set(F32_PLANES)
    _plane_offsets(tile, d)
    row_chunks = d // 4
    fetched = [divmod(ptid + 128 * it, row_chunks) for ptid in range(128)
               for it in range(tile * row_chunks // 128)]
    assert sorted(fetched) == [(r, c) for r in range(tile)
                               for c in range(row_chunks)]
    groups, chunks = tile // 32, d // 16
    seen = []
    for w in range(4):
        for it in range(groups * chunks):
            rows = [lane + 32 * (it & (groups - 1)) for lane in range(32)]
            assert len(set(rows)) == 32
            c16 = chunks * w + (it >> (groups.bit_length() - 1))
            seen += [(r, c16) for r in rows]
    assert sorted(seen) == [(r, c) for r in range(tile)
                            for c in range(row_chunks)]
    # transpose_planes' stores: element (d_i, k) of the transposed plane at
    # sub-tile k // 32, swizzled row d_i, column k % 32.
    out = {(k // 32) * d * 128 + _swizzled_offset(di, k % 32, 4)
           for di in range(d) for k in range(tile)}
    assert out == set(range(0, d * tile * 4, 4))


def _swizzled_offset(row, col, elem_bytes, row_bytes=128):
    """``hopper::swizzled_offset``: element (row, col) of a tile of
    ``row_bytes``-byte rows as TMA's swizzle of that width writes it."""
    byte = col * elem_bytes
    chunk = ((byte >> 4) ^ ((row * row_bytes) >> 7)) & (row_bytes // 16 - 1)
    return row * row_bytes + (chunk << 4) + (byte & 15)


def _plane_chunk(row, c16, tile, rb):
    """``plane_chunk<TILE, RB>``: chunk c16 of a row in sub-tiles of rb."""
    cpr = rb // 16
    return (c16 // cpr) * tile * rb + _swizzled_offset(row, 4 * (c16 % cpr),
                                                       4, rb)


def _plane_offsets(tile, d):
    """The plane's chunks each land on a place of their own; the 16-byte
    copies of a quarter warp (eight consecutive chunks of the producer's
    row-major order) touch each bank once, but where a row is an odd
    number (above one) of 64-byte sub-tiles (d = 48, 80, 112), where two of
    them may share a bank."""
    rb = _row_bytes(d, 4)
    offsets = {_plane_chunk(r, c, tile, rb)
               for r in range(tile) for c in range(d // 4)}
    assert offsets == set(range(0, tile * d * 4, 16))
    worst = 0
    for q0 in range(0, tile * d // 4, 8):
        hits = np.zeros(32, int)
        for n in range(q0, q0 + 8):
            off = _plane_chunk(*divmod(n, d // 4), tile, rb)
            hits[[(off // 4 + w) % 32 for w in range(4)]] += 1
        worst = max(worst, hits.max())
    sub = d * 4 // rb
    assert worst == (2 if rb == 64 and sub > 1 and sub % 2 else 1), worst


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


# ---------------------------------------------------------------------------
# Every instantiation: the fragments at its tile rows, the descriptors at
# its row bytes, its shared memory.
# ---------------------------------------------------------------------------


def _fragments(x):
    """frag[thread, 4 i + 2 h + e] = x[16 warp + g + 8 h, 8 i + 2 t + e] of
    a 64 x n accumulator."""
    n = x.shape[1]
    frag = np.zeros((128, n // 2), x.dtype)
    for thread in range(128):
        warp, g, t = thread // 32, (thread % 32) // 4, thread % 4
        for i in range(n // 8):
            for h in range(2):
                for e in range(2):
                    frag[thread, 4 * i + 2 * h + e] = x[
                        16 * warp + g + 8 * h, 8 * i + 2 * t + e]
    return frag


# (dtype, tile rows, head dimension) of every instantiation's second
# products, by K._flash_tiles.
SECOND_PRODUCTS = sorted({
    (dt, K._flash_tiles(name, torch.float32 if dt == "f32"
                        else torch.bfloat16, d)[1], d)
    for name in ("flash_forward", "flash_backward_dkv", "flash_backward_dq")
    for dt in ("f32", "bf16") for d in K.FLASH_INSTANCES})


@pytest.mark.parametrize("dt,tile,d", SECOND_PRODUCTS,
                         ids=[f"{a}_tile{b}_d{c}"
                              for a, b, c in SECOND_PRODUCTS])
def test_fragments_feed_the_second_product_at_every_shape(dt, tile, d):
    """The two fragment tests above at each instantiation's tile rows
    (the accumulator of S is 64 x tile) and head dimension (the second
    product's N): tf32 steps of eight k with B's k permuted, bf16 steps of
    sixteen with packed pairs and B MN-major."""
    rng = np.random.RandomState(tile + d)
    x = rng.randn(64, tile)
    b = rng.randn(tile, d)
    frag = _fragments(x)
    out = np.zeros((64, d))
    if dt == "f32":
        bt = np.zeros((d, tile))
        for row in range(tile):
            bt[:, _permuted_k(row)] = b[row]
        for j in range(tile // 8):
            a_step = np.zeros((64, 8))
            for thread in range(128):
                warp, g, t = thread // 32, (thread % 32) // 4, thread % 4
                for r in range(4):
                    a_step[16 * warp + g + 8 * (r & 1), t + 4 * (r >> 1)] = \
                        frag[thread, 4 * j + 2 * (r & 1) + (r >> 1)]
            out += a_step @ bt[:, 8 * j:8 * j + 8].T
    else:
        for j in range(tile // 16):
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


def _swizzle(offset, row_bytes):
    """TMA's and wgmma's swizzle of a byte offset inside an aligned atom:
    the 16-byte chunk bits XOR the row bits above them (Swizzle<3,4,3> for
    128-byte rows, Swizzle<2,4,3> for 64-byte rows, Swizzle<1,4,3> for
    32-byte rows)."""
    bits = {128: 3, 64: 2, 32: 1}[row_bytes]
    mask = ((1 << bits) - 1) << 7
    return offset ^ ((offset & mask) >> 3)


def _tma_tile(rows, cols, elt, rb):
    """Byte -> (row, col) of a rows x cols operand as the kernels' TMA
    boxes lay it: sub-tiles of ``rb``-byte rows, one after the other."""
    sub_bytes = rows * rb
    where = {}
    for r in range(rows):
        for c in range(cols):
            byte = c * elt
            off = (byte // rb) * sub_bytes + _swizzle(r * rb + byte % rb, rb)
            where[off] = (r, c)
    return where


def _kmajor_read(start, mn, k_bytes, elt, rb):
    """The address wgmma reads for element (mn, k) of a K-major operand
    whose descriptor starts at ``start`` (SBO 8 rb, the swizzle of rb)."""
    return _swizzle(start + (mn % 8) * rb + (mn // 8) * 8 * rb + k_bytes, rb)


def _mnmajor_read(start, n, k, elt, rb, lbo):
    """The address of element (n, k) of an MN-major operand: rb bytes of n
    a row, the next rb bytes of n ``lbo`` on, k rows rb apart, eight k rows
    an atom (SBO 8 rb)."""
    per = rb // elt
    return _swizzle(start + (n % per) * elt + (n // per) * lbo
                    + (k % 8) * rb + (k // 8) * 8 * rb, rb)


# (element bytes, head dimension, tile rows) of every TMA-fed operand, by
# K._flash_tiles.
DESCRIPTORS = sorted({
    (elt, d, K._flash_tiles(name, dt, d)[1])
    for name in ("flash_forward", "flash_backward_dkv", "flash_backward_dq")
    for elt, dt in ((4, torch.float32), (2, torch.bfloat16))
    for d in K.FLASH_INSTANCES})


@pytest.mark.parametrize("elt,d,tile", DESCRIPTORS,
                         ids=[f"{'f32' if e == 4 else 'bf16'}_d{d}_tile{t}"
                              for e, d, t in DESCRIPTORS])
def test_descriptors_read_what_tma_wrote(elt, d, tile):
    """The kernels' descriptor arithmetic against the canonical layouts of
    wgmma: the first products' K-major operands (a 64-row warpgroup's own
    rows and a looped tile's rows, k step ks at sub-tile ks / KSUB, 32
    bytes a step within it) read exactly the elements of their step, at
    rows of 128, 64 and 32 bytes (the widest that divides d elt); and
    (bf16) the looped tile read MN-major for the second product (step j 16
    rows b on, the next rb bytes of columns one sub-tile on: the leading
    byte offset) reads rows 16 j .. 16 j + 15 of every column.  The f32
    producer's own copies land where TMA's would (``plane_chunk``)."""
    rb = _row_bytes(d, elt)
    assert rb == {4: 128 if d % 32 == 0 else 64,
                  2: 128 if d % 64 == 0 else 64 if d % 32 == 0 else 32}[elt]
    ksub = rb // 32
    for rows in (64, tile):
        where = _tma_tile(rows, d, elt, rb)
        for ks in range(d * elt // 32):
            start = (ks // ksub) * rows * rb + 32 * (ks % ksub)
            for mn in range(rows):
                for kb in range(0, 32, elt):
                    assert where[_kmajor_read(start, mn, kb, elt, rb)] == (
                        mn, (32 * ks + kb) // elt)
    if elt == 2:
        where = _tma_tile(tile, d, elt, rb)
        sub = d * elt // rb
        lbo = tile * rb if sub > 1 else 16
        for j in range(tile // 16):
            start = 16 * rb * j
            for n in range(d):
                for k in range(16):
                    assert where[_mnmajor_read(start, n, k, elt, rb, lbo)] \
                        == (16 * j + k, n)
    if elt == 4:
        where = _tma_tile(tile, d, elt, rb)
        for r in range(tile):
            for c16 in range(d // 4):
                assert where[_plane_chunk(r, c16, tile, rb)] == (r, 4 * c16)


def test_shared_memory_of_every_instantiation():
    """_flash_smem, the host's mirror of ff_smem and hb_smem (the GPU
    tests hold it against the source's): every instantiation within the
    232,448 bytes a block may have, head dimensions 32, 64 and 128 as
    before; bf16 F2 above 64 keeps F3's block (two warpgroups, 64-row
    tiles) and so its bytes; f32 above 64 would not fit with two consumer
    warpgroups' 128 own rows over 64-row tiles (F1 at 80: 3584 d bytes);
    no instantiation but the multiples of 16 up to 128."""
    want = {  # (F1, F2, F3) at d = 16, 32, ..., 128
        torch.float32: ((58952, 51872, 43680), (116296, 101024, 84640),
                        (173640, 150176, 125600), (230984, 199328, 166560),
                        (144712, 124832, 104352), (173384, 149408, 124832),
                        (202056, 173984, 145312), (230728, 198560, 165792)),
        torch.bfloat16: ((22664, 28864, 28864), (43144, 53440, 53440),
                         (63624, 78016, 78016), (84104, 102592, 102592),
                         (104584, 127168, 127168), (125064, 151744, 151744),
                         (145544, 176320, 176320), (166024, 200896, 200896))}
    names = ("flash_forward", "flash_backward_dkv", "flash_backward_dq")
    assert K.FLASH_INSTANCES == (16, 32, 48, 64, 80, 96, 112, 128)
    for dtype, rows in want.items():
        for d, row in zip(K.FLASH_INSTANCES, rows):
            got = tuple(K._flash_smem(n, dtype, d) for n in names)
            assert got == row, (dtype, d)
            assert max(got) <= K.FLASH_SMEM_LIMIT
    # F1 f32 at 128 with 128 own rows: Q's planes alone take 128 KB.
    assert 2 * 128 * 128 * 4 + 2 * 2 * 32 * 128 * 4 * 2 > K.FLASH_SMEM_LIMIT
    assert 3584 * 80 > K.FLASH_SMEM_LIMIT
    for name in names:
        for d in (100, 144):
            with pytest.raises(ValueError):
                K._flash_tiles(name, torch.float32, d)
