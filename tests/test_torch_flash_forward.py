"""The design of the tensor-core flash forward (F1, ``csrc/flash_forward.cu``)
and of the vectorised few-bit GELU forward (kernel 4, ``csrc/activation.cu``)
on the CPU.

F1: its arithmetic emulated in torch -- f32 operands as three TF32
products, bf16 operands exact with P rounded to bf16 before P V, the online
softmax over kv tiles of the instantiation's rows (64, or 32 in f32 at head
dimension 128, where a block is one warpgroup's 64 query rows; the shapes
of ``K._flash_tiles``) with ``exp2`` and the running max kept in the
units of S (and moved only when a row of a warp's 16 gains more than 2^8 on
it), the tiles a block visits under the causal mask (and a warpgroup's skip
of a tile wholly past its rows), lse = m + log(l) -- held
against an f64 evaluation of the same function, with the tolerances of
``chip_smoke.py`` (1e-4 of max(1, max |want|) in f32, 2e-2 in bf16), which
the kernel meets on the card against the same f64 evaluation.  The
emulation does not model the card's accumulation order.  bf16 above head
dimension 64: the producer warp's segment ids read a tile ahead against
the ids read in place.

Kernel 4: its code rule (the borders counted from a table padded with +inf
to 2^TB entries, four to a read) against ``compare_codes``, and its thread
layout (16 bytes of neighbouring columns of one word position, ragged rows
and columns, 16-byte or per-element accesses) against ``pack_codes``.
"""

import numpy as np
import pytest
import torch

from fewbit_tpu_torch.functional.activations import resolve_activation
from fewbit_tpu_torch.ops import kernels as K
from fewbit_tpu_torch.ops.activations import compare_codes
from fewbit_tpu_torch.ops.bitpack import pack_codes
from fewbit_tpu_torch.ops.flash_attention import (DEFAULT_MASK_VALUE,
                                                  flash_forward_plain)

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LOG2E = 1.4426950408889634
HEAD_DIM = 64
BLOCK, TILE = 128, 64  # query rows of a block, kv rows of a tile (d = 64)


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """Round f32 to nearest, ties away from zero, at 10 mantissa bits."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _product(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """``a @ b`` as the kernel multiplies operands of ``dtype``: f32 as hi hi
    + hi lo + lo hi of the TF32 halves, bf16 values exactly, f32 sums."""
    a, b = a.float(), b.float()
    if dtype == torch.bfloat16:
        return a @ b
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi


def _keep(seg_q, seg_kv, causal, sq, sk):
    keep = torch.ones(sq, sk, dtype=torch.bool)
    if seg_q is not None:
        keep &= seg_q[:, None] == seg_kv[None, :]
    if causal:
        keep &= torch.arange(sk)[None, :] <= torch.arange(sq)[:, None]
    return keep


def _emulate(q, k, v, keep, causal, scale, dtype, block=BLOCK, tile=TILE):
    """One head of F1 as the kernel computes it: ``(o, lse)``; a block of
    ``block`` query rows (64 a consumer warpgroup) over kv tiles of
    ``tile`` rows."""
    sq, sk, d = q.shape[0], k.shape[0], q.shape[1]
    o = torch.zeros(sq, d)
    lse = torch.zeros(sq)
    for row0 in range(0, sq, block):
        t1 = -(-sk // tile)
        if causal:
            t1 = min(t1, (min(row0 + block, sq) - 1) // tile + 1)
        for w0 in range(row0, row0 + block, 64):  # the consumer warpgroups
            if w0 >= sq:
                continue
            rows = torch.arange(w0, min(w0 + 64, sq))
            m = torch.full((len(rows),), -float("inf"))
            l = torch.zeros(len(rows))
            acc = torch.zeros(len(rows), d)
            for t in range(t1):
                l0 = tile * t
                if causal and l0 > w0 + 63:
                    continue  # the warpgroup skips it
                cols = torch.arange(l0, min(l0 + tile, sk))
                val = _product(q[rows], k[cols].t(), dtype) * scale
                val = torch.where(keep[rows][:, cols], val,
                                  val + DEFAULT_MASK_VALUE)
                m_new = torch.maximum(m, val.amax(1))
                # The max moves only where a row of the warp (16 rows) gains
                # more than 2^8 on it.
                warp = (rows - w0) // 16
                for w in warp.unique():
                    rows_w = warp == w
                    if not ((m_new - m)[rows_w] * LOG2E > 8).any():
                        m_new[rows_w] = m[rows_w]
                # The difference in the units of S, then log2 e.
                alpha = torch.exp2((m - m_new) * LOG2E)
                p = torch.exp2((val - m_new[:, None]) * LOG2E)
                l = l * alpha + p.sum(1)
                if dtype == torch.bfloat16:  # the packed A fragments
                    p = p.bfloat16()
                acc = acc * alpha[:, None] + _product(p, v[cols], dtype)
                m = m_new
            o[rows] = acc / l[:, None]
            lse[rows] = m + torch.log(l)
    return o.to(dtype), lse


def _f64(q, k, v, keep, scale):
    q, k, v = (t.double() for t in (q, k, v))
    s = q @ k.t() * scale + torch.where(keep, 0.0, DEFAULT_MASK_VALUE)
    lse = torch.logsumexp(s, 1)
    return torch.softmax(s, 1) @ v, lse


def _head(sq, sk, mode, dtype, seed, d=HEAD_DIM):
    """One head's inputs from a seed and its segment ids (or None)."""
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(sq, d).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(sk, d).astype(np.float32))
            for _ in range(2))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    seg_q = seg_kv = None
    if mode == "segments":  # three documents of unequal length
        def ids(n):
            return torch.from_numpy(np.searchsorted(
                [n // 5, n // 2], np.arange(n), side="right").astype(
                    np.int32))
        seg_q, seg_kv = ids(sq), ids(sk)
    elif mode == "masked_row":  # q rows of an id that no key has
        seg_q = torch.from_numpy((np.arange(sq) % 3).astype(np.int32))
        seg_kv = torch.from_numpy((np.arange(sk) % 2).astype(np.int32))
    return q, k, v, seg_q, seg_kv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("sq,sk,causal,mode", [
    (1024, 1024, True, "none"), (200, 200, True, "segments"),
    (200, 200, False, "segments"), (130, 300, False, "masked_row"),
    (300, 130, True, "none"), (65, 65, False, "none")],
    ids=["gpt", "causal_segments", "segments", "masked_rows_sq_lt_sk",
         "causal_sq_gt_sk", "ragged"])
def test_emulated_arithmetic_against_f64(sq, sk, causal, mode, dtype):
    _emulated_against_f64(sq, sk, causal, mode, dtype, HEAD_DIM)


@pytest.mark.parametrize("d", [32, 128], ids=["d32", "d128"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("sq,sk,causal,mode", [
    (1024, 1024, True, "none"), (200, 200, True, "segments"),
    (130, 300, False, "masked_row"), (65, 65, False, "none")],
    ids=["gpt", "causal_segments", "masked_rows_sq_lt_sk", "ragged"])
def test_emulated_arithmetic_against_f64_at_head_dims(sq, sk, causal, mode,
                                                      dtype, d):
    """The same at head dimensions 32 and 128, on each instantiation's
    block and tile rows (``K._flash_tiles``: at 128 in f32 one warpgroup's
    64 query rows over 32-row kv tiles)."""
    _emulated_against_f64(sq, sk, causal, mode, dtype, d)


# The other instantiations, one shape each (the shapes above in turn).
NEW_INSTANCES = [(16, 1024, 1024, True, "none"),
                 (48, 200, 200, True, "segments"),
                 (80, 130, 300, False, "masked_row"),
                 (96, 65, 65, False, "none"),
                 (112, 1024, 1024, True, "none")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d,sq,sk,causal,mode", NEW_INSTANCES,
                         ids=[f"d{c[0]}" for c in NEW_INSTANCES])
def test_emulated_arithmetic_against_f64_at_every_instantiation(
        d, sq, sk, causal, mode, dtype):
    """The same at the instantiations 16, 48, 80, 96 and 112, on their
    block and tile rows (above 64 in f32 one warpgroup's 64 query rows
    over 32-row kv tiles)."""
    _emulated_against_f64(sq, sk, causal, mode, dtype, d)


def _emulated_against_f64(sq, sk, causal, mode, dtype, d):
    wgs, tile, _ = K._flash_tiles("flash_forward", dtype, d)
    q, k, v, seg_q, seg_kv = _head(sq, sk, mode, dtype, seed=sq + sk, d=d)
    scale = d ** -0.5
    keep = _keep(seg_q, seg_kv, causal, sq, sk)
    o, lse = _emulate(q, k, v, keep, causal, scale, dtype, 64 * wgs, tile)
    o64, lse64 = _f64(q, k, v, keep, scale)
    o0, lse0 = flash_forward_plain(
        q[None, None], k[None, None], v[None, None],
        None if seg_q is None else seg_q[None],
        None if seg_kv is None else seg_kv[None], causal, scale)
    o0, lse0 = o0[0, 0], lse0[0, 0]
    assert torch.isfinite(o).all() and not torch.isnan(lse).any()
    live = keep.any(1)  # rows with a key to attend to
    for name, got, plain, want in (("o", o, o0, o64),
                                   ("lse", lse[live], lse0[live],
                                    lse64[live])):
        bound = TOL[dtype] * max(1.0, float(want.abs().max()))
        err = float((got.double() - want).abs().max())
        # Another order of sums and other roundings than f64: never 0, and
        # inside the tolerance the card's check uses.
        assert 0 < err <= bound, (name, err, bound)
        assert float((plain.double() - want).abs().max()) <= bound, name
    if mode == "masked_row":
        # A row whose every key is masked averages V over the keys, as the
        # plain version: all its logits are the mask value to the bit.
        dead = ~live
        assert dead.sum() > 0
        want = v.float().mean(0).to(dtype)
        torch.testing.assert_close(o[dead], want.expand_as(o[dead]),
                                   rtol=0, atol=TOL[dtype])
        torch.testing.assert_close(o0[dead], want.expand_as(o0[dead]),
                                   rtol=0, atol=TOL[dtype])
        assert torch.equal(lse[dead], lse0[dead])


def test_mask_value_in_log2_units_overflows():
    """Why the kernel keeps the running max in the units of S: the mask
    value times log2 e is -inf in f32, and a masked logit less a masked max
    would be NaN there; in the units of S the difference is 0."""
    mask = torch.tensor(DEFAULT_MASK_VALUE, dtype=torch.float32)
    assert torch.isinf(mask * LOG2E)
    assert torch.isnan(mask * LOG2E - mask * LOG2E)
    assert torch.exp2((mask - mask) * LOG2E) == 1.0
    # A real logit over a masked max: the first term underflows to 0.
    assert torch.exp2((mask - torch.tensor(3.0)) * LOG2E) == 0.0


def test_bf16_probabilities_keep_the_sum_in_f32():
    """P is rounded to bf16 only as the A operand of P V; l sums the f32 P.
    Rounding P before the sum as well would move o by more at long
    sequences; both stay inside bf16's tolerance here."""
    q, k, v, _, _ = _head(256, 256, "none", torch.bfloat16, seed=3)
    keep = _keep(None, None, True, 256, 256)
    o, _ = _emulate(q, k, v, keep, True, HEAD_DIM ** -0.5, torch.bfloat16)
    o64, _ = _f64(q, k, v, keep, HEAD_DIM ** -0.5)
    assert float((o.double() - o64).abs().max()) <= TOL[torch.bfloat16]


def test_wrappers_take_the_plain_version_on_the_cpu():
    q, k, v, seg_q, seg_kv = _head(96, 96, "segments", torch.float32, seed=4)
    args = (q[None, None], k[None, None], v[None, None], seg_q[None],
            seg_kv[None], True, 0.125)
    want = flash_forward_plain(*args)
    for wrapper in (K.flash_forward, K.flash_forward_simt):
        before = wrapper.launches
        got = wrapper(*args)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert wrapper.launches == before  # no kernel was launched
    out = (torch.full_like(want[0], float("nan")),
           torch.full_like(want[1], float("nan")))
    got = K.flash_forward(*args, out=out)
    assert got[0] is out[0] and got[1] is out[1]
    assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])


def test_kernels_table_names_the_new_source():
    wrapper, plain, replaces, source = K.KERNELS["flash_forward"]
    assert source == "fewbit_tpu_torch/csrc/flash_forward.cu"
    assert wrapper is K.flash_forward and plain is flash_forward_plain
    assert replaces.endswith("flash_attention.py:758")
    assert "flash_forward_simt" not in K.KERNELS
    K.reset_launch_counts()
    assert K.flash_forward_simt.launches == 0


# ---------------------------------------------------------------------------
# bf16 F1 above head dimension 64: the producer warp's ids a tile ahead.
# ---------------------------------------------------------------------------


def _producer_stages(seg_kv, sk, t1, ahead, tile=64):
    """What the bf16 producer warp writes into each kv tile's ids (its
    ``AUX`` ints: the tile's ids, then for each half of 32 whether its ids
    are one and which), lane by lane as ``flash_forward_kernel`` runs:
    with ``ahead`` (above 64) each lane reads its row of each half of
    tile t + 1 once tile t's stage is full, and of tile 0 before the
    loop; without, as below 64, each half's ids after the wait for the
    stage.  Rows past sk read as 0."""
    def read(t):
        return [[int(seg_kv[t * tile + 32 * half + lane])
                 if t * tile + 32 * half + lane < sk else 0
                 for lane in range(32)] for half in range(tile // 32)]

    stages = []
    regs = read(0) if ahead and t1 > 0 else None
    for t in range(t1):
        ids = regs if ahead else read(t)
        aux = [i for half in ids for i in half]
        for half in ids:
            aux += [int(all(i == half[0] for i in half)), half[0]]
        stages.append(aux)
        if ahead and t + 1 < t1:
            regs = read(t + 1)
    return stages


@pytest.mark.parametrize("sq,sk,causal", [
    (2048, 2048, True), (1000, 1000, True), (1000, 1000, False),
    (333, 517, True), (517, 333, False), (1, 1, True), (65, 130, False)],
    ids=lambda v: str(v))
def test_producer_ids_ahead_equal_the_ids_in_place(sq, sk, causal):
    """The ids and one-id flags of every tile of every row block, read a
    tile ahead (bf16 above 64), equal those read in place and the segment
    ids of the tile's rows: documents of a few rows and of many, rows
    past sk (the ragged last tile), the causal bound on the tiles."""
    rng = np.random.RandomState(sq + sk)
    seg_kv = np.repeat(np.arange(sk), rng.randint(1, 90, sk))[:sk]
    for row0 in range(0, sq, 128):
        t1 = -(-sk // 64)
        if causal:
            t1 = min(t1, (min(row0 + 128, sq) - 1) // 64 + 1)
        got = _producer_stages(seg_kv, sk, t1, True)
        assert got == _producer_stages(seg_kv, sk, t1, False)
        for t, aux in enumerate(got):
            rows = np.arange(64 * t, 64 * t + 64)
            want = np.where(rows < sk, seg_kv[np.minimum(rows, sk - 1)], 0)
            assert aux[:64] == want.tolist()
            for half in range(2):
                part = want[32 * half:32 * half + 32]
                assert aux[64 + 2 * half:66 + 2 * half] == [
                    int((part == part[0]).all()), int(part[0])]


# ---------------------------------------------------------------------------
# Kernel 4.
# ---------------------------------------------------------------------------


def _table_bits(bits, n_borders):
    """The kernel's TB: the smallest t >= bits whose 2^t - 1 entries hold
    every border."""
    t = bits
    while (1 << t) - 1 < n_borders:
        t += 1
    return t


def _table_codes(x, borders, bits):
    """The code as kernel 4 counts it: borders padded with +inf to four
    times ceil(2^TB / 4) entries, every entry compared in f32."""
    n = 4 * -(-(1 << _table_bits(bits, len(borders))) // 4)
    table = torch.full((n,), float("inf"))
    table[:len(borders)] = borders
    return (x.float()[..., None] > table).sum(-1).to(torch.int32)


def _specs():
    for bits in (1, 2, 3, 4):
        yield f"builtin{bits}", resolve_activation("gelu", bits=bits)
    yield "custom32", resolve_activation(
        "gelu", borders=np.linspace(-3, 3, 31).tolist(),
        values=np.linspace(0, 1, 32).tolist())
    # Fewer levels than the bits hold: the table's padding counts nothing.
    yield "custom5", resolve_activation(
        "gelu", borders=[-1.0, -0.5, 0.0, 0.5], values=[0, 0.2, 0.5, 0.8, 1])


@pytest.mark.parametrize("name", [n for n, _ in _specs()])
def test_act_forward_code_rule_matches_compare_codes(name):
    spec, borders, _ = dict(_specs())[name]
    rng = np.random.RandomState(len(name))
    x = torch.from_numpy((rng.randn(4000) * 3).astype(np.float32))
    special = torch.tensor([float("inf"), -float("inf"), float("nan"), 0.0,
                            -0.0, 3.4e38, -3.4e38])
    # Each border, and its neighbours one f32 step away.
    near = torch.cat([borders, torch.nextafter(borders, borders + 1),
                      torch.nextafter(borders, borders - 1)])
    for xs in (x, special, near):
        want = compare_codes(xs, borders, ())
        assert torch.equal(_table_codes(xs, borders, spec.bits), want)
        assert int(want.max()) < (1 << spec.bits)
    assert int(compare_codes(borders, borders, ()).min()) == 0
    assert int(compare_codes(torch.tensor([float("nan")]), borders,
                             ())[0]) == 0
    for dt in (torch.float32, torch.bfloat16):
        xb = x.to(dt)
        assert torch.equal(_table_codes(xb, borders, spec.bits),
                           compare_codes(xb, borders, ()))


def _kernel4_words(codes, c_vec, bits):
    """The packed words as kernel 4's threads write them: a thread owns 16
    bytes of columns (``c_vec`` of them) of one word position, walks its 32
    rows (rows past R give zero bits) and writes each plane's words of its
    columns that lie inside C."""
    r, c = codes.shape
    words = -(-r // 32)
    packed = torch.full((bits, words, c), -1, dtype=torch.int64)
    for col0 in range(0, c, c_vec):
        cols = range(col0, min(col0 + c_vec, c))
        for w in range(words):
            for b in range(bits):
                for j in cols:
                    word = 0
                    for i in range(32):
                        row = 32 * w + i
                        if row < r:
                            word |= ((int(codes[row, j]) >> b) & 1) << i
                    packed[b, w, j] = word
    # As the kernel's int32 words.
    return torch.where(packed >= 2 ** 31, packed - 2 ** 32,
                       packed).to(torch.int32)


@pytest.mark.parametrize("r,c,c_vec", [(100, 12, 4), (33, 20, 8), (70, 9, 4),
                                       (64, 5, 8)])
def test_act_forward_thread_layout_matches_pack_codes(r, c, c_vec):
    """Ragged R and C, both vector widths: every word written, each equal to
    the plain pack's."""
    rng = np.random.RandomState(r * c)
    codes = torch.from_numpy(rng.randint(0, 8, size=(r, c)).astype(np.int32))
    got = _kernel4_words(codes, c_vec, 3)
    assert torch.equal(got, pack_codes(codes, 3))
