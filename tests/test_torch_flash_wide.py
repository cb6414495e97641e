"""The design of the wide flash kernels (F1-F3 at every head dimension
d = 128 c above 128: ``csrc/flash_forward_wide.cu``,
``csrc/flash_backward_wide.cu``) on the CPU.

Their schedule emulated in torch on one head.  F1: a block owns 64 query
rows per consumer warpgroup and a group of two chunks of 128 columns of o
(``K._flash_wide_groups``: one block a row tile at c = 2).  F2 and F3: a
block owns 64 rows of its own side and a group of the output chunks (two,
one in f32 F2, four in bf16 F3 above c = 2), its two warpgroups
splitting the products by operand.  The first products (S, and dP in the
backward) contract over all of d, chunk by chunk in the order 0 .. c - 1,
each chunk's product as the kernel multiplies it (f32 as three TF32
products, bf16 exactly) added to one f32 sum; the online softmax (F1) runs
per kv tile as ``tests/test_torch_flash_forward.py`` emulates it, and the
backward recomputes P = exp2 of the logits less lse and dS = P (dP - di)
per looped tile, P and dS rounded to bf16 before the second products in
bf16.  The chunks of each output, joined, are held against an f64
evaluation of the function with the tolerances of ``chip_smoke.py`` (1e-4
of max(1, max |want|) in f32, 2e-2 in bf16); the blocks of a row tile must
hold the same m, l and lse (F1), P and dS (backward) to the bit, which the
fixed chunk order gives and an order that starts at a block's own chunk
would not.  Then the shared memory and tiles of the wide instances against
hand-computed budgets, and the grids of F1, F2 and F3 against the chunks.
The
emulation does not model the card's accumulation order inside a
product.
"""

import numpy as np
import pytest
import torch

from fewbit_tpu_torch.ops import kernels as K
from fewbit_tpu_torch.ops.flash_attention import DEFAULT_MASK_VALUE

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LOG2E = 1.4426950408889634
CHUNK = 128


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the emulation runs many
    small products, whose parallel regions stall when the test workers
    share the cores (the module took 531 s under six workers with torch's
    default threads, 6 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _first_product(a, b, dtype, order):
    """``a b^T`` over d, one chunk of 128 columns at a time in ``order``,
    each chunk's product added to the running f32 sum."""
    acc = torch.zeros(a.shape[0], b.shape[0])
    for i in order:
        cols = slice(CHUNK * i, CHUNK * (i + 1))
        acc = acc + _product(a[:, cols], b[:, cols].t(), dtype)
    return acc


def _second_product(x, b, dtype):
    """``x b``, x an accumulator fragment (bf16: packed into bf16)."""
    if dtype == torch.bfloat16:
        x = x.bfloat16()
    return _product(x, b, dtype)


def _keep(seg_q, seg_kv, causal, sq, sk):
    keep = torch.ones(sq, sk, dtype=torch.bool)
    if seg_q is not None:
        keep &= seg_q[:, None] == seg_kv[None, :]
    if causal:
        keep &= torch.arange(sk)[None, :] <= torch.arange(sq)[:, None]
    return keep


def _logits(a, b, rows, cols, keep, scale, dtype, order, transposed=False):
    """The masked logits of (rows, cols) as the block computes them: its own
    rows' chunks against the looped tile's, then sm_scale, then the mask
    value where the mask is false."""
    val = _first_product(a[rows], b[cols], dtype, order) * scale
    mask = keep[cols][:, rows].t() if transposed else keep[rows][:, cols]
    return torch.where(mask, val, val + DEFAULT_MASK_VALUE)


def _forward_group(q, k, v, keep, causal, scale, dtype, group, order):
    """The block of F1 that owns the chunks ``group`` of o, for every row
    tile: ``(o_g, m, l, lse)``, o_g the group's columns; a block of 64 wgs
    query rows over kv tiles, S over all of d in ``order``, P V over the
    group's columns."""
    wgs, tile, _ = K._flash_tiles("flash_forward", dtype, q.shape[1])
    block = 64 * wgs
    sq, sk = q.shape[0], k.shape[0]
    cols_j = slice(CHUNK * group[0], CHUNK * (group[-1] + 1))
    width = CHUNK * len(group)
    o = torch.zeros(sq, width)
    m_all, l_all, lse = (torch.zeros(sq) for _ in range(3))
    for row0 in range(0, sq, block):
        t1 = -(-sk // tile)
        if causal:
            t1 = min(t1, (min(row0 + block, sq) - 1) // tile + 1)
        for w0 in range(row0, min(row0 + block, sq), 64):
            rows = torch.arange(w0, min(w0 + 64, sq))
            m = torch.full((len(rows),), -float("inf"))
            l = torch.zeros(len(rows))
            acc = torch.zeros(len(rows), width)
            for t in range(t1):
                l0 = tile * t
                if causal and l0 > w0 + 63:
                    continue  # the warpgroup skips it
                cols = torch.arange(l0, min(l0 + tile, sk))
                val = _logits(q, k, rows, cols, keep, scale, dtype, order)
                m_new = torch.maximum(m, val.amax(1))
                warp = (rows - w0) // 16
                for w in warp.unique():
                    rows_w = warp == w
                    if not ((m_new - m)[rows_w] * LOG2E > 8).any():
                        m_new[rows_w] = m[rows_w]
                alpha = torch.exp2((m - m_new) * LOG2E)
                p = torch.exp2((val - m_new[:, None]) * LOG2E)
                l = l * alpha + p.sum(1)
                acc = acc * alpha[:, None] + _second_product(
                    p, v[cols][:, cols_j], dtype)
                m = m_new
            o[rows] = acc / l[:, None]
            m_all[rows], l_all[rows] = m, l
            lse[rows] = m + torch.log(l)
    return o.to(dtype), m_all, l_all, lse


def _backward_group(q, k, v, do, keep, lse, di, causal, scale, dtype,
                    group, dkv, order):
    """The blocks of F2 (dkv: ``(dk, dv, p)``) or F3 (``(dq, p)``) that own
    the output chunks ``group``: 64 own rows a block over looped tiles, P
    and dS recomputed per tile from the chunked first products, each second
    product over the group's columns; dk, dv, dq those columns, ``p`` the
    joined P (query by key) the blocks computed, for the bit check."""
    name = "flash_backward_dkv" if dkv else "flash_backward_dq"
    tile = K._flash_wide_bwd(name, dtype, q.shape[1]).tile
    block = 64
    sq, sk = q.shape[0], k.shape[0]
    cols_j = slice(CHUNK * group[0], CHUNK * (group[-1] + 1))
    n_res, n_loop = (sk, sq) if dkv else (sq, sk)
    width = CHUNK * len(group)
    da = torch.zeros(n_res, width)
    db = torch.zeros(n_res, width)
    p_all = torch.zeros(sq, sk)
    for row0 in range(0, n_res, block):
        t0, t1 = 0, -(-n_loop // tile)
        if causal:
            if dkv:
                t0 = row0 // tile
            else:
                t1 = min(t1, (min(row0 + block, sq) - 1) // tile + 1)
        rows = torch.arange(row0, min(row0 + block, n_res))
        for t in range(t0, t1):
            cols = torch.arange(tile * t, min(tile * (t + 1), n_loop))
            if dkv:  # S^T = K Q^T, dP^T = V dO^T: rows keys, cols queries
                val = _logits(k, q, rows, cols, keep, scale, dtype, order,
                              transposed=True)
                dp = _first_product(v[rows], do[cols], dtype, order)
                p = torch.exp2((val - lse[cols][None]) * LOG2E)
                ds = p * (dp - di[cols][None])
                db[rows] += _second_product(p, do[cols][:, cols_j], dtype)
                da[rows] += _second_product(ds, q[cols][:, cols_j], dtype)
                p_all[cols[:, None], rows[None]] = p.t()
            else:  # S = Q K^T, dP = dO V^T
                val = _logits(q, k, rows, cols, keep, scale, dtype, order)
                dp = _first_product(do[rows], v[cols], dtype, order)
                p = torch.exp2((val - lse[rows][:, None]) * LOG2E)
                ds = p * (dp - di[rows][:, None])
                da[rows] += _second_product(ds, k[cols][:, cols_j], dtype)
                p_all[rows[:, None], cols[None]] = p
    da = (da * scale).to(dtype)
    return ((da, db.to(dtype), p_all) if dkv else (da, p_all))


def _f64(q, k, v, do, keep, scale):
    """o, lse, dq, dk, dv of the function in f64."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    s = q @ k.t() * scale + torch.where(keep, 0.0, DEFAULT_MASK_VALUE)
    lse = torch.logsumexp(s, 1)
    p = torch.exp(s - lse[:, None])
    o = p @ v
    di = (o * do).sum(1)
    ds = p * (do @ v.t() - di[:, None]) * scale
    return o, lse, ds @ k, ds.t() @ q, p.t() @ do


def _head(sq, sk, d, mode, dtype, seed):
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(n, d).astype(np.float32))
                   .to(dtype) for n in (sq, sk, sk, sq))
    seg_q = seg_kv = None
    if mode == "segments":  # three documents of unequal length
        def ids(n):
            return torch.from_numpy(np.searchsorted(
                [n // 5, n // 2], np.arange(n), side="right").astype(
                    np.int32))
        seg_q, seg_kv = ids(sq), ids(sk)
    elif mode == "padded":  # the padding mask of a RoBERTa row
        seg_q = (torch.arange(sq) < sq * 3 // 4).int()
        seg_kv = (torch.arange(sk) < sk * 3 // 4).int()
    return q, k, v, do, seg_q, seg_kv


def _within(name, got, want, dtype):
    bound = TOL[dtype] * max(1.0, float(want.abs().max()))
    err = float((got.double() - want).abs().max())
    # Another order of sums and other roundings than f64: never 0, and
    # inside the tolerance the card's check uses.
    assert 0 < err <= bound, (name, err, bound)


WIDE_CASES = [(256, 256, 256, True, "none"), (256, 200, 200, True,
                                               "segments"),
              (256, 130, 300, False, "padded"), (384, 300, 130, True,
                                                 "none"),
              (384, 97, 97, False, "segments"), (512, 160, 160, True,
                                                 "padded")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d,sq,sk,causal,mode", WIDE_CASES,
                         ids=[f"d{c[0]}_{c[4]}_{'causal' if c[3] else 'full'}"
                              f"_{c[1]}x{c[2]}" for c in WIDE_CASES])
def test_wide_schedule_against_f64(d, sq, sk, causal, mode, dtype):
    """F1, F2 and F3 at head dimensions 256, 384 and 512 as the wide
    kernels schedule them, the outputs' chunks joined, against f64; the
    blocks of every row tile agree on m, l, lse and P to the bit."""
    c = d // CHUNK
    q, k, v, do, seg_q, seg_kv = _head(sq, sk, d, mode, dtype, sq + d)
    scale = d ** -0.5
    keep = _keep(seg_q, seg_kv, causal, sq, sk)
    order = range(c)
    fwd = [_forward_group(q, k, v, keep, causal, scale, dtype, g, order)
           for g in K._flash_wide_groups("flash_forward", dtype, d)]
    assert len(fwd) == -(-c // 2)
    for _, m, l, lse_j in fwd[1:]:
        assert torch.equal(m, fwd[0][1]) and torch.equal(l, fwd[0][2])
        assert torch.equal(lse_j, fwd[0][3])
    o = torch.cat([f[0] for f in fwd], 1)
    lse = fwd[0][3]  # chunk 0's block's, the one the kernel stores
    o64, lse64, dq64, dk64, dv64 = _f64(q, k, v, do, keep, scale)
    live = keep.any(1)
    _within("o", o, o64, dtype)
    _within("lse", lse[live], lse64[live], dtype)
    # The backward on the forward's lse, and di as the wrapper computes it.
    di = (o.float() * do.float()).sum(1)
    dkv = [_backward_group(q, k, v, do, keep, lse, di, causal, scale, dtype,
                           g, True, order)
           for g in K._flash_wide_groups("flash_backward_dkv", dtype, d)]
    dqs = [_backward_group(q, k, v, do, keep, lse, di, causal, scale, dtype,
                           g, False, order)
           for g in K._flash_wide_groups("flash_backward_dq", dtype, d)]
    for got in dkv[1:]:
        assert torch.equal(got[2], dkv[0][2])
    for got in dqs[1:]:
        assert torch.equal(got[1], dqs[0][1])
    _within("dk", torch.cat([g[0] for g in dkv], 1), dk64, dtype)
    _within("dv", torch.cat([g[1] for g in dkv], 1), dv64, dtype)
    _within("dq", torch.cat([g[0] for g in dqs], 1), dq64, dtype)


def test_chunk_order_fixed_in_every_block():
    """Why every block sums S's chunks in the order 0 .. c - 1: at three
    chunks in f32, a block that started at its own chunk (j, j + 1, ...)
    would hold other bits of S than its neighbours, and so another m, l and
    lse (two chunks commute: a + b is b + a)."""
    q, k, *_ = _head(64, 64, 384, "none", torch.float32, 7)
    base = _first_product(q, k, torch.float32, range(3))
    rotated = _first_product(q, k, torch.float32, (1, 2, 0))
    assert not torch.equal(base, rotated)
    assert float((base - rotated).abs().max()) < 1e-4
    two = _first_product(q[:, :256], k[:, :256], torch.float32, (0, 1))
    assert torch.equal(two, _first_product(q[:, :256], k[:, :256],
                                           torch.float32, (1, 0)))


# (kernel, dtype) -> (warpgroups, tile rows, stages, bytes) of the wide
# instances, by hand from wide_fwd_smem and wide_bwd_smem.  F1 in f32,
# whatever the number of chunks (one warpgroup, 32-row tiles, two stages):
# at c = 2 the query rows resident (64 KB) and a stage K's chunk as TF32
# hi and lo planes (32 KB); above, a stage the query rows' chunk raw too;
# part 2 two slots of V's transposed planes, V's staging, the barriers and
# 1024 bytes of slack.  F2 and F3 in f32
# (two consumer warpgroups on 64 own rows, 32-row tiles, four stages of 32
# columns: the own rows' raw slice of both operands and the looped slice's
# hi and lo planes), part 2 (a slot of transposed hi and lo planes per
# chunk owned: F2 one chunk of Q and dO, F3 two of K), the exchange of P
# (F3: and dS), the barriers and the slack.
WIDE_BUDGETS = {
    ("flash_forward", torch.float32): (
        1, 32, 2, 65536 + 2 * 2 * 16384 + 2 * 2 * 16384 + 2 * 16384
        + 9 * 8 + 1024),
    ("flash_backward_dkv", torch.float32): (
        2, 32, 4, 4 * (2 * 8192 + 2 * 2 * 4096) + 2 * 2 * 16384 + 8192
        + 15 * 8 + 1024),
    ("flash_backward_dq", torch.float32): (
        2, 32, 4, 4 * (2 * 8192 + 2 * 2 * 4096) + 2 * 2 * 16384 + 2 * 8192
        + 17 * 8 + 1024),
}
# bf16 F2 and F3 (64-row tiles, a stage one chunk, two chunks a block), at
# c = 2 (the own rows resident, 2 x 32 KB, four stages of the looped tile's
# chunk of both operands, no part 2) and above (two stages of the own rows'
# and the looped tile's chunks, part 2 a slot per chunk owned: F2 two of Q
# and dO, F3 four of K), with the exchange of P (F3: and dS), the barriers
# and the slack.
WIDE_BF16_BACKWARD = {
    ("flash_backward_dkv", True): (
        2, 64, 4, 2 * 32768 + 4 * 2 * 16384 + 16384 + 17 * 8 + 1024),
    ("flash_backward_dkv", False): (
        2, 64, 2, 2 * 4 * 16384 + 2 * 2 * 16384 + 16384 + 13 * 8 + 1024),
    ("flash_backward_dq", True): (
        2, 64, 4, 2 * 32768 + 4 * 2 * 16384 + 2 * 16384 + 17 * 8 + 1024),
    ("flash_backward_dq", False): (
        2, 64, 2, 2 * 4 * 16384 + 4 * 16384 + 2 * 16384 + 17 * 8 + 1024),
}


# bf16 F1 (two warpgroups, 64-row tiles, a stage a chunk of K or V): the
# query rows resident (32 KB a chunk) beside eight stages up to c = 3 and
# six at c = 4; above, four stages that carry the query rows' chunk too.
WIDE_BF16_FORWARD = {
    2: (2, 64, 8, 2 * 32768 + 8 * 16384 + 21 * 8 + 1024),
    3: (2, 64, 8, 3 * 32768 + 8 * 16384 + 21 * 8 + 1024),
    4: (2, 64, 6, 4 * 32768 + 6 * 16384 + 17 * 8 + 1024),
    5: (2, 64, 4, 4 * (32768 + 16384) + 13 * 8 + 1024),
}


def _wide_budget(name, dtype, d):
    if dtype == torch.bfloat16:
        if name == "flash_forward":
            return WIDE_BF16_FORWARD[min(d // CHUNK, 5)]
        return WIDE_BF16_BACKWARD[name, d == 2 * CHUNK]
    return WIDE_BUDGETS[name, dtype]


@pytest.mark.parametrize("d", [256, 384, 512, 1280])
def test_shared_memory_of_the_wide_instances(d):
    """_flash_tiles and _flash_smem of the wide kernels against the budgets
    above, each within the 232,448 bytes a block may have; no
    instantiation at a head dimension above 128 that is not a multiple of
    128."""
    for name in ("flash_forward", "flash_backward_dkv", "flash_backward_dq"):
        for dtype in (torch.float32, torch.bfloat16):
            wgs, tile, stages, smem = _wide_budget(name, dtype, d)
            assert K._flash_tiles(name, dtype, d) == (wgs, tile, stages)
            assert K._flash_smem(name, dtype, d) == smem <= K.FLASH_SMEM_LIMIT
        assert K.flash_instance(d) == d
    assert [_wide_budget(n, torch.float32, d)[3] for n in (
        "flash_forward", "flash_backward_dkv", "flash_backward_dq")] == [
        230472, 205944, 214152]
    assert [_wide_budget(n, torch.bfloat16, d)[3] for n in (
        "flash_forward", "flash_backward_dkv", "flash_backward_dq")] == (
        [197800, 214152, 230536] if d == 256 else
        [{384: 230568, 512: 230536}.get(d, 197736), 214120, 230536])
    for bad in (144, 192, 200, 257, d + 64):
        with pytest.raises(ValueError, match=f"head dimension {bad}"):
            K._flash_tiles("flash_forward", torch.float32, bad)
        with pytest.raises(ValueError, match=f"head dimension {bad}"):
            K.flash_instance(bad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [256, 384, 512, 1280])
def test_wide_backward_grid_covers_every_chunk(d, dtype):
    """Every wide F2 and F3 instance fits the 232,448 bytes a block may
    have, and the blocks of a row tile (``_flash_wide_groups``, in the
    order of ``blockIdx.x``) own every chunk of the outputs exactly once,
    at most ``nj`` each, in order; bf16 keeps its own rows resident at
    c = 2 only, and one block then owns both chunks."""
    c = d // CHUNK
    for name in ("flash_backward_dkv", "flash_backward_dq"):
        plan = K._flash_wide_bwd(name, dtype, d)
        assert K._flash_smem(name, dtype, d) <= K.FLASH_SMEM_LIMIT
        groups = K._flash_wide_groups(name, dtype, d)
        assert len(groups) == -(-c // plan.nj)
        assert [j for g in groups for j in g] == list(range(c))
        assert all(1 <= len(g) <= plan.nj for g in groups)
        assert plan.res == (dtype == torch.bfloat16 and c == 2)
        assert K._flash_tiles(name, dtype, d)[1:] == (plan.tile,
                                                      plan.stages)
    assert len(K._flash_wide_groups("flash_backward_dq", dtype, 256)) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [256, 384, 512, 1280])
def test_wide_forward_grid_covers_every_chunk(d, dtype):
    """Every wide F1 instance fits the 232,448 bytes a block may have, and
    the blocks of a row tile (``_flash_wide_groups``, in the order of
    ``blockIdx.x``) own every chunk of o exactly once, at most two each,
    in order: one block a row tile at c = 2, and at odd c a last block of
    one chunk.  The query rows stay resident where they fit: bf16 up to
    c = 4, f32 at c = 2."""
    c = d // CHUNK
    plan = K._flash_wide_fwd(dtype, d)
    assert K._flash_smem("flash_forward", dtype, d) <= K.FLASH_SMEM_LIMIT
    groups = K._flash_wide_groups("flash_forward", dtype, d)
    assert plan.nj == 2 and len(groups) == -(-c // 2)
    assert [j for g in groups for j in g] == list(range(c))
    assert all(1 <= len(g) <= 2 for g in groups)
    assert len(groups[-1]) == 2 - c % 2
    assert plan.res == (c <= 4 if dtype == torch.bfloat16 else c == 2)
    assert K._flash_tiles("flash_forward", dtype, d) == (
        2 if dtype == torch.bfloat16 else 1, plan.tile, plan.stages)
