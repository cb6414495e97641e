"""The schedule of bf16 F2 above head dimension 64 (``csrc/flash_backward.cuh``,
``hb_self_fed``) on the CPU.

There the dK/dV kernel keeps the shape of head dimension 64 (two consumer
warpgroups of 64 own rows, 64-row looped tiles, a ring of four stages) but
runs no producer warpgroup: the second warpgroup's first warp issues the
TMA loads and copies each looped tile's row values (lse, di, segment ids)
by cp.async, 33 arrivals on a stage's full barrier.  Emulated here: the
tiled arithmetic of a block (S^T and dP^T over d, P by exp2 less lse, dS,
P and dS rounded to bf16, dV and dK summed tile by tile, sm_scale at the
store) against an f64 evaluation at head dimensions 80 to 128 with the
tolerance of ``chip_smoke.py`` (2e-2 of max(1, max |want|)); the issuing
warp's order (four tiles at first, then one a tile into the stage of the
tile before) against the ring's barriers; the row values as the lanes copy
them and the one-id check each warp makes from them against the producer's
flags; the grid against every own row; and the block's shape, shared
memory and register arithmetic.
"""

import numpy as np
import pytest
import torch

from fewbit_tpu_torch.ops import kernels as K
from fewbit_tpu_torch.ops.flash_attention import (DEFAULT_MASK_VALUE,
                                                  flash_forward_plain)

TOL = 2e-2  # bf16, of max(1, max |want|)
LOG2E = 1.4426950408889634
SELF_FED = (80, 96, 112, 128)  # the bf16 F2 instantiations so run
STAGES, TILE, BLOCK = 4, 64, 128  # the ring, a looped tile, own rows


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs, as the other flash
    emulations: their many small products stall under the test workers
    with torch's default threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ids(n, n0, mode):
    """Segment ids of n positions: three documents, or the padding of a
    row that keeps 3 n0 / 4 positions, their borders at the same positions
    on both sides (n0 = min(sq, sk)), so that every query keeps a key."""
    pos = torch.arange(n)
    if mode == "segments":
        return ((pos >= n0 // 5).int() + (pos >= n0 // 2).int())
    return (pos < n0 * 3 // 4).int()


def _head(sq, sk, d, mode, seed):
    rng = np.random.RandomState(seed)
    q, do = (torch.from_numpy(rng.randn(1, 1, sq, d).astype(np.float32))
             .bfloat16() for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(1, 1, sk, d).astype(np.float32))
            .bfloat16() for _ in range(2))
    n0 = min(sq, sk)
    seg_q, seg_kv = (_ids(n, n0, mode)[None] for n in (sq, sk))
    causal = mode != "padded" or sq == sk
    scale = d ** -0.5
    o, lse = flash_forward_plain(q, k, v, seg_q, seg_kv, causal, scale)
    di = (o.float() * do.float()).sum(-1)
    keep = seg_q[0][:, None] == seg_kv[0][None, :]
    if causal:
        keep &= torch.arange(sk)[None, :] <= torch.arange(sq)[:, None]
    return ([t[0, 0] for t in (q, k, v, do)], lse[0, 0], di[0, 0], keep,
            causal, scale)


def _emulate_f2(q, k, v, do, lse, di, keep, causal, scale):
    """bf16 F2 as the self-fed blocks compute it: ``(dk, dv)``."""
    sq, sk = q.shape[0], k.shape[0]
    dk = torch.zeros(sk, q.shape[1])
    dv = torch.zeros(sk, q.shape[1])
    for row0 in range(0, sk, BLOCK):
        t0 = row0 // TILE if causal else 0
        for wg in range(2):
            first = row0 + 64 * wg
            if first >= sk:
                continue
            rows = torch.arange(first, min(first + 64, sk))
            for t in range(t0, -(-sq // TILE)):
                cols = torch.arange(TILE * t, min(TILE * (t + 1), sq))
                # S^T = K Q^T and dP^T = V dO^T: rows keys, columns queries.
                s_t = k[rows].float() @ q[cols].float().t()
                dp_t = v[rows].float() @ do[cols].float().t()
                val = s_t * scale + torch.where(keep[cols][:, rows].t(), 0.0,
                                                DEFAULT_MASK_VALUE)
                p = torch.exp2((val - lse[cols][None]) * LOG2E)
                ds = p * (dp_t - di[cols][None])
                dv[rows] += p.bfloat16().float() @ do[cols].float()
                dk[rows] += ds.bfloat16().float() @ q[cols].float()
    return (dk * scale).bfloat16(), dv.bfloat16()


def _f64(q, k, v, do, lse, di, keep, scale):
    q, k, v, do, lse, di = (t.double() for t in (q, k, v, do, lse, di))
    s = q @ k.t() * scale + torch.where(keep, 0.0, DEFAULT_MASK_VALUE)
    p = torch.exp(s - lse[:, None])
    ds = p * (do @ v.t() - di[:, None]) * scale
    return ds.t() @ q, p.t() @ do


CASES = [(1000, 1000, "padded"), (333, 517, "segments")]


@pytest.mark.parametrize("d", SELF_FED)
@pytest.mark.parametrize("sq,sk,mode", CASES,
                         ids=[f"{a}x{b}_{m}" for a, b, m in CASES])
def test_self_fed_f2_against_f64(sq, sk, mode, d):
    """The blocks' tiled sums against f64: a causal sequence of 1000 with
    padding (a 40-row tail past the last tile), and sq != sk over three
    documents, causal: error nonzero and within the tolerance."""
    (q, k, v, do), lse, di, keep, causal, scale = _head(sq, sk, d, mode,
                                                        seed=sq + d)
    got = _emulate_f2(q, k, v, do, lse, di, keep, causal, scale)
    want = _f64(q, k, v, do, lse, di, keep, scale)
    for name, g, w in zip(("dk", "dv"), got, want):
        bound = TOL * max(1.0, float(w.abs().max()))
        err = float((g.double() - w).abs().max())
        assert 0 < err <= bound, (name, err, bound)


# ---------------------------------------------------------------------------
# The issuing warp's order against the ring's barriers.
# ---------------------------------------------------------------------------


def _issue_plan(t0, t1):
    """``[(tile, stage, parity, issued during)]`` in the order the issuing
    warp sends them: STAGES tiles before the loop (during None), then one
    while its warpgroup runs the second products of each tile t > t0."""
    plan, it, ist, iph = [], t0, 0, 0

    def issue(during):
        nonlocal it, ist, iph
        if it >= t1:
            return
        plan.append((it, ist, iph, during))
        it += 1
        ist += 1
        if ist == STAGES:
            ist, iph = 0, iph ^ 1

    for _ in range(STAGES):
        issue(None)
    for t in range(t0, t1):
        if t > t0:
            issue(t)
    return plan


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 17, 32])
def test_issue_order_keeps_the_ring(n):
    """Every tile goes out once, in order, into stage (t - t0) % 4 with the
    parity of its round; a tile is out before either warpgroup waits for
    it; and the stage it takes was last the tile four before, which the
    issuing warpgroup itself has finished (its wait on the empty barrier
    is for the other warpgroup alone, one tile behind at most), so neither
    warpgroup waits on a load that waits on it."""
    t0 = 3
    t1 = t0 + n
    plan = _issue_plan(t0, t1)
    assert [p[0] for p in plan] == list(range(t0, t1))
    for tile, stage, parity, during in plan:
        assert stage == (tile - t0) % STAGES
        assert parity == ((tile - t0) // STAGES) & 1
        if during is None:
            assert tile < t0 + STAGES  # a fresh stage: no wait
        else:
            # Out while tile `during` runs: before the next one is waited.
            assert during < tile and during >= tile - STAGES + 1
            # The stage's last tile, tile - STAGES, was done by the
            # issuing warpgroup before `during`: it waits for the other's
            # arrival on tile during - 1 at the latest.
            assert tile - STAGES <= during - 1
    # Two tiles of look-ahead at least while the loop runs.
    issued_by = {tile: during for tile, _, _, during in plan}
    for t in range(t0, t1):
        assert issued_by[t] is None or issued_by[t] <= t - 2


# ---------------------------------------------------------------------------
# The row values: the lanes' copies, and the one-id check.
# ---------------------------------------------------------------------------


def _copies(l0, n_loop, lse, di, ids):
    """The tile's row values as the issuing warp's 32 lanes copy them:
    lane l rows l and l + 32 of lse, di and the ids, zeros past n_loop
    (and ids of zeros without segment ids)."""
    ax = np.zeros(3 * TILE + 4, np.float64)
    for lane in range(32):
        for r in range(lane, TILE, 32):
            row = l0 + r
            if row < n_loop:
                ax[r] = lse[row]
                ax[TILE + r] = di[row]
                ax[2 * TILE + r] = 0 if ids is None else ids[row]
    return ax


def _one_segment_flags(tile_ids, rid):
    """``one_segment`` of the source on the producer's flags: for each 32
    ids whether they are one id, and which."""
    halves = [tile_ids[32 * h:32 * h + 32] for h in range(TILE // 32)]
    one = [(len(set(h)) == 1, h[0]) for h in halves]
    tile_one = all(o[0] for o in one) and len({o[1] for o in one}) == 1
    return tile_one and rid[0] == one[0][1] and rid[1] == one[0][1]


def _one_segment_read(tile_ids, rid):
    """``one_segment_read``: the warp reads the tile's ids itself."""
    first = tile_ids[0]
    return rid[0] == first and rid[1] == first and all(
        i == first for i in tile_ids)


ID_PATTERNS = {
    "one_document": lambda n: np.ones(n, np.int32),
    "padded": lambda n: (np.arange(n) < 700).astype(np.int32),
    "three_documents": lambda n: np.searchsorted(
        [150, 448], np.arange(n), side="right").astype(np.int32),
    "tail": lambda n: np.ones(n, np.int32),
    "none": lambda n: None,
}


@pytest.mark.parametrize("pattern", sorted(ID_PATTERNS))
def test_row_values_and_one_id_check(pattern):
    """Every tile's copies hold each row's lse, di and id at their slots
    (zeros past the sequence: the tail pattern ends mid-tile), and the
    warp's own one-id check agrees with the producer's flags for every
    pair of rows a thread holds, the documents' and the padding's."""
    n_loop = 1000 if pattern != "tail" else 1000 - 17
    rng = np.random.RandomState(len(pattern))
    lse, di = rng.randn(n_loop), rng.randn(n_loop)
    ids = ID_PATTERNS[pattern](n_loop)
    checked = 0
    for t in range(-(-n_loop // TILE)):
        l0 = TILE * t
        ax = _copies(l0, n_loop, lse, di, ids)
        n = min(TILE, n_loop - l0)
        np.testing.assert_array_equal(ax[:n], lse[l0:l0 + n])
        np.testing.assert_array_equal(ax[TILE:TILE + n], di[l0:l0 + n])
        assert not ax[n:TILE].any() and not ax[TILE + n:2 * TILE].any()
        tile_ids = [int(i) for i in ax[2 * TILE:3 * TILE]]
        if ids is not None:
            assert tile_ids[:n] == list(ids[l0:l0 + n])
        assert not any(tile_ids[n:])
        for rid in ((0, 0), (1, 1), (0, 1), (2, 2)):
            assert (_one_segment_read(tile_ids, rid)
                    == _one_segment_flags(tile_ids, rid)), (t, rid)
            checked += 1
    assert checked == 4 * -(-n_loop // TILE)


# ---------------------------------------------------------------------------
# The grid, the shape and the budgets.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sq,sk,causal", [(1, 1, True), (64, 64, True),
                                          (65, 127, False),
                                          (1000, 1000, True),
                                          (333, 517, False),
                                          (2048, 2048, True)])
def test_grid_covers_every_own_row(sq, sk, causal):
    """(b h, ceil(sk / 128)) blocks, 64 own rows a warpgroup: every key row
    is one warpgroup's exactly once, rows past sk are stored by none, and
    under the causal mask the tiles a block skips (before row0 / 64) hold
    no unmasked pair of its rows."""
    owner = np.zeros(sk, np.int64)
    for blk in range(-(-sk // BLOCK)):
        row0 = BLOCK * blk
        t0 = row0 // TILE if causal else 0
        for wg in range(2):
            rows = [r for r in range(row0 + 64 * wg, row0 + 64 * wg + 64)
                    if r < sk]
            owner[rows] += 1
            if causal and rows:
                # Query q meets key r only where q >= r >= row0: the
                # skipped tiles end before row0, the first one kept holds
                # it.
                assert TILE * t0 <= row0 < TILE * (t0 + 1)
    assert (owner == 1).all()


@pytest.mark.parametrize("d", SELF_FED)
def test_self_fed_shape_and_budgets(d):
    """bf16 F2 at 80 to 128: two warpgroups, 64-row tiles, four stages, the
    shared memory of F3's block (the row values' buffers included), within
    the 232,448 bytes a block may have; its dK and dV and the two first
    products take 2 (d / 2) + 2 x 32 registers a thread before the packed
    fragments (2 x 16) and addresses: past the 168 a thread of a
    384-thread block may have from d = 80 on (where it spilled), within the
    255 of a 256-thread block."""
    bf16 = torch.bfloat16
    assert K._flash_tiles("flash_backward_dkv", bf16, d) == (2, TILE, STAGES)
    smem = K._flash_smem("flash_backward_dkv", bf16, d)
    assert smem == K._flash_smem("flash_backward_dq", bf16, d)
    assert smem == (2 * BLOCK * d * 2 + STAGES * 2 * TILE * d * 2
                    + STAGES * (3 * TILE + 4) * 4 + 128 + 1024)
    assert smem <= K.FLASH_SMEM_LIMIT
    held = 2 * (d // 2) + 2 * (TILE // 2) + 2 * (TILE // 8) * 2
    assert held > 168 and held <= 255
