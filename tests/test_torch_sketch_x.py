"""Kernel 2' (the few-bit FFN forward that also sketches x) on the CPU: the
route its host chooses from the shapes against the block's shared-memory
budget, and a numpy emulation of the owner-sliced read of x that it shares
with kernel 1 (``SketchSlice`` in csrc/hopper_gemm.cuh): every (bucket,
column) of the sketch has exactly one owning thread, each thread reads a
fixed number of elements of the k tiles that hold its block's slice, and
the sums it keeps, pass after pass, are the plain countsketch.  Also the
wrappers' CPU paths: the separate sketch pass and ``out=``.

The emulated sums are f32 in pass order, as the kernel adds them; the plain
version sums the same products through torch's reduction, so the two agree
to f32 rounding (1e-6 of max |x|), and bf16 sketches to one bf16 rounding
step (at most 2^-7 relative).
"""

import numpy as np
import pytest
import torch

from fewbit_tpu_torch.functional.activations import resolve_activation
from fewbit_tpu_torch.ops import kernels as K

# Per element type: k per 128-byte tile row and row groups of a warpgroup
# in the sketch read (Operand<T> in csrc/hopper_gemm.cuh).
OPERAND = {torch.float32: (32, 4), torch.bfloat16: (64, 2)}


def _envelope():
    """(K, M) pairs of kernel 2's envelope: K a multiple of 128 up to 4096,
    M a multiple of 512 up to 8192."""
    for kdim in range(128, 4097, 128):
        for m in range(512, 8193, 512):
            yield kdim, m


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_act_sketch_x_route_fits_shared_memory(dtype):
    count = fused_count = 0
    for kdim, m in _envelope():
        fused, bn = K.dense_act_sketch_x_route(kdim, m, dtype)
        widths = [w for w in K.FG_TILE_N if m % w == 0]
        fits = [w for w in widths if K._sketch_x_smem(dtype, w, kdim, m)
                <= K.FG_SMEM_LIMIT]
        # Fused at the first width that leaves room for the slice (96
        # before 64); where none does, kernel 2 at its own width and the
        # separate pass.
        assert fused == bool(fits)
        if fused:
            assert bn == fits[0]
            assert K._sketch_x_smem(dtype, bn, kdim, m) <= K.FG_SMEM_LIMIT
            fused_count += 1
        else:
            assert bn == K.ffn_gemm_route(m, dtype)
        assert K._ffn_smem(dtype, bn) <= K.FG_SMEM_LIMIT and m % bn == 0
        count += 1
    assert count == 32 * 16
    # Both routes occur over the envelope.
    assert 0 < fused_count < count


def test_dense_act_sketch_x_route_at_the_path_shapes():
    # The FFN up projection, 768 -> 3072: fused at 96 in both types.
    for dt in (torch.float32, torch.bfloat16):
        assert K.dense_act_sketch_x_route(768, 3072, dt) == (True, 96)
    # The budget, term by term: kernel 2's block (f32: A rows, B_hi and
    # B_lo rows, 4 stages; 48 sketch accumulators for each of 256 consumer
    # threads; 8 db rows; the table; 8 barriers; alignment slack) and the
    # slice, 128 buckets of 768 / 32 = 24 f32 columns: 2,752 bytes spare.
    assert K._ffn_smem(torch.float32, 96) == (
        4 * (128 + 2 * 96) * 128 + 48 * 256 * 4 + 8 * 96 * 4 + 256 + 64
        + 1024) == 217408
    assert K._sketch_x_smem(torch.float32, 96, 768, 3072) == (
        217408 + 128 * 24 * 4) == K.FG_SMEM_LIMIT - 2752
    assert K._sketch_x_smem(torch.bfloat16, 96, 768, 3072) == (
        168256 + 12288)
    # K = 1024: the f32 slice of 32 columns does not fit beside 96-wide
    # tiles; at 64, 48 column tiles of 22 columns each.
    assert K._sketch_x_smem(torch.float32, 96, 1024, 3072) > K.FG_SMEM_LIMIT
    assert K.dense_act_sketch_x_route(1024, 3072, torch.float32) == (True,
                                                                     64)
    assert K._sketch_x_smem(torch.float32, 64, 1024, 3072) == (167232
                                                               + 11264)
    # Eight column tiles of 1024 / 8 = 128 columns: 64 KB of slice fits
    # neither f32 width, so kernel 2 and then the separate pass; bf16's
    # smaller ring leaves room for it.
    assert K.dense_act_sketch_x_route(1024, 512, torch.float32) == (False,
                                                                    64)
    assert K.dense_act_sketch_x_route(1024, 512, torch.bfloat16) == (True,
                                                                     64)


def _owners(dtype, kdim, m, bn):
    """The emulated read of every block of one bucket tile: ``{(bucket,
    column): [(block, thread, k tile), ...]}`` over the consumer threads
    (warpgroup wg, lt = 0..127) and the k tiles whose column co lies in
    the block's slice [j K / J, (j + 1) K / J), and per block the k tiles
    that did any work."""
    bk, groups = OPERAND[dtype]
    rows = 64 // groups
    jt = m // bn
    owners, worked = {}, {}
    for j in range(jt):
        c_lo, c_hi = j * kdim // jt, (j + 1) * kdim // jt
        worked[j] = set()
        for kt in range(kdim // bk):
            for wg in range(2):
                for lt in range(128):
                    co, rg = lt % bk, lt // bk
                    gk = kt * bk + co
                    if not c_lo <= gk < c_hi:
                        continue
                    worked[j].add(kt)
                    for i in range(rows):
                        row = 64 * wg + rg + groups * i
                        owners.setdefault((row, gk), []).append(
                            (j, (wg, lt), kt))
    return owners, worked


@pytest.mark.parametrize("dtype,kdim,m,bn", [
    (torch.float32, 768, 3072, 96),    # the path shape: 24-column slices
    (torch.float32, 1024, 3072, 64),   # 21 or 22 columns
    (torch.bfloat16, 768, 3072, 96),
    (torch.bfloat16, 1024, 512, 64),   # 128 columns: two bf16 k tiles
    (torch.float32, 128, 8192, 64),    # one column a block
])
def test_sketch_slices_have_one_owner(dtype, kdim, m, bn):
    bk, groups = OPERAND[dtype]
    owners, worked = _owners(dtype, kdim, m, bn)
    # Every (bucket, column) once, by one thread of one block.
    assert sorted(owners) == [(r, c) for r in range(128)
                              for c in range(kdim)]
    assert all(len(v) == 1 for v in owners.values())
    # Only the k tiles that hold the block's slice do any work.
    jt = m // bn
    straddled = 0
    for j, tiles in worked.items():
        c_lo, c_hi = j * kdim // jt, (j + 1) * kdim // jt
        assert tiles == set(range(c_lo // bk, (c_hi - 1) // bk + 1))
        straddled += len(tiles) > 1
    # A thread reads its fixed 64 / G rows of one column of a k tile: per
    # (block, k tile) no thread more than once.
    per = {}
    for (_, c), ((j, th, kt),) in owners.items():
        per[j, th, kt] = per.get((j, th, kt), 0) + 1
    assert set(per.values()) == {64 // groups}
    if (dtype, kdim) == (torch.float32, 768):
        # Half of the 24-column f32 slices (j = 1, 2 mod 4) cross a
        # 32-column k tile boundary: two stages hold the block's columns.
        assert straddled == 16


@pytest.mark.parametrize("passes", [1, 4])
@pytest.mark.parametrize("dtype,kdim,m,bn", [
    (torch.float32, 768, 3072, 96),
    (torch.bfloat16, 768, 3072, 96),
    (torch.float32, 256, 512, 64),
])
def test_sketch_slice_sums_are_the_countsketch(dtype, kdim, m, bn, passes):
    """The kernel's arithmetic on one bucket tile of 128 rows per pass:
    each owner adds sigma_x x of the raw operand to its f32 slot, pass
    after pass, and stores the slot once in the sketch's type: the plain
    countsketch of those rows."""
    k_eff = 128
    n = k_eff * passes
    rng = np.random.RandomState(kdim + passes)
    x = torch.from_numpy(rng.randn(n, kdim).astype(np.float32)).to(dtype)
    sigma = torch.from_numpy((rng.randint(0, 2, n) * 2 - 1)
                             .astype(np.float32))
    xf, sg = x.float().numpy(), sigma.numpy()
    owners, _ = _owners(dtype, kdim, m, bn)
    slot = np.zeros((128, kdim), np.float32)
    for (row, col), ((j, th, kt),) in owners.items():
        for c in range(passes):
            r = c * k_eff + row
            add = np.float32(sg[r] * xf[r, col])
            slot[row, col] = add if c == 0 else np.float32(slot[row, col]
                                                           + add)
    got = torch.from_numpy(slot).to(K.sketch_dtype(dtype))
    want = K.countsketch_signed(x, sigma, k_eff)
    assert got.dtype == want.dtype and got.shape == want.shape
    scale = float(np.abs(xf).max()) * passes
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -7
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * max(1.0, scale), err


def _ffn_args(dtype, n=512, kdim=128, m=512, seed=0):
    rng = np.random.RandomState(seed)
    spec, borders, _ = resolve_activation("gelu", bits=3)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dtype)

    x = t(rng.randn(n, kdim))
    w = t(rng.randn(m, kdim) * kdim ** -0.5)
    bias = t(rng.randn(m) * 0.1)
    sigma, sigma_x = (torch.from_numpy((rng.randint(0, 2, n) * 2 - 1)
                                       .astype(np.float32)) for _ in range(2))
    return spec, x, w.t(), bias, borders, sigma, sigma_x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrappers_write_into_out_and_launch_nothing(dtype):
    spec, x, w, bias, borders, sigma, sigma_x = _ffn_args(dtype)
    k_eff = 256
    args = (spec, x, w, bias, borders, sigma, k_eff)
    launches = K.launch_counts()
    want = K.dense_act_sketch_x_plain(*args, sigma_x)
    out = tuple(torch.full_like(t, -1) for t in want)
    got = K.fused_dense_act_sketch_x(*args, sigma_x, out=out)
    assert all(g is o for g, o in zip(got, out))
    for g, w0 in zip(got, want):
        assert torch.equal(g, w0)
    # The CUDA-core kernel's wrapper and the separate pass on the CPU: the
    # plain versions.
    for g, w0 in zip(K.dense_act_sketch_x_simt(*args, sigma_x), want):
        assert torch.equal(g, w0)
    sk = K.input_sketch(x, sigma_x, k_eff)
    assert torch.equal(sk, want[3])
    sk_out = torch.empty_like(sk)
    assert K.input_sketch(x, sigma_x, k_eff, out=(sk_out,)) is sk_out
    assert torch.equal(sk_out, sk)
    sk2, cs = K.input_sketch(x, sigma_x, k_eff, want_colsum=True)
    assert torch.equal(sk2, sk) and cs.dtype == torch.float32
    assert torch.equal(cs, x.float().sum(0))
    assert K.launch_counts() == launches
    assert K.input_sketch.launches == K.dense_act_sketch_x_simt.launches == 0
