"""The four schedules of kernel 6 on the CPU: their one plain version
against the kernel bodies of the JAX package's ``tools/exp_megakernel.py``,
their envelopes against their shared-memory budgets, the rule inside
``fused_dense_act``, the index arithmetic by which the pipelined schedule
packs codes from 64-row tiles, and the experiment's entry point.

The JAX tool's bodies (``variant_kernel``, ``direct_kernel``,
``pipelined_kernel``) run here through this file's own ``pl.pallas_call``
in interpret mode, with plain ``BlockSpec``s at a small shape; the emit
variant's inner ``emit_pipeline`` is the TPU compiler's and is held through
``pk.fused_dense_act`` in interpret mode instead, the same function.  The
tool's words hold bit i of word g = row ``i gr + g`` of a row block; the
port's hold row ``32 w + i``; the two are compared by decoded codes
(``pk.unpack_block_layout`` against ``unpack_codes``).

Tolerances: codes equal (z is the same f32 sum of the same products on both
sides at these sizes).  y in f32 within 1e-5: two erf implementations, the
Pallas bodies' polynomial one among them (z itself, the ablation's output,
within 1e-6).  y in bf16 within one bf16 rounding step (2^-7 relative).
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import tools.exp_megakernel as jax_tool
from fewbit_tpu.functional.activations import \
    resolve_activation as jax_resolve
from fewbit_tpu.ops import pallas_kernels as pk

import fewbit_tpu_torch
from fewbit_tpu_torch.functional import resolve_activation
from fewbit_tpu_torch.ops import kernels as K
from fewbit_tpu_torch.ops.bitpack import pack_codes, unpack_codes
from fewbit_tpu_torch.tools import exp_megakernel, timing

LUT32 = dict(borders=np.linspace(-3.0, 3.0, 31).tolist(),
             values=np.linspace(-0.1, 1.1, 32).tolist())
# (id, kwargs of resolve_activation): 1 and 3 builtin bits, 5 custom.
LUTS = {"1bit": dict(bits=1), "3bit": dict(bits=3), "lut32": LUT32}
PAIRS = {"f32": (np.float32, torch.float32, torch.float32),
         "bf16_f32": (jnp.bfloat16, torch.bfloat16, torch.float32),
         "bf16": (jnp.bfloat16, torch.bfloat16, torch.bfloat16)}


def _inputs(n, kdim, m, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, kdim).astype(np.float32)
    w = (rng.randn(kdim, m) * 0.1).astype(np.float32)
    return x, w


def _specs(lut):
    jspec, jb, _ = jax_resolve("gelu", **LUTS[lut])
    spec, bd, _ = resolve_activation("gelu", **LUTS[lut])
    return jspec, jb.reshape(1, -1).astype(jnp.float32), spec, bd


def _torch_pair(x, w, in_dt):
    """The port's operands: x, and w as an (out, in) parameter's .t()."""
    xt = torch.from_numpy(x).to(in_dt)
    wt = torch.from_numpy(np.ascontiguousarray(w.T)).to(in_dt).t()
    return xt, wt


def _jax_pair(x, w, jdt):
    return jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)


def _check(y, packed, jy, jpacked, bits, n, m, bn, out_dt):
    """y within the tolerance of its type; the codes equal, each row block
    of the tool's layout decoded on its own."""
    got, want = y.float().numpy(), np.asarray(jy, np.float32)
    if out_dt == torch.float32:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-5)
    gr = bn // pk.GROUP
    jcodes = np.concatenate([
        np.asarray(pk.unpack_block_layout(
            jpacked[:, blk * gr:(blk + 1) * gr], bits, (bn, m)))
        for blk in range(n // bn)])
    np.testing.assert_array_equal(unpack_codes(packed, bits, n).numpy(),
                                  jcodes)


def _out_shapes(bits, n, m, jout):
    return (jax.ShapeDtypeStruct((n, m), jout),
            jax.ShapeDtypeStruct((bits, n // pk.GROUP, m), jnp.uint32))


@pytest.mark.parametrize("pair", list(PAIRS))
@pytest.mark.parametrize("lut", list(LUTS))
@pytest.mark.parametrize("n,kdim,m", [(256, 256, 384), (512, 128, 128)])
def test_plain_matches_variant_kernel(n, kdim, m, lut, pair):
    """M1: the (row, column, k) grid with the accumulator scratch, two k
    steps where K = 256."""
    jdt, in_dt, out_dt = PAIRS[pair]
    jout = jnp.float32 if out_dt == torch.float32 else jnp.bfloat16
    jspec, jb, spec, bd = _specs(lut)
    x, w = _inputs(n, kdim, m, n + m)
    bn, bm, bk = n, 128, 128
    n_k = kdim // bk
    body = lambda *refs: jax_tool.variant_kernel(jspec, bn, bm, bk, n_k,
                                                 True, *refs)
    jy, jpacked = pl.pallas_call(
        body, grid=(n // bn, m // bm, n_k),
        in_specs=[pl.BlockSpec((1, jb.shape[1]), lambda i, j, k: (0, 0)),
                  pl.BlockSpec((bn, bk), lambda i, j, k: (i, k)),
                  pl.BlockSpec((bk, bm), lambda i, j, k: (k, j))],
        out_specs=(pl.BlockSpec((bn, bm), lambda i, j, k: (i, j)),
                   pl.BlockSpec((jspec.bits, bn // pk.GROUP, bm),
                                lambda i, j, k: (0, i, j))),
        out_shape=_out_shapes(jspec.bits, n, m, jout),
        scratch_shapes=[pltpu.VMEM((bn, bm), jnp.float32)],
        interpret=True)(jb, *_jax_pair(x, w, jdt))
    y, packed = K.dense_act_plain(spec, *_torch_pair(x, w, in_dt), None, bd,
                                  out_dt)
    assert y.dtype == out_dt and packed.dtype == torch.int32
    _check(y, packed, jy, jpacked, spec.bits, n, m, bn, out_dt)
    # The wrappers take this plain version for a CPU tensor, all four.
    for wrapper in (K.dense_act_kloop, K.dense_act_direct, K.dense_act_emit,
                    K.dense_act_pipelined):
        launches = wrapper.launches
        y2, packed2 = wrapper(spec, *_torch_pair(x, w, in_dt), None, bd,
                              out_dt)
        assert torch.equal(y2, y) and torch.equal(packed2, packed)
        assert wrapper.launches == launches


@pytest.mark.parametrize("pair", list(PAIRS))
def test_plain_matches_variant_kernel_without_epilogue(pair):
    """M1's ablation: z itself and zero words in plane 0."""
    jdt, in_dt, out_dt = PAIRS[pair]
    jout = jnp.float32 if out_dt == torch.float32 else jnp.bfloat16
    jspec, jb, spec, bd = _specs("3bit")
    n, kdim, m = 256, 256, 256
    x, w = _inputs(n, kdim, m, 3)
    bn, bm, bk = n, 128, 128
    body = lambda *refs: jax_tool.variant_kernel(jspec, bn, bm, bk, 2, False,
                                                 *refs)
    jz, jpacked = pl.pallas_call(
        body, grid=(1, m // bm, 2),
        in_specs=[pl.BlockSpec((1, jb.shape[1]), lambda i, j, k: (0, 0)),
                  pl.BlockSpec((bn, bk), lambda i, j, k: (i, k)),
                  pl.BlockSpec((bk, bm), lambda i, j, k: (k, j))],
        out_specs=(pl.BlockSpec((bn, bm), lambda i, j, k: (i, j)),
                   pl.BlockSpec((jspec.bits, bn // pk.GROUP, bm),
                                lambda i, j, k: (0, i, j))),
        out_shape=_out_shapes(jspec.bits, n, m, jout),
        scratch_shapes=[pltpu.VMEM((bn, bm), jnp.float32)],
        interpret=True)(jb, *_jax_pair(x, w, jdt))
    z, zero = K.dense_act_kloop(spec, *_torch_pair(x, w, in_dt), None, bd,
                                out_dt, epilogue=False)
    assert z.dtype == out_dt
    tol = (dict(rtol=0, atol=1e-6 * float(np.abs(np.asarray(
        jz, np.float32)).max())) if out_dt == torch.float32
        else dict(rtol=2.0 ** -7, atol=1e-6))
    np.testing.assert_allclose(z.float().numpy(), np.asarray(jz, np.float32),
                               **tol)
    assert zero.shape == (1, n // 32, m) and not zero.any()
    assert not np.asarray(jpacked[0]).any()


@pytest.mark.parametrize("pair", list(PAIRS))
@pytest.mark.parametrize("lut", list(LUTS))
@pytest.mark.parametrize("wres", [False, True], ids=["tiled", "wres"])
def test_plain_matches_direct_kernel(wres, lut, pair):
    """M2: no k split, z from the product straight into the epilogue; with
    wres the whole weight is one block and the grid runs over rows."""
    jdt, in_dt, out_dt = PAIRS[pair]
    jout = jnp.float32 if out_dt == torch.float32 else jnp.bfloat16
    jspec, jb, spec, bd = _specs(lut)
    n, kdim, m = 512, 128, 256
    x, w = _inputs(n, kdim, m, 7 + wres)
    bn, bm = n, (m if wres else 128)
    body = lambda *refs: jax_tool.direct_kernel(
        jspec, bn, bm, True, out_dt == torch.bfloat16, *refs)
    jy, jpacked = pl.pallas_call(
        body, grid=(n // bn, m // bm),
        in_specs=[pl.BlockSpec((1, jb.shape[1]), lambda i, j: (0, 0)),
                  pl.BlockSpec((bn, kdim), lambda i, j: (i, 0)),
                  pl.BlockSpec((kdim, bm), lambda i, j: (0, j))],
        out_specs=(pl.BlockSpec((bn, bm), lambda i, j: (i, j)),
                   pl.BlockSpec((jspec.bits, bn // pk.GROUP, bm),
                                lambda i, j: (0, i, j))),
        out_shape=_out_shapes(jspec.bits, n, m, jout),
        interpret=True)(jb, *_jax_pair(x, w, jdt))
    y, packed = K.dense_act_plain(spec, *_torch_pair(x, w, in_dt), None, bd,
                                  out_dt)
    _check(y, packed, jy, jpacked, spec.bits, n, m, bn, out_dt)


@pytest.mark.parametrize("pair", list(PAIRS))
@pytest.mark.parametrize("lut", list(LUTS))
def test_plain_matches_pipelined_kernel(lut, pair):
    """M4: the epilogue of row block i - 1 in the step of block i's
    product, two row blocks and the flush step."""
    jdt, in_dt, out_dt = PAIRS[pair]
    jout = jnp.float32 if out_dt == torch.float32 else jnp.bfloat16
    jspec, jb, spec, bd = _specs(lut)
    n, kdim, m = 512, 128, 256
    x, w = _inputs(n, kdim, m, 11)
    bn, bm = 256, 128
    n_i = n // bn
    body = lambda *refs: jax_tool.pipelined_kernel(jspec, bn, bm, n_i, *refs)
    jy, jpacked = pl.pallas_call(
        body, grid=(m // bm, n_i + 1),
        in_specs=[pl.BlockSpec((1, jb.shape[1]), lambda j, i: (0, 0)),
                  pl.BlockSpec((bn, kdim),
                               lambda j, i: (jnp.minimum(i, n_i - 1), 0)),
                  pl.BlockSpec((kdim, bm), lambda j, i: (0, j))],
        out_specs=(pl.BlockSpec((bn, bm),
                                lambda j, i: (jnp.maximum(i - 1, 0), j)),
                   pl.BlockSpec((jspec.bits, bn // pk.GROUP, bm),
                                lambda j, i: (0, jnp.maximum(i - 1, 0), j))),
        out_shape=_out_shapes(jspec.bits, n, m, jout),
        scratch_shapes=[pltpu.VMEM((2, bn, bm), jnp.float32)],
        interpret=True)(jb, *_jax_pair(x, w, jdt))
    y, packed = K.dense_act_plain(spec, *_torch_pair(x, w, in_dt), None, bd,
                                  out_dt)
    _check(y, packed, jy, jpacked, spec.bits, n, m, bn, out_dt)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("FEWBIT_TPU_NATIVE", "interpret")


@pytest.mark.parametrize("lut", list(LUTS))
@pytest.mark.parametrize("n", [1000, 256], ids=["ragged", "aligned"])
def test_plain_matches_shipped_pallas_kernel(interpret, n, lut):
    """M3's function (its emit_pipeline does not run off the TPU), through
    the shipped Pallas kernel in interpret mode: a ragged N, 1, 3 and 5
    bits."""
    jspec, _, spec, bd = _specs(lut)
    jb = jax_resolve("gelu", **LUTS[lut])[1]
    kdim, m = 128, 384
    x, w = _inputs(n, kdim, m, n)
    jy, jpacked = pk.fused_dense_act(jspec, jnp.asarray(x), jnp.asarray(w),
                                     None, jb)
    y, packed = K.dense_act_emit(spec, *_torch_pair(x, w, torch.float32),
                                 None, bd)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        unpack_codes(packed, spec.bits, n).numpy(),
        np.asarray(pk.unpack_block_layout(jpacked, spec.bits, (n, m))))
    # Rows past N give zero bits in the last word row.
    if n % 32:
        last = packed[:, -1].numpy().astype(np.int64) % 2 ** 32
        assert not (last >> (n % 32)).any()


# ---------------------------------------------------------------------------
# Envelopes, budgets and the shipped rule.
# ---------------------------------------------------------------------------

_OUTS = {torch.float32: (torch.float32,),
         torch.bfloat16: (torch.float32, torch.bfloat16)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tma_store", [False, True], ids=["direct", "emit"])
def test_resident_routes_fit_shared_memory(dtype, tma_store):
    """The direct and the emit route over kernel 6's whole envelope (K to
    4096, M to 4096): the widest tile width that divides M and fits, None
    exactly where none fits."""
    route = K.dense_act_emit_route if tma_store else K.dense_act_direct_route
    count = 0
    for out_dt in _OUTS[dtype]:
        for kdim in range(128, 4097, 128):
            for m in range(128, 4097, 128):
                fits = [bn for bn in K.FG_TILE_N if m % bn == 0
                        and K._dense_act_resident_smem(
                            dtype, out_dt, kdim, bn, tma_store)
                        <= K.FG_SMEM_LIMIT]
                assert route(kdim, m, dtype, out_dt) == (fits[0] if fits
                                                         else None)
                count += 1
    assert count == len(_OUTS[dtype]) * 32 * 32
    # f32 -> bf16 is no pair of the schedules.
    assert route(128, 128, torch.float32, torch.bfloat16) is None
    assert route(128, 128, torch.float16) is None


def test_resident_budget_at_the_experiment_shape():
    bf, f32 = torch.bfloat16, torch.float32
    # The bf16 panel of K = 768 at 96 columns, term by term: the x ring, the
    # panel, the table, nine barriers, the alignment slack.
    assert K._dense_act_resident_smem(bf, bf, 768, 96, False) == (
        4 * 128 * 128 + 768 * 2 * 96 + 256 + 72 + 1024)
    assert K.dense_act_direct_route(768, 3072, bf) == 96
    assert K.dense_act_direct_route(768, 3072, bf, f32) == 96
    # Two staged (128, bn) tiles of y leave room for the 64-wide panel only.
    assert K._dense_act_resident_smem(bf, f32, 768, 64, True) == (
        4 * 128 * 128 + 768 * 2 * 64 + 2 * 128 * 64 * 4 + 256 + 72 + 1024)
    assert K.dense_act_emit_route(768, 3072, bf) == 64
    assert K.dense_act_emit_route(768, 3072, bf, f32) == 64
    # f32 as 3xTF32 keeps two halves of the panel: 590 KB at K = 768.
    assert 2 * 96 * 768 * 4 == 589824
    assert K.dense_act_direct_route(768, 3072, f32) is None
    assert K.dense_act_emit_route(768, 3072, f32) is None
    assert K.dense_act_direct_route(128, 3072, f32) == 96
    assert K.dense_act_direct_route(256, 3072, f32) == 64
    assert K.dense_act_direct_route(512, 3072, f32) is None
    assert K.dense_act_emit_route(128, 3072, f32) == 64


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kloop_and_pipelined_routes_fit_shared_memory(dtype):
    for m in range(128, 8193, 128):
        for route, smem in ((K.dense_act_kloop_route, K._ffn_smem),
                            (K.dense_act_pipelined_route,
                             K._dense_act_pipelined_smem)):
            bn = route(m, dtype)
            assert bn == (96 if m % 96 == 0 else 64) and m % bn == 0
            assert smem(dtype, bn) <= K.FG_SMEM_LIMIT
    assert K._dense_act_pipelined_smem(torch.float32, 96) == (
        4 * (64 + 2 * 96) * 128 + 256 + 64 + 1024)
    with pytest.raises(ValueError):
        K.dense_act_pipelined_route(100, dtype)


def test_shipped_schedule_is_a_rule_of_shapes_and_dtype():
    """The k loop, except for bf16 calls of at least PIPELINED_MIN_TILES
    tiles of 64 x bn; never a schedule whose weight panel might not fit."""
    f32, bf = torch.float32, torch.bfloat16
    for n in (1, 100, 1000, 2048, 4096, 8192, 65536):
        for m in range(128, 4097, 128):
            assert K.dense_act_schedule(n, m, f32) == "kloop"
            bn = 96 if m % 96 == 0 else 64
            tiles = -(-n // 64) * (m // bn)
            want = "pipelined" if tiles >= K.PIPELINED_MIN_TILES else "kloop"
            assert K.dense_act_schedule(n, m, bf) == want
    # The GPT-2 small up projection, and where the measured gain ends.
    assert K.dense_act_schedule(8192, 3072, bf) == "pipelined"
    assert K.dense_act_schedule(4096, 3072, bf) == "pipelined"
    assert K.dense_act_schedule(2048, 3072, bf) == "kloop"
    assert K.dense_act_schedule(3072, 4096, bf) == "pipelined"
    assert K.dense_act_schedule(8192, 3072, f32) == "kloop"
    assert K.KERNELS["dense_act"][3].startswith("fewbit_tpu_torch/csrc/")
    assert (Path(fewbit_tpu_torch.__file__).parent.parent
            / K.KERNELS["dense_act"][3]).exists()


def test_kernels_table_lists_the_four_schedules():
    sites = {"dense_act_kloop": 88, "dense_act_direct": 186,
             "dense_act_emit": 246, "dense_act_pipelined": 312}
    lines = Path(jax_tool.__file__).read_text().splitlines()
    root = Path(fewbit_tpu_torch.__file__).parent.parent
    for name, line in sites.items():
        wrapper, plain, replaces, source = K.KERNELS[name]
        assert replaces == f"tools/exp_megakernel.py:{line}"
        assert "pl.pallas_call(" in lines[line - 1]
        assert plain is K.dense_act_plain and (root / source).exists()
        assert wrapper.launches == K.launch_counts()[name]
    assert len(K.KERNELS) == 14


# ---------------------------------------------------------------------------
# The pipelined schedule's packing, emulated.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bn", [96, 64])
@pytest.mark.parametrize("bits", [1, 3, 6])
@pytest.mark.parametrize("n", [256, 200], ids=["aligned", "ragged"])
def test_pipelined_tile_packing_is_pack_codes_layout(n, bits, bn):
    """The epilogue on 64-row tiles (csrc/dense_act_epilogue.cuh), one
    warpgroup per tile: thread (warp, g, t) holds rows 16 warp + g and + 8
    of the tile; it puts their plane bits at bits g and g + 8 of a 16-bit
    half, the halves are ORed over the 8 lanes of a column, and warps 0/1
    (2/3) store the low/high half of word row0 / 32 (+ 1).  Rows past N
    carry code 0, and word rows past ceil(N / 32) are not stored.  Over
    every tile of a (N, 2 bn) problem each half word of the packed tensor
    is written exactly once, with pack_codes' bits."""
    m = 2 * bn
    words = -(-n // 32)
    rng = np.random.RandomState(bn + bits + n)
    codes = rng.randint(0, 2 ** bits, size=(n, m))
    halves = np.zeros((bits, words, m, 2), np.uint16)
    writes = np.zeros((bits, words, m, 2), np.int64)
    for row0 in range(0, n, 64):                 # tiles, as the grid walks
        for col0 in range(0, m, bn):
            for i in range(bn // 8):
                for q in range((bits + 1) // 2):  # planes 2 q and 2 q + 1
                    for e in range(2):
                        reduced = {}              # (warp, t) -> OR over g
                        for warp in range(4):
                            for g in range(8):
                                for t in range(4):
                                    row = row0 + 16 * warp + g
                                    col = col0 + 8 * i + 2 * t + e
                                    lo = codes[row, col] if row < n else 0
                                    hi = (codes[row + 8, col]
                                          if row + 8 < n else 0)
                                    rows = int(lo) | int(hi) << 8
                                    v = ((((rows >> (2 * q)) & 0x101) << g)
                                         | (((rows >> (2 * q + 1)) & 0x101)
                                            << (g + 16)))
                                    reduced[warp, t] = (
                                        reduced.get((warp, t), 0) | v)
                        for warp in range(4):
                            word_row = (row0 + 32 * (warp // 2)) // 32
                            if word_row >= words:
                                continue
                            for t in range(4):    # lane g = i % 8 stores
                                col = col0 + 8 * i + 2 * t + e
                                for o in range(2):
                                    b = 2 * q + o
                                    if b < bits:
                                        at = (b, word_row, col, warp & 1)
                                        halves[at] = (reduced[warp, t]
                                                      >> (16 * o)) & 0xFFFF
                                        writes[at] += 1
    assert (writes == 1).all()
    got = (halves[..., 0].astype(np.int64)
           | halves[..., 1].astype(np.int64) << 16)
    want = pack_codes(torch.from_numpy(codes), bits).numpy()
    assert (got == want.astype(np.int64) % 2 ** 32).all()


# ---------------------------------------------------------------------------
# The experiment's entry point, and the package's imports.
# ---------------------------------------------------------------------------


def test_experiment_runs_on_the_cpu(capsys):
    rows = exp_megakernel.main(["--device", "cpu", "--iters", "1",
                                "--rounds", "1"])
    by_kernel = {}
    for row in rows:
        assert row["status"] == "ok" and row["calls"] == 4
        assert row["host_ms"] > 0 and "ms" not in row  # no device metric
        by_kernel.setdefault(row["kernel"], []).append(row["dtype"])
    three = ["f32", "bf16->f32", "bf16"]
    assert by_kernel == {
        None: three, "dense_act": ["f32", "bf16"],
        "dense_act_simt": ["f32", "bf16"],
        "dense_act_kloop": sorted(three * 2, key=three.index),
        "dense_act_direct": three, "dense_act_emit": three,
        "dense_act_pipelined": three}
    out = capsys.readouterr().out
    assert "N=256 K=128 M=256" in out and "on the host" in out
    assert len(out.strip().splitlines()) == 1 + len(rows)


def test_experiment_marks_rows_outside_the_envelope(capsys):
    """At the tool's K = 768 the f32 panel does not fit: the row is printed
    as outside the envelope and nothing is called."""
    rows = exp_megakernel.main(["--device", "cpu", "--iters", "1",
                                "--rounds", "1", "--shape", "64", "768",
                                "384"])
    refused = [r["name"] for r in rows if r["status"] != "ok"]
    assert refused == ["direct f32", "emit f32"]
    assert all("calls" not in r for r in rows if r["status"] != "ok")
    names = [r["name"] for r in rows]
    # Both panel widths where the envelope admits them, one for emit.
    assert "direct(128,96) w-resident bf16" in names
    assert "direct(128,64) w-resident bf16" in names
    assert "emit(128,64) w-resident bf16" in names
    assert "emit(128,96) w-resident bf16" not in names
    assert "outside the envelope" in capsys.readouterr().out


def test_experiment_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exp_megakernel.main(["--iters", "1"])


def test_timer_and_bound():
    calls = []
    ms = timing.timed(lambda: calls.append(1), iters=3, rounds=2, warmup=1,
                      device="cpu")
    assert len(calls) == 1 + 3 * 2 and ms >= 0
    # 38.65 G operations: 0.2343 ms at a third of the TF32 peak, 0.0391 ms
    # at the bf16 peak; 3.35 GB take 1 ms.
    flop = 2 * 8192 * 768 * 3072
    assert timing.bound_ms(flop, "f32", 0) == (
        pytest.approx(0.23427, abs=1e-5), "operations")
    assert timing.bound_ms(flop, "bf16", 0)[0] == pytest.approx(0.03908,
                                                                abs=1e-5)
    assert timing.bound_ms(0, "bf16", 3.35e9) == (pytest.approx(1.0), "bytes")
    assert timing.gemm_rate(torch.bfloat16) == "bf16"


def test_the_port_imports_no_jax():
    """No module of the port imports jax, flax, the JAX package or the JAX
    tools, at any level."""
    banned = {"jax", "jaxlib", "flax", "optax", "fewbit_tpu", "tools"}
    root = Path(fewbit_tpu_torch.__file__).parent
    files = sorted(root.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, (path, name)


def test_the_port_builds_no_path_into_the_jax_package():
    """No module of the port builds a path into ``fewbit_tpu/`` (the JAX
    package): no ``/`` join, ``os.path.join``, ``Path`` or ``open`` takes
    a string naming it, and no string names a file under it but the
    ``file:line`` records of the TPU kernels a kernel replaces.  The LUT
    archive the port loads lies inside the port."""
    import re

    from fewbit_tpu_torch import lut

    record = re.compile(r"^fewbit_tpu/[\w/]+\.py:\d+")

    def names_jax(value):
        return (isinstance(value, str)
                and re.search(r"(^|[/\\])fewbit_tpu($|[/\\])", value)
                is not None)

    root = Path(fewbit_tpu_torch.__file__).parent
    for path in sorted(root.rglob("*.py")):
        tree = ast.parse(path.read_text())
        docs = {id(node.body[0].value) for node in ast.walk(tree)
                if isinstance(node, (ast.Module, ast.FunctionDef,
                                     ast.ClassDef, ast.AsyncFunctionDef))
                and node.body and isinstance(node.body[0], ast.Expr)}
        for node in ast.walk(tree):
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
                parts = (node.left, node.right)
            elif isinstance(node, ast.Call):
                parts = node.args
            else:
                parts = ()
            for part in parts:
                assert not (isinstance(part, ast.Constant)
                            and names_jax(part.value)), (path, part.value)
            if (isinstance(node, ast.Constant) and id(node) not in docs
                    and isinstance(node.value, str)
                    and node.value.startswith("fewbit_tpu/")):
                assert record.match(node.value), (path, node.value)
    assert root in lut.BUILTIN_PATH.parents
