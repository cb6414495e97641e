"""Port parity for the ops layer: LUTs, interval codes, the packed-code
layout, and each kernel's plain PyTorch version against the JAX package's
Pallas wrapper (interpret mode, which keeps f32), on the same numpy inputs
and the same sign vectors.

Tolerances: both sides compute in f32; products and bucket sums agree to
f32 rounding in another summation order (rtol 1e-5, atol 1e-4 on values of
order 1).  Codes are compared exactly: z is the same f32 product on both
sides at these sizes, and a flip would show as a mismatch.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fewbit_tpu.functional.activations import \
    resolve_activation as jax_resolve
from fewbit_tpu.lut import store as jax_store
from fewbit_tpu.ops import activations as jax_act
from fewbit_tpu.ops import bitpack as jax_bitpack
from fewbit_tpu.ops import pallas_kernels as pk

from fewbit_tpu_torch.functional.activations import resolve_activation
from fewbit_tpu_torch.lut import store
from fewbit_tpu_torch.ops import kernels as K
from fewbit_tpu_torch.ops.activations import apply_lut, compare_codes
from fewbit_tpu_torch.ops.bitpack import pack_codes, unpack_codes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _signs(rng, n):
    return (rng.randint(0, 2, n) * 2 - 1).astype(np.float32)


def _close(got, want, rtol=1e-5, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# LUTs and codes.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [1, 2, 3, 4])
def test_lut_matches_jax_store(bits):
    for (name, b), (borders, levels) in jax_store.items():
        if b != bits:
            continue
        ours = store.get(name, b)
        np.testing.assert_array_equal(ours[0], borders)
        np.testing.assert_array_equal(ours[1], levels)
    ib, il = store.get_interior("gelu", bits)
    jb, jl = jax_store.get_interior("gelu", bits)
    np.testing.assert_array_equal(ib, jb)
    np.testing.assert_array_equal(il, jl)


@pytest.mark.parametrize("bits", [1, 3, 4])
def test_codes_and_lut_select_match_jax(bits):
    rng = np.random.RandomState(bits)
    x = (rng.randn(64, 256) * 3).astype(np.float32)
    spec, b, v = resolve_activation("gelu", bits=bits)
    jspec, jb, jv = jax_resolve("gelu", bits=bits)
    assert spec.bits == jspec.bits and spec.n_borders == jspec.n_borders
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    codes = compare_codes(_t(x), b, ())
    jcodes = jax_act.compare_codes(jnp.asarray(x), jb, ())
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(
        apply_lut(codes, v, bits).numpy(),
        np.asarray(jax_act.apply_lut(jcodes, jv, bits)))
    # Exact GELU forward, as the JAX spec computes it (the two erf
    # implementations differ by about 1e-6 in the negative tail).
    _close(spec.fwd(_t(x), ()), jspec.fwd(jnp.asarray(x), ()), atol=1e-5)


def test_unported_activation_names_its_roadmap_item():
    """ROADMAP queue 1 item 7 is done: silu resolves as in the JAX
    package; what the JAX package refuses (stepwise, which has no builtin
    LUT, and unknown names) raises its ValueError."""
    spec, b, v = resolve_activation("silu", bits=3)
    jspec, jb, jv = jax_resolve("silu", bits=3)
    assert (spec.name, spec.bits, spec.n_borders) == (
        jspec.name, jspec.bits, jspec.n_borders)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    for name in ("stepwise", "nope"):
        with pytest.raises(ValueError, match="unknown activation"):
            resolve_activation(name)


# ---------------------------------------------------------------------------
# Packed-code layout.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,bits", [(512, 1), (1024, 3), (1000, 4),
                                    (96, 6)])
def test_pack_unpack_round_trip(n, bits):
    rng = np.random.RandomState(n + bits)
    codes = rng.randint(0, 1 << bits, size=(n, 48)).astype(np.int32)
    packed = pack_codes(_t(codes), bits)
    assert packed.dtype == torch.int32
    assert tuple(packed.shape) == (bits, -(-n // 32), 48)
    np.testing.assert_array_equal(unpack_codes(packed, bits, n).numpy(),
                                  codes)
    # Bit i of word [b, w, m] is bit b of the code of row 32 w + i.
    words = packed.numpy().view(np.uint32)
    row, col, b = min(37, n - 1), 5, bits - 1
    assert (words[b, row // 32, col] >> (row % 32)) & 1 == \
        (codes[row, col] >> b) & 1


def test_decoded_codes_match_jax_flat_codec():
    rng = np.random.RandomState(3)
    codes = rng.randint(0, 8, size=(640, 32)).astype(np.int32)
    jpacked = jax_bitpack.pack_codes(jnp.asarray(codes.reshape(-1)), 3)
    jdecoded = np.asarray(jax_bitpack.unpack_codes(jpacked, 3, codes.size))
    ours = unpack_codes(pack_codes(_t(codes), 3), 3, 640).numpy()
    np.testing.assert_array_equal(ours.reshape(-1), jdecoded)


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 6, 8])
def test_packed_sizes_match_jax(bits):
    """``packed_num_words`` and ``packed_nbytes`` count a flat code vector
    as JAX's do, and that is one column of the port's layout: the bytes of
    ``(N, M)`` codes are ``M`` times the count of ``N``."""
    from fewbit_tpu_torch.ops.bitpack import (packed_nbytes,
                                              packed_num_words, packed_shape)

    for n in list(range(0, 130)) + [1000, 8191, 8192, 8193, 1 << 20]:
        assert packed_num_words(n, bits) == jax_bitpack.packed_num_words(
            n, bits)
        assert packed_nbytes(n, bits) == jax_bitpack.packed_nbytes(n, bits)
        shape = packed_shape(n, 7, bits)
        assert shape[1] == packed_num_words(n, bits)
        assert 4 * int(np.prod(shape)) == 7 * packed_nbytes(n, bits)
    packed = pack_codes(torch.zeros(1000, 3, dtype=torch.int32), bits)
    assert packed.numel() * 4 == 3 * packed_nbytes(1000, bits)


@pytest.mark.parametrize("bits", [1, 3, 4])
def test_quantize_codes_matches_jax(bits):
    """``quantize_codes`` gives JAX's codes, values lying exactly on a
    border included (strictly above a border counts it)."""
    from fewbit_tpu_torch.ops.activations import quantize_codes

    borders = np.asarray(store.get("gelu", bits)[0], np.float32)
    rng = np.random.RandomState(bits)
    x = np.concatenate([rng.standard_normal(4096).astype(np.float32) * 3,
                        borders, np.nextafter(borders, np.float32(np.inf)),
                        np.nextafter(borders, np.float32(-np.inf)),
                        [-np.inf, np.inf, 0.0]]).astype(np.float32)
    for dt in (torch.float32, torch.bfloat16):
        xt = _t(x).to(dt)
        want = np.asarray(jax_act.quantize_codes(
            jnp.asarray(xt.float().numpy()).astype(
                jnp.float32 if dt == torch.float32 else jnp.bfloat16),
            jnp.asarray(borders)))
        got = quantize_codes(xt, _t(borders))
        assert got.shape == xt.shape
        np.testing.assert_array_equal(got.numpy(), want)
    on = quantize_codes(_t(borders), _t(borders)).numpy()
    np.testing.assert_array_equal(on, np.arange(len(borders)))


# ---------------------------------------------------------------------------
# Plain kernel versions against the Pallas wrappers (interpret mode).
# ---------------------------------------------------------------------------


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("FEWBIT_TPU_NATIVE", "interpret")


@pytest.mark.parametrize("mode", ["forward", "backward"])
def test_matmul_input_sketch_matches_pallas(interpret, mode):
    n, kdim, m, k_eff = 1024, 128, 256, 512
    rng = np.random.RandomState(11)
    x = rng.randn(n, kdim).astype(np.float32)
    w = (rng.randn(kdim, m) * 0.1).astype(np.float32)
    b = (rng.randn(m) * 0.1).astype(np.float32) if mode == "forward" \
        else None
    sigma = _signs(rng, n)
    want_cs = mode == "backward"
    launches = K.fused_matmul_input_sketch.launches
    ref = pk.fused_matmul_input_sketch(
        jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
        jnp.asarray(sigma), k_eff, want_colsum=want_cs)
    # The weight as the port holds it: an (out, in) tensor seen via .t().
    got = K.fused_matmul_input_sketch(
        _t(x), _t(np.ascontiguousarray(w.T)).t(),
        None if b is None else _t(b), _t(sigma), k_eff, want_colsum=want_cs)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == tuple(r.shape)
        _close(g, r)
    # On the CPU the wrapper runs the plain version and launches nothing.
    assert K.fused_matmul_input_sketch.launches == launches


def _ffn_inputs(n, seed):
    kdim, m = 128, 512
    rng = np.random.RandomState(seed)
    x = rng.randn(n, kdim).astype(np.float32)
    w = (rng.randn(kdim, m) * 0.1).astype(np.float32)
    b = (rng.randn(m) * 0.1).astype(np.float32)
    return rng, x, w, b


@pytest.mark.parametrize("n", [512, 1024])
def test_dense_act_sketch_matches_pallas(interpret, n):
    rng, x, w, b = _ffn_inputs(n, n)
    sigma = _signs(rng, n)
    k_eff = 512
    jspec, jb, _ = jax_resolve("gelu", bits=3)
    spec, bd, _ = resolve_activation("gelu", bits=3)
    jy, jpacked, jsk = pk.fused_dense_act_sketch(
        jspec, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jb,
        jnp.asarray(sigma), k_eff, y_dtype=jnp.float32)
    y, packed, sk = K.fused_dense_act_sketch(spec, _t(x), _t(w), _t(b), bd,
                                             _t(sigma), k_eff)
    _close(y, jy)
    _close(sk, jsk)
    # Decoded codes, each layout by its own decoder.
    jcodes = np.asarray(pk.unpack_block_layout(jpacked, 3, (n, 512)))
    np.testing.assert_array_equal(unpack_codes(packed, 3, n).numpy(),
                                  jcodes)


@pytest.mark.parametrize("n,bf16", [
    pytest.param(512, False, id="512"), pytest.param(1024, False, id="1024"),
    pytest.param(512, True, id="bf16-512"),
    pytest.param(1024, True, id="bf16-1024")])
def test_dense_act_sketch_x_matches_pallas(interpret, n, bf16):
    """Kernel 2' (sigma_x): the plain (y, packed, sk_y, sk_x) against the
    Pallas kernel's _kernel_skx mode, as tests/test_ffn.py calls it; and on
    bf16 operands, where y and both sketches are stored in bf16.  The
    Pallas kernel adds its bf16 sketch blocks in bf16, the plain version in
    f32 rounded once: they differ by at most a bf16 rounding step of the
    result (2^-8 to 2^-7 relative), as y may where the f32 products of the
    two sides round to neighbouring bf16 values."""
    rng, x, w, b = _ffn_inputs(n, 200 + n)
    sigma, sigma_x = _signs(rng, n), _signs(rng, n)
    k_eff = 512
    jdt, dt = ((jnp.bfloat16, torch.bfloat16) if bf16 else
               (jnp.float32, torch.float32))
    jspec, jb, _ = jax_resolve("gelu", bits=3)
    spec, bd, _ = resolve_activation("gelu", bits=3)
    ref = pk.fused_dense_act_sketch(
        jspec, jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(b, jdt),
        jb, jnp.asarray(sigma), k_eff, y_dtype=jdt,
        sigma_x=jnp.asarray(sigma_x))
    launches = K.launch_counts()
    tx, tw, tb = (_t(a).to(dt) for a in (x, w, b))
    got = K.fused_dense_act_sketch(spec, tx, tw, tb, bd, _t(sigma), k_eff,
                                   sigma_x=_t(sigma_x))
    assert len(got) == len(ref) == 4
    y, packed, sk, skx = got
    jy, jpacked, jsk, jskx = ref
    tol = dict(rtol=2.0 ** -7, atol=2.0 ** -8) if bf16 else {}
    for ours, theirs in ((y, jy), (sk, jsk), (skx, jskx)):
        assert ours.dtype == dt and np.asarray(theirs).dtype == jdt
        _close(ours.float(), np.asarray(theirs, np.float32), **tol)
    assert tuple(skx.shape) == (k_eff, 128)
    np.testing.assert_array_equal(
        unpack_codes(packed, 3, n).numpy(),
        np.asarray(pk.unpack_block_layout(jpacked, 3, (n, 512))))
    # Its own entry among the kernels, the same function.
    again = K.fused_dense_act_sketch_x(spec, tx, tw, tb, bd, _t(sigma),
                                       k_eff, _t(sigma_x))
    for a, c in zip(again, got):
        assert torch.equal(a, c)
    assert K.launch_counts() == launches


@pytest.mark.parametrize("n", [512, 1024])
def test_matmul_lut_backward_matches_pallas(interpret, n):
    rng, x, w, b = _ffn_inputs(n, 100 + n)
    sigma = _signs(rng, n)
    g = rng.randn(n, 128).astype(np.float32)
    wt = (rng.randn(128, 512) * 0.1).astype(np.float32)
    k_eff = 512
    jspec, jb, jv = jax_resolve("gelu", bits=3)
    spec, bd, lv = resolve_activation("gelu", bits=3)
    # The same codes in each package's own layout.
    _, jpacked, _ = pk.fused_dense_act_sketch(
        jspec, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), jb,
        jnp.asarray(sigma), k_eff, y_dtype=jnp.float32)
    _, packed, _ = K.fused_dense_act_sketch(spec, _t(x), _t(w), _t(b), bd,
                                            _t(sigma), k_eff)
    jdz, jsk, jdb = pk.fused_matmul_lut_backward(
        jspec, jpacked, jv, jnp.asarray(g), jnp.asarray(wt),
        jnp.asarray(sigma), k_eff)
    dz, sk, db = K.fused_matmul_lut_backward(spec, packed, lv, _t(g),
                                             _t(wt), _t(sigma), k_eff)
    _close(dz, jdz)
    _close(sk, jsk)
    _close(db, np.asarray(jdb)[0], atol=1e-3)
    assert db.dtype == torch.float32


def test_envelope_helpers_match_jax():
    for n in (512, 1024, 1536, 8192, 8200):
        for k in (100, 256, 400, 1638, 3000):
            assert K.countsketch_aligned_keff(n, k) == \
                pk.countsketch_aligned_keff(n, k)
            for kdim, m in ((768, 768), (768, 3072), (128, 256)):
                for dt, jdt in ((torch.float32, jnp.float32),
                                (torch.bfloat16, jnp.bfloat16)):
                    assert K.matmul_sketch_keff(n, kdim, m, k, dt) == \
                        pk.matmul_sketch_keff(n, kdim, m, k, jdt)
    assert K.sketch_dtype(torch.bfloat16) == torch.bfloat16
    assert K.sketch_dtype(torch.float32) == torch.float32
    # The main path's shapes: N = 64 x 128, ratio 0.2.
    assert K.matmul_sketch_keff(8192, 768, 768, 1638, torch.float32) == 2048
    assert K.countsketch_aligned_keff(8192, 1638) == 2048


# ---------------------------------------------------------------------------
# The package stands without JAX.
# ---------------------------------------------------------------------------


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'fewbit_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import fewbit_tpu_torch, fewbit_tpu_torch.functional, "
        "fewbit_tpu_torch.modules, fewbit_tpu_torch.models, "
        "fewbit_tpu_torch.train, fewbit_tpu_torch.ops.kernels, "
        "fewbit_tpu_torch.ops._build\n"
        "from fewbit_tpu_torch.lut import store\n"
        "assert store.get('gelu', 3)[1].shape == (8,)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'fewbit_tpu') and sys.modules[m]]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
