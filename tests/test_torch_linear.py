"""Port parity for every sketch kind of ``linear_grp``, for ``linear_crs``
and for the fused dense + activation with any kind: the JAX package's own
draws (``fold_in(key, i)``, as its ``_sketch`` derives them) are handed to
the port through its ``Draws`` interface, so the port must compute the same
sketches and gradients.  With the port's own generator, the weight
gradients must be unbiased (Monte Carlo, as ``tests/test_linear.py``), the
backward must redraw exactly the forward's projection, and the residuals
must hold no ``(N, .)`` tensor and no ``(k, N)`` matrix.

Tolerances, as a fraction of the largest value (at least 1): f32 on both
sides with other summation orders, 1e-5 (the fused block's dW 1e-4: its
dz goes through the few-bit LUT first).  bf16 values are rounded at each
product on both sides, in other orders: 2e-2, a few bf16 steps.
"""

import dataclasses
import importlib
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fewbit_tpu.functional as JF
import fewbit_tpu.modules as JM

import fewbit_tpu_torch.functional as F
import fewbit_tpu_torch.modules as M
from fewbit_tpu_torch.functional.linear import (MATMUL_KINDS, Draws,
                                                GeneratorDraws, _GRPConfig,
                                                _sketch)

JL = importlib.import_module("fewbit_tpu.functional.linear")

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _to_torch(a, dtype=None):
    a = np.asarray(a)
    if a.dtype.kind == "V" or str(a.dtype) == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


class JaxDraws(Draws):
    """The JAX package's draws of one projection, keyed as its ``_sketch``
    keys them: draw ``i`` from ``fold_in(key, i)``, None from the key."""

    def __init__(self, key):
        self.key = key

    def _key(self, i):
        return self.key if i is None else jax.random.fold_in(self.key, i)

    def normal(self, i, shape, dtype):
        return _to_torch(jax.random.normal(self._key(i), shape,
                                           dtype=JDT[dtype]))

    def bits(self, i, shape):
        return _to_torch(jax.random.bernoulli(self._key(i), 0.5, shape))

    def rows(self, i, k, high):
        return _to_torch(jax.random.randint(self._key(i), (k,), 0,
                                            high)).long()

    def replay(self):
        return self


def _data(n, d, seed, dtype=torch.float32):
    a = np.random.RandomState(seed).randn(n, d).astype(np.float32)
    return a, torch.from_numpy(a).to(dtype), jnp.asarray(a, JDT[dtype])


def _np32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a).astype(np.float32)


def _close(got, want, tol, what=""):
    got, want = _np32(got), _np32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


# ---------------------------------------------------------------------------
# The sketches themselves.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("normalise", [True, False], ids=["input", "grad"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", MATMUL_KINDS)
@pytest.mark.parametrize("n", [96, 100])
def test_sketch_matches_jax_under_its_draws(n, kind, dtype, normalise):
    """Both sides of every kind; 100 rows pad to 128 in srht."""
    _, mat, jmat = _data(n, 12, seed=n, dtype=dtype)
    key = jax.random.key(3)
    cfg = _GRPConfig(proj_features=24, matmul=kind, has_bias=False)
    want = JL._sketch(JL._GRPConfig(24, kind, False), key, jmat, normalise)
    draws = JaxDraws(key)
    arg = (draws.bits(None, (n,)).float() * 2.0 - 1.0
           if kind == "countsketch" else draws)
    got = _sketch(cfg, arg, mat, normalise)
    assert str(got.dtype).split(".")[-1] == str(want.dtype), (got.dtype,
                                                              want.dtype)
    if got.is_complex():
        _close(got.real, np.real(want), TOL[dtype], "real")
        _close(got.imag, np.imag(want), TOL[dtype], "imag")
    else:
        _close(got, want, TOL[dtype], kind)


@pytest.mark.parametrize("kind", ["gaussian", "rademacher"])
def test_dense_sketch_chunks_match_jax(kind):
    """k = 4096 at N = 8192: four chunks of 2048 rows, each its own draw."""
    assert JL._dense_proj_chunks(8192, 4096) == 2048
    _, mat, jmat = _data(8192, 2, seed=1)
    key = jax.random.key(4)
    want = JL._sketch(JL._GRPConfig(4096, kind, False), key, jmat, True)
    got = _sketch(_GRPConfig(4096, kind, False), JaxDraws(key), mat, True)
    _close(got, want, 1e-5, kind)


# ---------------------------------------------------------------------------
# VJPs against JAX under JAX's draws.
# ---------------------------------------------------------------------------


def _vjp_inputs(dtype, shape=(4, 24), kdim=24, m=20, seed=5):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape, kdim).astype(np.float32)
    w = (rng.randn(m, kdim) * 0.2).astype(np.float32)
    b = (rng.randn(m) * 0.1).astype(np.float32)
    g = rng.randn(*shape, m).astype(np.float32)
    return x, w, b, g


def _jax_vjp(fn, arrays, g, dtype):
    args = [jnp.asarray(a, JDT[dtype]) for a in arrays]
    y, vjp = jax.vjp(fn, *args)
    return [y, *vjp(jnp.asarray(g, JDT[dtype]))]


def _port_vjp(fn, arrays, g, dtype):
    args = [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays]
    y = fn(*args)
    y.backward(torch.from_numpy(g).to(dtype))
    return [y] + [a.grad for a in args]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", MATMUL_KINDS)
def test_linear_grp_vjp_matches_jax(kind, dtype):
    """96 rows, outside kernel 1's envelope on both sides: forward, dx and
    db exact, dW the same estimate."""
    x, w, b, g = _vjp_inputs(dtype)
    key = jax.random.key(7)
    kw = dict(proj_dim=16, matmul=kind)
    want = _jax_vjp(lambda xx, ww, bb: JF.linear_grp(xx, ww, bb, key, **kw),
                    (x, w, b), g, dtype)
    got = _port_vjp(lambda xx, ww, bb: F.linear_grp(xx, ww, bb,
                                                    JaxDraws(key), **kw),
                    (x, w, b), g, dtype)
    tol = TOL[dtype]
    for name, a, r in zip(("y", "dx", "dW", "db"), got, want):
        assert a.dtype == dtype, (name, a.dtype)
        _close(a, r, tol, f"{kind} {name}")
    exact = _port_vjp(lambda xx, ww, bb: F.linear(xx, ww, bb), (x, w, b), g,
                      dtype)
    _close(got[0], exact[0].detach(), tol, "forward vs linear")
    _close(got[1], exact[1], tol, "dx vs exact")


def test_linear_crs_vjp_matches_jax():
    x, w, b, g = _vjp_inputs(torch.float32)
    key = jax.random.key(8)
    want = _jax_vjp(lambda xx, ww, bb: JF.linear_crs(xx, ww, bb, key, 7),
                    (x, w, b), g, torch.float32)
    got = _port_vjp(lambda xx, ww, bb: F.linear_crs(xx, ww, bb,
                                                    JaxDraws(key), 7),
                    (x, w, b), g, torch.float32)
    for name, a, r in zip(("y", "dx", "dW", "db"), got, want):
        _close(a, r, 1e-5, name)
    with pytest.raises(ValueError, match="nopairs"):
        F.linear_crs(torch.from_numpy(x), torch.from_numpy(w), None,
                     torch.Generator(), 0)


@pytest.mark.parametrize("kind", MATMUL_KINDS)
def test_fewbit_dense_act_matches_jax_under_its_draws(kind):
    """The fused dense + 3-bit GELU with each sketch kind: the JAX
    package's plain path (codes from the same f32 z) against the port's."""
    rng = np.random.RandomState(9)
    x = rng.randn(96, 32).astype(np.float32)
    w = (rng.randn(32, 48) * 0.2).astype(np.float32)
    b = (rng.randn(48) * 0.1).astype(np.float32)
    g = rng.randn(96, 48).astype(np.float32)
    key = jax.random.key(10)
    kw = dict(bits=3, proj_dim_ratio=0.25, matmul=kind)
    want = _jax_vjp(lambda xx, ww, bb: JF.fewbit_dense_act(xx, ww, bb, key,
                                                           **kw),
                    (x, w, b), g, torch.float32)
    got = _port_vjp(lambda xx, ww, bb: F.fewbit_dense_act(
        xx, ww, bb, JaxDraws(key), **kw), (x, w, b), g, torch.float32)
    for name, a, r in zip(("y", "dx", "dW", "db"), got, want):
        _close(a, r, 1e-4 if name == "dW" else 1e-5, f"{kind} {name}")


# ---------------------------------------------------------------------------
# The port's own generator: unbiased, replayed, small residuals.
# ---------------------------------------------------------------------------

RNG = np.random.RandomState(17)
X = torch.from_numpy(RNG.randn(128, 64).astype(np.float32))
W = torch.from_numpy((RNG.randn(32, 64) * 0.1).astype(np.float32))
B = torch.from_numpy((RNG.randn(32) * 0.1).astype(np.float32))


def _mc_weight_grad(fn, repeats=4096):
    """The mean over ``repeats`` fresh draws of ``d sum(fn(X, W, B)) / dW``
    (the loss of tests/test_linear.py), and of ``dB``."""
    gen = torch.Generator().manual_seed(0)
    w = W.clone().requires_grad_()
    b = B.clone().requires_grad_()
    gw, gb = torch.zeros_like(W), torch.zeros_like(B)
    for _ in range(repeats):
        dw, db = torch.autograd.grad(fn(X, w, b, gen).sum(), (w, b))
        gw += dw
        gb += db
    return gw / repeats, gb / repeats


@pytest.mark.parametrize("kind", MATMUL_KINDS + ("crs",))
def test_weight_grad_unbiased(kind):
    """As tests/test_linear.py: the mean of 4096 sketched dW within 12% of
    the exact dW (relative 2-norm), db exact."""
    if kind == "crs":
        def fn(x, w, b, gen):
            return F.linear_crs(x, w, b, gen, nopairs=16)
    else:
        def fn(x, w, b, gen):
            return F.linear_grp(x, w, b, gen, proj_dim=16, matmul=kind)
    gw, gb = _mc_weight_grad(fn)
    exact = torch.ones(128, 32).t() @ X
    rel = float(torch.linalg.norm(gw - exact) / torch.linalg.norm(exact))
    assert rel < 0.12, f"{kind}: rel err {rel:.3f}"
    np.testing.assert_allclose(gb.numpy(), np.full(32, 128.0), rtol=1e-5)


@pytest.mark.parametrize("kind", [k for k in MATMUL_KINDS
                                  if k != "countsketch"])
def test_backward_replays_each_layers_draws(kind):
    """Two sketched layers draw from ONE shared generator, as a model's
    projections do.  Each layer's dW must be the estimate from exactly its
    forward's projection: drawn again here, in the forward's order, from a
    generator in the state the shared one had."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(3, 40, 16).astype(np.float32))
    cot = torch.from_numpy(rng.randn(3, 40, 8).astype(np.float32))
    l1 = M.RandomizedDense(16, 12, proj_dim=10, matmul=kind,
                           generator=torch.Generator().manual_seed(0))
    l2 = M.RandomizedDense(12, 8, proj_dim=10, matmul=kind,
                           generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(5)
    h = l1(x, gen)
    (l2(h, gen) * cot).sum().backward()
    assert not torch.equal(gen.get_state(),
                           torch.Generator().manual_seed(5).get_state())

    ref = torch.Generator().manual_seed(5)
    cfg = _GRPConfig(proj_features=10, matmul=kind, has_bias=True)
    x2, h2 = x.reshape(120, 16), h.detach().reshape(120, 12)
    d1 = GeneratorDraws(ref)
    sk1 = _sketch(cfg, d1, x2, normalise=True)
    d2 = GeneratorDraws(ref)
    sk2 = _sketch(cfg, d2, h2, normalise=True)
    g2 = cot.reshape(120, 8)
    g1 = g2 @ l2.weight.detach()
    for layer, sk, d, g in ((l1, sk1, d1, g1), (l2, sk2, d2, g2)):
        gp = _sketch(cfg, d.replay(), g, normalise=False)
        want = (sk.t() @ gp)
        want = (want.real if want.is_complex() else want).t()
        np.testing.assert_allclose(layer.weight.grad.numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5)
        exact = g.t() @ (x2 if layer is l1 else h2)
        assert not np.allclose(layer.weight.grad.numpy(), exact.numpy(),
                               atol=1e-2)


def _saved(fn):
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return saved


@pytest.mark.parametrize("kind", MATMUL_KINDS)
def test_residual_holds_no_row_tensor(kind):
    """N = 4096 rows of 64 features, k = 32: the backward keeps the (32,
    64) sketch and the weight (a countsketch also its (N,) signs), never x,
    never an (N, .) or (k, N) tensor; dft's sketch is complex64."""
    n = 4096
    x = torch.zeros(n, 64, requires_grad=True)
    w = W.clone().requires_grad_()
    saved = _saved(lambda: F.linear_grp(x, w, None,
                                        torch.Generator().manual_seed(0),
                                        proj_dim=32, matmul=kind))
    shapes = [tuple(t.shape) for t in saved]
    assert shapes, kind
    for s in shapes:
        assert (s[0] != n or len(s) == 1) and n not in s[1:], shapes
    sketch = max(saved, key=lambda t: t.numel() * t.element_size())
    nbytes = sum(t.numel() * t.element_size() for t in saved)
    k_eff = 32 if kind != "countsketch" else sketch.shape[0]
    assert nbytes <= (k_eff * 64 * (8 if kind == "dft" else 4)
                      + W.numel() * 4 + n * 4), (kind, nbytes)
    if kind == "dft":
        assert sketch.dtype == torch.complex64


def test_crs_residual_keeps_sampled_columns_only():
    """CRS keeps the nopairs sampled columns (N, nopairs), their indices
    and the weight: never the (N, in) input."""
    x = torch.zeros(4096, 64, requires_grad=True)
    saved = _saved(lambda: F.linear_crs(x, W, None,
                                        torch.Generator().manual_seed(0), 8))
    shapes = sorted(tuple(t.shape) for t in saved)
    assert shapes == [(8,), (32, 64), (4096, 8)], shapes


# ---------------------------------------------------------------------------
# Modules and defaults.
# ---------------------------------------------------------------------------


def _torch_defaults(fn):
    return {k: p.default for k, p in inspect.signature(fn).parameters.items()
            if p.default is not inspect.Parameter.empty}


def _flax_defaults(cls):
    return {f.name: f.default for f in dataclasses.fields(cls)
            if f.default is not dataclasses.MISSING}


def test_defaults_equal_jax():
    """matmul and the proj_dim* settings default as in the JAX package:
    gaussian for the linear layers, countsketch for the fused block."""
    pairs = [(F.linear_grp_native, _torch_defaults(JF.linear_grp_native)),
             (F.linear_grp, _torch_defaults(JF.linear_grp)),
             (F.fewbit_dense_act, _torch_defaults(JF.fewbit_dense_act)),
             (M.RandomizedDense, _flax_defaults(JM.RandomizedDense)),
             (M.DenseCRS, _flax_defaults(JM.DenseCRS)),
             (M.FusedDenseActivation, _flax_defaults(JM.FusedDenseActivation))]
    for fn, want in pairs:
        got = _torch_defaults(fn)
        shared = [k for k in want if k in got and k != "dtype"]
        assert "matmul" in shared or "nopairs" in shared, fn
        for k in shared:
            assert got[k] == want[k], (fn, k, got[k], want[k])
    assert _torch_defaults(M.RandomizedDense)["matmul"] == "gaussian"
    assert _torch_defaults(M.FusedDenseActivation)["matmul"] == "countsketch"


def test_aliases_and_crs_module():
    assert M.LinearGRP is M.RandomizedDense
    assert M.RandomizedLinear is M.RandomizedDense
    assert M.LinearCRS is M.DenseCRS
    assert F.linear_randomized is F.linear_grp
    mod = M.DenseCRS(64, 32, generator=torch.Generator().manual_seed(0))
    x = X.clone().requires_grad_()
    saved = _saved(lambda: mod(x, torch.Generator().manual_seed(1)))
    # nopairs defaults to max(out // 2, 1) = 16 sampled columns.
    assert (128, 16) in [tuple(t.shape) for t in saved]
    y = mod(x, torch.Generator().manual_seed(1))
    np.testing.assert_allclose(y.detach().numpy(),
                               F.linear(X, mod.weight, mod.bias)
                               .detach().numpy(), atol=1e-6)
