"""Port parity for the functional and module layers: ``linear_grp_native``
and ``fewbit_ffn`` forward and backward against the JAX package with the
same inputs and the same sign vectors, the residuals they keep, the sketch
RNG plumbing and the learning-rate schedule.

The signs are drawn with ``jax.random.bernoulli`` from the JAX key, exactly
as ``_cs_signs`` and ``_signs`` draw them, and handed to the port.  Inside
the kernel envelope JAX runs its Pallas kernels in interpret mode (f32).
Tolerances: f32 on both sides, other summation orders (rtol 1e-4); sketched
weight gradients contract two bucket sums, so their atol scales with them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fewbit_tpu.functional as JF
from fewbit_tpu.functional.ffn import _signs as jax_ffn_signs
from fewbit_tpu.functional.linear import _cs_signs
from fewbit_tpu.train import TrainConfig as JaxTrainConfig
from fewbit_tpu.train import make_schedule as jax_make_schedule

from fewbit_tpu_torch.functional import fewbit_ffn, linear_grp_native
from fewbit_tpu_torch.functional.linear import MATMUL_KINDS
from fewbit_tpu_torch.modules import FewBitFFN, RandomizedDense
from fewbit_tpu_torch.train import (TrainConfig, make_optimizer,
                                    make_schedule)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _close(got, want, rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _jax_vjp(fn, args, g):
    y, vjp = jax.vjp(fn, *args)
    return (y, *vjp(g))


# ---------------------------------------------------------------------------
# Sketched linear.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["kernel_envelope", "plain_head"])
def test_linear_grp_matches_jax(monkeypatch, case):
    if case == "kernel_envelope":
        # N = 1024 rows, proj_dim 400 -> k_eff 512: kernel 1 both ways.
        monkeypatch.setenv("FEWBIT_TPU_NATIVE", "interpret")
        shape, kdim, m, kw = (1024,), 128, 256, dict(proj_dim=400)
    else:
        # A head-like call: 64 rows, outside the envelope, plain sketch.
        shape, kdim, m, kw = (4, 16), 128, 64, dict(proj_dim_ratio=0.2)
    rng = np.random.RandomState(5)
    x = rng.randn(*shape, kdim).astype(np.float32)
    kernel = (rng.randn(kdim, m) * 0.1).astype(np.float32)
    b = (rng.randn(m) * 0.1).astype(np.float32)
    g = rng.randn(*shape, m).astype(np.float32)
    key = jax.random.key(7)
    n = int(np.prod(shape))
    sigma = np.asarray(_cs_signs(key, n, jnp.float32))

    ref = _jax_vjp(lambda xx, kk, bb: JF.linear_grp_native(
        xx, kk, bb, key, matmul="countsketch", **kw),
        (jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(b)),
        jnp.asarray(g))

    tx, tb = _t(x, True), _t(b, True)
    weight = _t(np.ascontiguousarray(kernel.T), True)  # torch (out, in)
    y = linear_grp_native(tx, weight.t(), tb, _t(sigma),
                          matmul="countsketch", **kw)
    y.backward(_t(g))
    _close(y, ref[0])
    _close(tx.grad, ref[1])
    _close(weight.grad.t(), ref[2], atol=1e-3 * np.abs(ref[2]).max())
    _close(tb.grad, ref[3], atol=1e-3)


def test_linear_grp_unported_kinds_raise():
    """No kind is left unported: every kind of MATMUL_KINDS runs forward
    and backward (the forward exact, within f32 rounding), and an unknown
    kind still raises ValueError."""
    x = torch.randn(8, 16, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    w = torch.randn(4, 16, generator=torch.Generator().manual_seed(1))
    for kind in MATMUL_KINDS:
        kernel = w.t().clone().requires_grad_()
        y = linear_grp_native(x, kernel, None,
                              torch.Generator().manual_seed(2), proj_dim=4,
                              matmul=kind)
        y.sum().backward()
        _close(y, (x @ w.t()).detach().numpy(), atol=1e-5)
        assert kernel.grad.shape == (16, 4)
        assert torch.isfinite(kernel.grad).all(), kind
    with pytest.raises(ValueError):
        linear_grp_native(x, torch.zeros(16, 4), None, torch.ones(8),
                          proj_dim=4, matmul="nope")


# ---------------------------------------------------------------------------
# Fused FFN block.
# ---------------------------------------------------------------------------


def _ffn_data(n, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 128).astype(np.float32)
    wu = (rng.randn(128, 512) * 0.05).astype(np.float32)
    bu = (rng.randn(512) * 0.05).astype(np.float32)
    wd = (rng.randn(512, 128) * 0.05).astype(np.float32)
    bd = (rng.randn(128) * 0.05).astype(np.float32)
    g = rng.randn(n, 128).astype(np.float32)
    return x, wu, bu, wd, bd, g


@pytest.mark.parametrize("n", [512, 1024])
def test_fewbit_ffn_matches_jax(monkeypatch, n):
    """N = 1024 at ratio 0.25 runs kernels 2 and 3 (k_eff 512); N = 512
    asks for 128 buckets, which no kernel-aligned count honours, so both
    packages take the plain path."""
    monkeypatch.setenv("FEWBIT_TPU_NATIVE", "interpret")
    x, wu, bu, wd, bd, g = _ffn_data(n)
    key = jax.random.key(11)
    sig_up = np.asarray(jax_ffn_signs(jax.random.fold_in(key, 0), n))
    sig_down = np.asarray(jax_ffn_signs(jax.random.fold_in(key, 1), n))
    ref = _jax_vjp(lambda *a: JF.fewbit_ffn(*a, key, bits=3,
                                            proj_dim_ratio=0.25),
                   tuple(map(jnp.asarray, (x, wu, bu, wd, bd))),
                   jnp.asarray(g))

    tx, tbu, tbd = _t(x, True), _t(bu, True), _t(bd, True)
    up = _t(np.ascontiguousarray(wu.T), True)      # torch (out, in)
    down = _t(np.ascontiguousarray(wd.T), True)
    y = fewbit_ffn(tx, up.t(), tbu, down.t(), tbd, _t(sig_up),
                   _t(sig_down), bits=3, proj_dim_ratio=0.25)
    y.backward(_t(g))
    names = ["y", "dx", "dwu", "dbu", "dwd", "dbd"]
    got = [y, tx.grad, up.grad.t(), tbu.grad, down.grad.t(), tbd.grad]
    for name, a, r in zip(names, got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(a.detach().numpy(), r, rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.abs(r).max()),
                                   err_msg=name)


def test_fewbit_ffn_leading_dims():
    x, wu, bu, wd, bd, g = _ffn_data(1024)
    sig = torch.ones(1024)
    args = (_t(wu), _t(bu), _t(wd), _t(bd), sig, sig)
    y2 = fewbit_ffn(_t(x), *args, bits=3, proj_dim_ratio=0.25)
    y3 = fewbit_ffn(_t(x).reshape(8, 128, 128), *args, bits=3,
                    proj_dim_ratio=0.25)
    assert y3.shape == (8, 128, 128)
    _close(y3.reshape(1024, 128), y2.detach().numpy(), atol=1e-6)


def _saved_shapes(fn):
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, shapes


@pytest.mark.parametrize("n", [1024, 2048])
def test_residuals_hold_no_full_tensor(n):
    """Mirrors tests/test_ffn.py:110-123: the backward of the FFN block and
    of the sketched linear keeps no (N, K) or (N, M) tensor."""
    x, wu, bu, wd, bd, g = _ffn_data(n)
    tx = _t(x, True)
    sig = torch.ones(n)
    _, shapes = _saved_shapes(lambda: fewbit_ffn(
        tx, _t(wu, True), _t(bu, True), _t(wd, True), _t(bd, True), sig,
        sig, bits=3, proj_dim_ratio=0.25))
    assert shapes
    for s in shapes:
        # Only the (N,) sign vectors span the rows; the packed codes are
        # (bits, N / 32, M), the sketches (k_eff, d).
        assert s[0] != n or len(s) == 1, shapes
    assert (3, n // 32, 512) in shapes
    _, shapes = _saved_shapes(lambda: linear_grp_native(
        tx, _t(wu, True), _t(bu, True), sig, proj_dim_ratio=0.25,
        matmul="countsketch"))
    for s in shapes:
        assert s[0] != n or len(s) == 1, shapes


# ---------------------------------------------------------------------------
# Modules and the sketch generator.
# ---------------------------------------------------------------------------


def test_modules_draw_signs_from_the_generator():
    torch.manual_seed(0)
    lin = RandomizedDense(128, 64, proj_dim_ratio=0.25, matmul="countsketch",
                          generator=torch.Generator().manual_seed(0))
    x = torch.randn(4, 256, 128)

    def grad(seed):
        lin.zero_grad()
        lin(x, torch.Generator().manual_seed(seed)).sum().backward()
        return lin.weight.grad.clone()

    np.testing.assert_array_equal(grad(1).numpy(), grad(1).numpy())
    assert not torch.equal(grad(1), grad(2))
    ffn = FewBitFFN(128, 512, 128, bits=3, proj_dim_ratio=0.25,
                    generator=torch.Generator().manual_seed(0))
    ffn(x, torch.Generator().manual_seed(3)).sum().backward()
    for p in ffn.parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all()


def test_constant_seed_fallback_warns_or_raises(monkeypatch):
    lin = RandomizedDense(16, 8, proj_dim=4)
    x = torch.randn(32, 16)
    with pytest.warns(UserWarning, match="falling back to a constant key"):
        lin(x)
    monkeypatch.setenv("FEWBIT_TPU_STRICT_SKETCH", "1")
    with pytest.raises(RuntimeError, match="constant key"):
        lin(x)


# ---------------------------------------------------------------------------
# Schedule and optimizer.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("total", [10, 100])
def test_schedule_matches_optax(total):
    cfg = TrainConfig(total_steps=total, learning_rate=2e-5)
    ours = make_schedule(cfg)
    ref = jax_make_schedule(JaxTrainConfig(total_steps=total,
                                           learning_rate=2e-5))
    for count in range(total + 3):
        # optax evaluates in f32.
        assert abs(ours(count) - float(ref(count))) <= 1e-6 * 2e-5
    assert ours(0) == 0.0
    opt, sched = make_optimizer(cfg, [torch.nn.Parameter(torch.zeros(3))])
    assert opt.param_groups[0]["lr"] == 0.0
    assert opt.param_groups[0]["betas"] == (0.9, 0.98)
    assert opt.param_groups[0]["eps"] == 1e-6
    assert opt.param_groups[0]["weight_decay"] == 0.1
