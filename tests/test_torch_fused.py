"""Port parity for the fused dense + few-bit activation: ``fewbit_dense_act``
and ``FusedDenseActivation`` of ``fewbit_tpu_torch`` against the JAX
package's ``fewbit_dense_act``, exact and countsketched, and the plain
version of kernel 6 against the JAX package's Pallas kernel (interpret
mode, which keeps f32).

The sketch signs are the JAX package's own draw,
``jax.random.bernoulli(key, 0.5, (n,))``, handed to the port as ``sigma``,
so the sketched weight gradient must match too.

Tolerances: both sides compute in f32 with different BLAS summation orders
(rtol 1e-5, atol 1e-4 on values of order 1; 1e-3 on sums over 1024 rows).
The GELU forward differs by at most 1e-5 (two erf implementations, and the
Pallas kernel's polynomial erf).  Codes are compared exactly: at these
sizes z is the same f32 product on both sides.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fewbit_tpu.functional as JF
from fewbit_tpu.functional.activations import \
    resolve_activation as jax_resolve
from fewbit_tpu.ops import pallas_kernels as pk

from fewbit_tpu_torch.functional import fewbit_dense_act, resolve_activation
from fewbit_tpu_torch.modules import FusedDenseActivation
from fewbit_tpu_torch.ops import kernels as K
from fewbit_tpu_torch.ops.bitpack import unpack_codes

KDIM, M = 128, 256


def _inputs(n, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, KDIM).astype(np.float32)
    w = (rng.randn(KDIM, M) * 0.1).astype(np.float32)
    b = (rng.randn(M) * 0.1).astype(np.float32)
    g = rng.randn(n, M).astype(np.float32)
    return x, w, b, g


def _close(got, want, rtol=1e-5, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _port(x, w, b, g, sigma=None, **kw):
    """y and the gradients of the port's op, the weight held as a torch
    (out, in) parameter and passed through ``.t()``."""
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    y = fewbit_dense_act(xt, wt.t(), bt, sigma, bits=3, **kw)
    y.backward(torch.from_numpy(g))
    return y.detach().numpy(), xt.grad.numpy(), wt.grad.numpy().T, \
        bt.grad.numpy()


def _jax(x, w, b, g, key=None, **kw):
    y, vjp = jax.vjp(lambda u, v, c: JF.fewbit_dense_act(u, v, c, key,
                                                         bits=3, **kw),
                     jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    return (np.asarray(y),) + tuple(np.asarray(t)
                                    for t in vjp(jnp.asarray(g)))


@pytest.mark.parametrize("shape", [(1024,), (8, 128)], ids=["2d", "3d"])
def test_exact_matches_jax(shape):
    n = int(np.prod(shape))
    x, w, b, g = _inputs(n, n)
    x, g = x.reshape(*shape, KDIM), g.reshape(*shape, M)
    got, want = _port(x, w, b, g), _jax(x, w, b, g)
    _close(got[0], want[0], rtol=0, atol=1e-5)
    for a, r in zip(got[1:], want[1:]):
        assert a.shape == r.shape
        _close(a, r, atol=1e-3)


@pytest.mark.parametrize("ratio", [0.25, 0.3])
def test_countsketch_matches_jax_under_shared_signs(ratio):
    n = 1024
    x, w, b, g = _inputs(n, 5)
    key = jax.random.key(11)
    sigma = np.asarray(jax.random.bernoulli(key, 0.5, (n,)),
                       np.float32) * 2 - 1
    got = _port(x, w, b, g, torch.from_numpy(sigma), proj_dim_ratio=ratio,
                matmul="countsketch")
    want = _jax(x, w, b, g, key, proj_dim_ratio=ratio, matmul="countsketch")
    _close(got[0], want[0], rtol=0, atol=1e-5)
    for a, r in zip(got[1:], want[1:]):
        _close(a, r, atol=1e-3)
    # The sketch is an estimate: it differs from the exact dW.
    exact = _port(x, w, b, g)[2]
    assert not np.allclose(got[2], exact, atol=1e-2)


def test_arguments_are_checked():
    x = torch.randn(64, KDIM)
    w = torch.randn(KDIM, M)
    with pytest.raises(ValueError, match="sigma"):
        fewbit_dense_act(x, w, None, None, bits=3, proj_dim_ratio=0.25)
    # Every kind is ported: a gaussian sketch takes a generator, not signs.
    with pytest.raises(TypeError, match="Generator"):
        fewbit_dense_act(x, w, None, torch.ones(64), bits=3,
                         proj_dim_ratio=0.25, matmul="gaussian")
    y = fewbit_dense_act(x, w, None, torch.Generator().manual_seed(0),
                         bits=3, proj_dim_ratio=0.25, matmul="gaussian")
    assert y.shape == (64, M)
    with pytest.raises(ValueError, match="unknown matmul"):
        fewbit_dense_act(x, w, None, torch.ones(64), bits=3,
                         proj_dim_ratio=0.25, matmul="nope")


@pytest.mark.parametrize("sketched", [False, True],
                         ids=["exact", "countsketch"])
def test_module_matches_functional(sketched):
    n = 512
    kw = dict(proj_dim_ratio=0.25) if sketched else {}
    mod = FusedDenseActivation(KDIM, M, bits=3,
                               generator=torch.Generator().manual_seed(0),
                               **kw)
    assert mod.weight.shape == (M, KDIM) and mod.bias.shape == (M,)
    x, _, _, g = _inputs(n, 9)
    xt = torch.from_numpy(x)
    y = mod(xt, torch.Generator().manual_seed(3))
    sigma = None
    if sketched:
        bits = torch.randint(0, 2, (n,),
                             generator=torch.Generator().manual_seed(3))
        sigma = bits.float() * 2 - 1
    want = fewbit_dense_act(xt, mod.weight.t(), mod.bias, sigma, bits=3,
                            **kw)
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    y.backward(torch.from_numpy(g))
    assert mod.weight.grad.shape == mod.weight.shape
    if sketched:
        with pytest.warns(UserWarning, match="constant key"):
            mod(xt)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("FEWBIT_TPU_NATIVE", "interpret")


@pytest.mark.parametrize("n", [1000, 512], ids=["ragged", "aligned"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
def test_plain_kernel_6_matches_pallas(interpret, n, bias):
    x, w, b, g = _inputs(n, 40 + n)
    b = b if bias else None
    jspec, jb, jv = jax_resolve("gelu", bits=3)
    spec, bd, lv = resolve_activation("gelu", bits=3)
    launches = K.fused_dense_act.launches
    jy, jpacked = pk.fused_dense_act(
        jspec, jnp.asarray(x), jnp.asarray(w),
        None if b is None else jnp.asarray(b), jb)
    y, packed = K.fused_dense_act(
        spec, torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(
            w.T)).t(), None if b is None else torch.from_numpy(b), bd)
    _close(y, jy, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        unpack_codes(packed, 3, n).numpy(),
        np.asarray(pk.unpack_block_layout(jpacked, 3, (n, M))))
    # Its codes decode with kernel 5 as the Pallas residual with its own.
    jdz = pk.fused_backward(jspec, jpacked, jv, jnp.asarray(g))
    dz = K.fused_backward(spec, packed, lv, torch.from_numpy(g))
    np.testing.assert_array_equal(dz.numpy(), np.asarray(jdz))
    assert K.fused_dense_act.launches == launches


def test_dense_act_envelope():
    spec, _, _ = resolve_activation("gelu", bits=3)
    assert K.dense_act_ok(spec, 768, 3072, torch.float32)
    assert K.dense_act_ok(spec, 768, 3072, torch.bfloat16)
    assert not K.dense_act_ok(spec, 100, 3072, torch.float32)
    assert not K.dense_act_ok(spec, 768, 100, torch.float32)
    assert not K.dense_act_ok(spec, 768, 3072, torch.float16)
