"""Port parity for the elementwise few-bit GELU: ``gelu`` / ``GELU`` of
``fewbit_tpu_torch`` against the JAX package's ``F.gelu(x, bits=b)`` on the
same numpy inputs, and the plain versions of kernels 4 and 5 against the
JAX package's Pallas kernels (interpret mode).

Tolerances: y is the exact erf GELU on both sides, but the two erf
implementations differ by about 1e-6 in the tails, and the Pallas forward
uses a polynomial erf (absolute error below 1.5e-7 in erf): atol 1e-5 on
values of order 1.  Codes are compared exactly (the same f32 compares on
the same f32 inputs), and so is dx (one f32 product per element).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fewbit_tpu.functional as JF
from fewbit_tpu.functional import activations as jax_acts
from fewbit_tpu.functional.activations import \
    resolve_activation as jax_resolve
from fewbit_tpu.ops import activations as jax_act
from fewbit_tpu.ops import bitpack as jax_bitpack
from fewbit_tpu.ops import pallas_kernels as pk

from fewbit_tpu_torch.functional import gelu, resolve_activation
from fewbit_tpu_torch.modules import GELU
from fewbit_tpu_torch.ops import kernels as K
from fewbit_tpu_torch.ops.bitpack import unpack_codes

# A custom 32-level LUT: 5-bit codes, which no builtin LUT has.
LUT32 = dict(borders=np.linspace(-4.0, 4.0, 31).astype(np.float32),
             values=np.linspace(-0.15, 1.15, 32).astype(np.float32))
LUTS = {f"bits{b}": dict(bits=b) for b in (1, 2, 3, 4)}
LUTS["custom32"] = LUT32
SHAPES = {"3d": (8, 128, 256), "ragged": (1000, 128)}


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2.5).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    return x, g


def _jax_codes(packed, bits, shape):
    """Decode the JAX package's residual, whichever layout it is in."""
    if packed.ndim == 3:
        return np.asarray(pk.unpack_block_layout(packed, bits, shape))
    flat = jax_bitpack.unpack_codes(packed, bits, int(np.prod(shape)))
    return np.asarray(flat).reshape(shape)


def _port_codes(y, bits, shape):
    """Decode the codes the port's autograd node saved for its backward."""
    packed = y.grad_fn.saved_tensors[0]
    rows = int(np.prod(shape[:-1]))
    return unpack_codes(packed, bits, rows).numpy().reshape(shape)


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
@pytest.mark.parametrize("lut", list(LUTS.values()), ids=list(LUTS))
def test_gelu_matches_jax(lut, shape):
    x, g = _inputs(shape, sum(shape))
    jspec, jb, jv = jax_resolve("gelu", **lut)
    jy, (jpacked, _) = jax_act._fewbit_fwd(jspec, jnp.asarray(x), jb, jv)
    _, vjp = jax.vjp(lambda u: JF.gelu(u, **lut), jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))

    xt = torch.from_numpy(x).requires_grad_()
    y = gelu(xt, **lut)
    codes = _port_codes(y, jspec.bits, shape)
    y.backward(torch.from_numpy(g))
    assert y.shape == xt.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(codes,
                                  _jax_codes(jpacked, jspec.bits, shape))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jdx))


@pytest.mark.parametrize("lut", [dict(bits=3), LUT32],
                         ids=["bits3", "custom32"])
def test_gelu_module_matches_functional(lut):
    x, g = _inputs((4, 32, 128), 7)
    a = torch.from_numpy(x).requires_grad_()
    b = torch.from_numpy(x).requires_grad_()
    ya, yb = GELU(**lut)(a), gelu(b, **lut)
    torch.testing.assert_close(ya, yb, rtol=0, atol=0)
    ya.backward(torch.from_numpy(g))
    yb.backward(torch.from_numpy(g))
    torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)


def test_gelu_defaults_to_three_bits_and_any_shape():
    x = torch.linspace(-4, 4, 77, requires_grad=True)  # 1-D, ragged
    y = gelu(x)
    assert y.grad_fn.saved_tensors[0].shape[0] == 3
    y.sum().backward()
    _, _, levels = resolve_activation("gelu", bits=3)
    assert set(x.grad.unique().tolist()) <= set(levels.tolist())
    with pytest.raises(ValueError, match="not both"):
        gelu(x, bits=3, **LUT32)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("FEWBIT_TPU_NATIVE", "interpret")


@pytest.mark.parametrize("shape", [(1000, 128), (512, 256)],
                         ids=["ragged", "aligned"])
@pytest.mark.parametrize("lut", [dict(bits=1), dict(bits=3), LUT32],
                         ids=["bits1", "bits3", "custom32"])
def test_plain_kernels_4_5_match_pallas(interpret, lut, shape):
    x, g = _inputs(shape, 3 + shape[0])
    jspec, jb, jv = jax_resolve("gelu", **lut)
    spec, b, v = resolve_activation("gelu", **lut)
    launches = K.fused_forward.launches, K.fused_backward.launches
    jy, jpacked = pk.fused_forward(jspec, jnp.asarray(x), jb)
    y, packed = K.fused_forward(spec, torch.from_numpy(x), b)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        unpack_codes(packed, spec.bits, shape[0]).numpy(),
        np.asarray(pk.unpack_block_layout(jpacked, jspec.bits, shape)))
    jdx = pk.fused_backward(jspec, jpacked, jv, jnp.asarray(g))
    dx = K.fused_backward(spec, packed, v, torch.from_numpy(g))
    np.testing.assert_array_equal(dx.numpy(), np.asarray(jdx))
    # On the CPU the wrappers run the plain versions and launch nothing.
    assert (K.fused_forward.launches, K.fused_backward.launches) == launches


def test_act_envelope_matches_jax_eligible():
    """Kernels 4 and 5 (``act_kernel_ok``) and kernel 6 (``dense_act_ok``)
    take what ``_eligible`` takes, for every activation name with a
    builtin LUT (or its predicate) and a custom 32-level one."""
    names = jax_acts.CONTINUOUS + tuple(
        n for n in jax_acts.STEPWISE if n != "stepwise")
    for name in names:
        luts = ((dict(bits=3), LUT32) if name in jax_acts.CONTINUOUS
                else ({},))
        for lut in luts:
            spec, _, _ = resolve_activation(name, **lut)
            jspec, _, _ = jax_resolve(name, **lut)
            for c in (64, 100, 128, 384, 3072):
                for dt, jdt in ((torch.float32, jnp.float32),
                                (torch.bfloat16, jnp.bfloat16),
                                (torch.float16, jnp.float16)):
                    want = pk._eligible(jspec, (16, c), jnp.dtype(jdt))
                    assert K.act_kernel_ok(spec, c, dt) == want, name
                    assert K.dense_act_ok(spec, 128, c, dt) == want, name


def test_fused_forward_writes_into_out_on_the_cpu():
    """Kernel 4's wrapper takes ``out=`` as kernel 5's does: on the CPU the
    plain version's (y, codes) are copied into the caller's tensors."""
    spec, borders, _ = resolve_activation("gelu", bits=3)
    x = torch.randn(64, 128, generator=torch.Generator().manual_seed(0))
    want = K.act_forward_plain(spec, x, borders)
    out = (torch.full_like(want[0], float("nan")),
           torch.full_like(want[1], -1))
    got = K.fused_forward(spec, x, borders, out=out)
    assert got[0] is out[0] and got[1] is out[1]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
