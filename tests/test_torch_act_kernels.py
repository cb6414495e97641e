"""The plain versions of kernels 4, 5, 6, 2 and 3 for every code kind,
against the JAX package's Pallas kernels run in interpret mode on the same
numpy inputs: kernels 4 and 5 directly, one case per code kind (border
codes, each piecewise predicate, each stepwise parity); kernel 6 directly,
and kernels 2 and 3 through ``fewbit_ffn``, for ``relu`` (a 1-bit
predicate) and ``silu`` (3-bit border codes).

Tolerances: codes and dx exactly (the same compares of the same values, one
f32 product each).  y as ``test_torch_act_surface.py`` holds it in f32
(atol and rtol 1e-5: the libm forms against ``jax.nn``'s and the Pallas
kernel-safe forms); in bf16 the f32 tolerance plus one bf16 ulp against
the Pallas forward of the same values in f32 with the arguments rounded to
bf16, rounded once (the port rounds once; Pallas's bf16 forward rounds
after each op).  kernels 2 and 3 as ``tests/test_torch_functional.py``
holds ``fewbit_ffn`` (rtol 1e-4, atol 1e-4 of the largest entry).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fewbit_tpu.functional as JF
from fewbit_tpu.functional import activations as jax_acts
from fewbit_tpu.functional.ffn import _signs as jax_ffn_signs
from fewbit_tpu.ops import pallas_kernels as pk

import fewbit_tpu_torch.functional as F
from fewbit_tpu_torch.functional.activations import stepwise_triple
from fewbit_tpu_torch.ops import kernels as K
from fewbit_tpu_torch.ops.activations import spec_args
from fewbit_tpu_torch.ops.bitpack import unpack_codes

NAMES = jax_acts.CONTINUOUS + ("hardshrink", "hardsigmoid", "hardtanh",
                               "leaky_relu", "relu", "relu6", "softshrink",
                               "threshold")
# One case per code kind: (name, kwargs of resolve_activation or of
# stepwise).  Predicates with arguments that bf16 cannot hold.
CASES = {
    "borders-gelu3": ("gelu", dict(bits=3)),
    "pred-relu": ("relu", {}),
    "pred-leaky_relu": ("leaky_relu", dict(args=(0.1,))),
    "pred-relu6": ("relu6", {}),
    "pred-hardtanh": ("hardtanh", dict(args=(-0.7, 0.3))),
    "pred-hardsigmoid": ("hardsigmoid", {}),
    "pred-hardshrink": ("hardshrink", dict(args=(0.3,))),
    "pred-softshrink": ("softshrink", dict(args=(0.3,))),
    "pred-threshold": ("threshold", dict(args=(0.3, -0.2))),
    "step-none": ("stepwise", dict(borders=[-1.0, 0.0, 0.7, 1.4],
                                   levels=[0.1, 0.3, 0.5, 0.7, 0.9],
                                   parity=None, shift=(0.1, 0.5))),
    "step-even": ("stepwise", dict(borders=[0.4, 0.8, 1.6],
                                   levels=[1.0, 0.6, 0.3, 0.1],
                                   parity=False, shift=(-0.2, 0.0))),
    "step-odd": ("stepwise", dict(borders=[0.3, 0.9, 1.6, 2.4],
                                  levels=[1.0, 0.8, 0.5, 0.2, 0.05],
                                  parity=True, shift=(0.1, 0.25))),
}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("FEWBIT_TPU_NATIVE", "interpret")


def _triples(monkeypatch, name, kw):
    """The JAX package's and the port's (spec, borders, levels)."""
    if name != "stepwise":
        return (jax_acts.resolve_activation(name, **kw),
                F.resolve_activation(name, **kw))
    seen = {}

    def record(spec, x, b, v):
        seen["jax"] = (spec, b, v)
        return x

    monkeypatch.setattr(jax_acts, "fewbit_activation", record)
    jax_acts.stepwise(jnp.zeros((1,)), kw["borders"], kw["levels"],
                      kw["parity"], kw["shift"])
    return seen["jax"], stepwise_triple(**kw)


def _inputs(shape, seed, dt):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2.5).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    if dt == "bf16":
        x = np.asarray(torch.from_numpy(x).bfloat16().float())
        g = np.asarray(torch.from_numpy(g).bfloat16().float())
    return x, g


def _close_y(y, want, dt):
    """y against Pallas's y: f32 tolerance, plus one bf16 ulp in bf16."""
    err = np.abs(y - want)
    tol = 1e-5 + 1e-5 * np.abs(want)
    if dt == "bf16":
        mag = np.maximum(np.abs(want), np.abs(y)).astype(np.float32)
        tol = tol + np.maximum(np.spacing(mag) * 2.0 ** 16, 2.0 ** -133)
    assert (err <= tol).all(), float((err / tol).max())


# A predicate in bf16 only, where its arguments are rounded (f32 is held
# against the JAX package in test_torch_act_surface.py); the 5- and 6-bit
# codes there too, against JAX's plain path: their select trees are the
# slowest to interpret (the custom 32-level LUT of GELU is held against
# Pallas in test_torch_activations.py).
KINDS_CASES = [(case, dt) for case in CASES for dt in ("f32", "bf16")
               if dt == "bf16" or not case.startswith("pred")]


@pytest.mark.parametrize("case,dt", KINDS_CASES,
                         ids=[f"{c}-{d}" for c, d in KINDS_CASES])
def test_plain_kernels_4_5_match_pallas(interpret, monkeypatch, case, dt):
    name, kw = CASES[case]
    (jspec, jb, jv), (spec, b, v) = _triples(monkeypatch, name, kw)
    assert (spec.bits, spec.n_borders) == (jspec.bits, jspec.n_borders)
    shape = (200, 128)  # a ragged last word row
    x, g = _inputs(shape, len(case), dt)
    jdt, tdt = ((jnp.float32, torch.float32) if dt == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jy, jpacked = pk.fused_forward(jspec, jnp.asarray(x).astype(jdt), jb)
    y, packed = K.fused_forward(spec, torch.from_numpy(x).to(tdt), b)
    np.testing.assert_array_equal(
        unpack_codes(packed, spec.bits, shape[0]).numpy(),
        np.asarray(pk.unpack_block_layout(jpacked, jspec.bits, shape)))
    if dt == "bf16":
        # Pallas's forward of the same values in f32, arguments as bf16
        # holds them, rounded once.
        f32_spec = dataclasses.replace(
            jspec, args=jspec.args if name == "stepwise"
            else spec_args(spec, torch.bfloat16))
        jy = pk.fused_forward(f32_spec, jnp.asarray(x), jb)[0].astype(
            jnp.bfloat16)
    _close_y(y.float().numpy(), np.asarray(jy.astype(jnp.float32)), dt)
    jdx = pk.fused_backward(jspec, jpacked, jv, jnp.asarray(g).astype(jdt))
    dx = K.fused_backward(spec, packed, v, torch.from_numpy(g).to(tdt))
    np.testing.assert_array_equal(dx.float().numpy(),
                                  np.asarray(jdx.astype(jnp.float32)))


def _dense_inputs(n, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 128).astype(np.float32)
    w = (rng.randn(128, 256) * 0.1).astype(np.float32)
    b = (rng.randn(256) * 0.1).astype(np.float32)
    g = rng.randn(n, 256).astype(np.float32)
    return x, w, b, g


@pytest.mark.parametrize("name", ["relu", "silu"])
def test_plain_kernel_6_matches_pallas(interpret, name):
    n = 512
    x, w, b, g = _dense_inputs(n, 7)
    jspec, jb, jv = jax_acts.resolve_activation(name)
    spec, bd, lv = F.resolve_activation(name)
    jy, jpacked = pk.fused_dense_act(jspec, jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), jb)
    y, packed = K.fused_dense_act(
        spec, torch.from_numpy(x),
        torch.from_numpy(np.ascontiguousarray(w.T)).t(), torch.from_numpy(b),
        bd)
    _close_y(y.numpy(), np.asarray(jy), "f32")
    np.testing.assert_array_equal(
        unpack_codes(packed, spec.bits, n).numpy(),
        np.asarray(pk.unpack_block_layout(jpacked, jspec.bits, (n, 256))))
    jdz = pk.fused_backward(jspec, jpacked, jv, jnp.asarray(g))
    dz = K.fused_backward(spec, packed, lv, torch.from_numpy(g))
    np.testing.assert_array_equal(dz.numpy(), np.asarray(jdz))


def _t(a, grad=False):
    t = torch.from_numpy(np.asarray(a, dtype=np.float32).copy())
    return t.requires_grad_() if grad else t


@pytest.mark.parametrize("name", ["relu", "silu"])
def test_fewbit_ffn_kernels_2_3_match_pallas(interpret, name):
    """N = 1024 at ratio 0.25: both packages take their kernels (k_eff
    512), the JAX package's in interpret mode, the port's plain versions."""
    n = 1024
    rng = np.random.RandomState(1)
    x = rng.randn(n, 128).astype(np.float32)
    wu = (rng.randn(128, 512) * 0.05).astype(np.float32)
    bu = (rng.randn(512) * 0.05).astype(np.float32)
    wd = (rng.randn(512, 128) * 0.05).astype(np.float32)
    bd = (rng.randn(128) * 0.05).astype(np.float32)
    g = rng.randn(n, 128).astype(np.float32)
    key = jax.random.key(11)
    sig_up = np.asarray(jax_ffn_signs(jax.random.fold_in(key, 0), n))
    sig_down = np.asarray(jax_ffn_signs(jax.random.fold_in(key, 1), n))
    prim = tuple(map(jnp.asarray, (x, wu, bu, wd, bd)))
    ref, vjp = jax.vjp(lambda *a: JF.fewbit_ffn(
        *a, key, activation=name, bits=3, proj_dim_ratio=0.25), *prim)
    ref = (ref, *vjp(jnp.asarray(g)))

    tx, tbu, tbd = _t(x, True), _t(bu, True), _t(bd, True)
    up = _t(np.ascontiguousarray(wu.T), True)
    down = _t(np.ascontiguousarray(wd.T), True)
    y = F.fewbit_ffn(tx, up.t(), tbu, down.t(), tbd, _t(sig_up),
                     _t(sig_down), activation=name, bits=3,
                     proj_dim_ratio=0.25)
    y.backward(_t(g))
    got = [y, tx.grad, up.grad.t(), tbu.grad, down.grad.t(), tbd.grad]
    for what, a, r in zip(["y", "dx", "dwu", "dbu", "dwd", "dbd"], got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(a.detach().numpy(), r, rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.abs(r).max()),
                                   err_msg=f"{name} {what}")
