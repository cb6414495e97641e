"""Port parity for the whole few-bit activation surface: every function of
``fewbit_tpu_torch.functional.activations`` against the JAX package's on
the same numpy inputs (JAX eager, its plain path), at every builtin width
of ``fewbit_tpu/data/builtin.npz`` for the 13 continuous functions, with
the default and one other argument set for the 8 piecewise ones, a
custom 32-level LUT, and the generic ``stepwise`` (up to 6-bit codes); in
f32 and bf16.  Also every module against its functional form, the
surface's names and defaults against JAX's, the envelopes of every name
against the JAX package's (``_eligible``, ``_pallas_ok``), and the bf16
``stepwise`` difference between the JAX package's two paths.

What is compared, and why:

* decoded codes and dx exactly: the same compares of the same values (a
  bf16 input against its arguments rounded to bf16, as JAX's weakly typed
  Python scalars are), and one f32 product per element;
* y in f32 within atol 1e-5 and rtol 1e-5: the port evaluates the libm
  forms (``erf``, ``expm1``, ``log1p``, ``tanh``, softplus in its stable
  form), which differ from ``jax.nn``'s by a few f32 ulps;
* y in bf16 within the f32 tolerance plus one bf16 ulp of JAX's forward
  of the same (bf16) values evaluated in f32 and rounded once: the f32
  forms differ as above, and where their results straddle a bf16 rounding
  boundary the two stored values are one ulp apart.  (The f32 term is
  needed where 1 + erf and x - tanh x cancel: there both f32 results hold
  few good bits, and a tail value of order 1e-9 may differ by hundreds of
  its own bf16 ulps.)  The port rounds once, as the kernels do; JAX's bf16
  path rounds after every op, which moved y by up to 38 bf16 ulps for
  gelu and 254 for tanhshrink on inputs like these (against the same f32
  evaluation rounded once), so it is not the reference for y (ROADMAP,
  deliberate differences).

Stepwise with a shift recentres in f32 in the port, as the Pallas kernel
does; JAX's plain path recentres in x's type.  They agree in f32, held
here; bf16 is held against Pallas in ``test_torch_act_kernels.py``, with
the difference between the two JAX paths shown there.
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fewbit_tpu.functional as JF
import fewbit_tpu.modules as JM
from fewbit_tpu.functional import activations as jax_acts
from fewbit_tpu.functional import ffn as jax_ffn
from fewbit_tpu.modules import activations as jax_mods
from fewbit_tpu.ops import activations as jax_act
from fewbit_tpu.ops import bitpack as jax_bitpack
from fewbit_tpu.ops import pallas_kernels as pk

import fewbit_tpu_torch.functional as F
import fewbit_tpu_torch.modules as M
from fewbit_tpu_torch.functional import activations as acts
from fewbit_tpu_torch.functional import ffn as port_ffn
from fewbit_tpu_torch.ops import kernels as K
from fewbit_tpu_torch.ops.activations import spec_args
from fewbit_tpu_torch.ops.bitpack import unpack_codes

SHAPE = (64, 128)
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
CONT = [n for n in acts.CONTINUOUS]
# name -> a non-default argument set; for bf16, λ = 0.3 and friends are not
# bf16 numbers, so the compare must round them first.
PIECEWISE = {"hardshrink": (0.3,), "hardsigmoid": (), "hardtanh": (-0.7, 0.3),
             "leaky_relu": (0.1,), "relu": (), "relu6": (),
             "softshrink": (0.3,), "threshold": (0.3, -0.2)}
PIECEWISE_DEFAULT = {"threshold": (0.0, 0.0)}  # JAX's functional has none
STEPWISE_LUTS = {
    "pow2": ([-1.5, -0.5, 0.5], [0.1, 0.4, 0.7, 1.0]),
    "five": ([0.3, 0.9, 1.6, 2.4], [1.0, 0.8, 0.5, 0.2, 0.05]),
    # 5-bit codes, 6 with parity True.
    "lut32": (np.linspace(0.1, 3.1, 31), np.linspace(1.0, 0.0, 32)),
}
# A custom 32-level LUT: 5-bit codes, which no builtin LUT has.
LUT32 = dict(borders=np.linspace(-4.0, 4.0, 31).astype(np.float32),
             values=np.linspace(-0.1, 1.1, 32).astype(np.float32))


def _inputs(seed):
    rng = np.random.RandomState(seed)
    # Wide enough for every border of every builtin LUT.
    x = (rng.randn(*SHAPE) * 3.0).astype(np.float32)
    g = rng.randn(*SHAPE).astype(np.float32)
    return x, g


def _ulp_bf16(v):
    """The bf16 spacing at |v| (the subnormal spacing below the normal
    range)."""
    mag = np.abs(v).astype(np.float32)
    return np.maximum(np.spacing(mag) * 2.0 ** 16, 2.0 ** -133)


def _jax_run(fn, x, g, jdt):
    """JAX's y, codes and dx of ``fn`` on x, g in ``jdt``."""
    jx, jg = jnp.asarray(x).astype(jdt), jnp.asarray(g).astype(jdt)
    captured = {}
    real_fwd = jax_act._fewbit_fwd

    def spy(spec, xx, borders, levels):
        y, res = real_fwd(spec, xx, borders, levels)
        captured["res"] = (spec, res[0])
        return y, res

    jax_act.fewbit_activation.defvjp(spy, jax_act._fewbit_bwd)
    try:
        jy, vjp = jax.vjp(fn, jx)
        (jdx,) = vjp(jg)
    finally:
        jax_act.fewbit_activation.defvjp(real_fwd, jax_act._fewbit_bwd)
    spec, packed = captured["res"]
    codes = np.asarray(jax_bitpack.unpack_codes(packed, spec.bits, x.size)
                       ).reshape(x.shape)
    return spec, np.asarray(jy.astype(jnp.float32)), codes, np.asarray(
        jdx.astype(jnp.float32))


def _port_run(fn, x, g, tdt):
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    y = fn(tx)
    packed = y.grad_fn.saved_tensors[0]
    spec = y.grad_fn.spec
    codes = unpack_codes(packed, spec.bits, x.shape[0]).numpy()
    y.backward(torch.from_numpy(g).to(tdt))
    return spec, y.detach().float().numpy(), codes, tx.grad.float().numpy()


def _check(name, jfn, tfn, x, g, dt):
    tdt, jdt = DTYPES[dt]
    jspec, jy, jcodes, jdx = _jax_run(jfn, x, g, jdt)
    spec, y, codes, dx = _port_run(tfn, x, g, tdt)
    assert spec.bits == jspec.bits and y.dtype == np.float32
    np.testing.assert_array_equal(codes, jcodes, err_msg=f"{name} codes")
    np.testing.assert_array_equal(dx, jdx, err_msg=f"{name} dx")
    if dt == "f32":
        np.testing.assert_allclose(y, jy, rtol=1e-5, atol=1e-5,
                                   err_msg=f"{name} y")
        return
    # JAX's forward of the same bf16 values in f32, rounded once.
    xb = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    jargs = spec_args(spec, torch.bfloat16)
    want = np.asarray(jspec.fwd(jnp.asarray(xb), jargs if
                                spec.code != "stepwise" else jspec.args)
                      .astype(jnp.bfloat16).astype(jnp.float32))
    err = np.abs(y - want)
    ulp = np.maximum(_ulp_bf16(want), _ulp_bf16(y))  # across a binade too
    tol = 1e-5 + 1e-5 * np.abs(want) + ulp
    assert (err <= tol).all(), (name, float((err / tol).max()))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("bits", [1, 2, 3, 4])
@pytest.mark.parametrize("name", CONT)
def test_continuous_matches_jax(name, bits, dt):
    x, g = _inputs(bits)
    _check(name, lambda u: getattr(JF, name)(u, bits=bits),
           lambda u: getattr(F, name)(u, bits=bits), x, g, dt)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", ["silu", "softplus"])
def test_custom_lut_matches_jax(name, dt):
    x, g = _inputs(21)
    _check(name, lambda u: getattr(JF, name)(u, **LUT32),
           lambda u: getattr(F, name)(u, **LUT32), x, g, dt)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("which", ["default", "other"])
@pytest.mark.parametrize("name", list(PIECEWISE))
def test_piecewise_matches_jax(name, which, dt):
    x, g = _inputs(11)
    args = (PIECEWISE[name] if which == "other"
            else PIECEWISE_DEFAULT.get(name, ()))
    if dt == "bf16" and which == "other" and args:
        # Inputs on the rounded argument itself and on the f32 one: where
        # an f32 compare and a bf16 one disagree.
        lam = float(torch.tensor(args[0]).to(torch.bfloat16))
        x[0, :4] = [lam, -lam, args[0], -args[0]]
    _check(name, lambda u: getattr(JF, name)(u, *args),
           lambda u: getattr(F, name)(u, *args), x, g, dt)


def test_bf16_predicate_compares_in_bf16():
    """JAX's hardshrink(x, 0.3) on bf16 |x| = 0.30078125 = bf16(0.3): the
    bf16 compare is false, so the gradient is 0 (an f32 compare gives
    1)."""
    x = torch.tensor([[0.30078125, -0.30078125, 0.3125, 0.25]],
                     dtype=torch.bfloat16, requires_grad=True)
    y = F.hardshrink(x, 0.3)
    y.backward(torch.ones_like(y))
    assert x.grad.float().tolist() == [[0.0, 0.0, 1.0, 0.0]]
    assert y.float().tolist() == [[0.0, 0.0, 0.3125, 0.0]]


@pytest.mark.parametrize("lut", list(STEPWISE_LUTS))
@pytest.mark.parametrize("shift", [None, (0.25, 0.5)], ids=["noshift",
                                                            "shift"])
@pytest.mark.parametrize("parity", [None, False, True],
                         ids=["none", "even", "odd"])
def test_stepwise_matches_jax(parity, shift, lut):
    """f32, against JAX's plain path (both recentre in f32 here)."""
    borders, levels = STEPWISE_LUTS[lut]
    x, g = _inputs(5)
    _check("stepwise",
           lambda u: JF.stepwise(u, borders, levels, parity, shift),
           lambda u: F.stepwise(u, borders, levels, parity, shift), x, g,
           "f32")


def test_stepwise_edges_and_limits():
    """Outer borders stripped; at most 256 levels; parity True adds the sign
    bit, at the padded half size for a 5-level LUT (codes 8..12)."""
    x = torch.linspace(-3, 3, 128).reshape(1, 128).requires_grad_()
    y = F.stepwise(x, [-10.0, 0.5, 1.0, 1.5, 2.0, 10.0],
                   [1.0, 2.0, 3.0, 4.0, 5.0], parity=True)
    spec = y.grad_fn.spec
    assert spec.bits == 4 and spec.n_borders == 4
    codes = unpack_codes(y.grad_fn.saved_tensors[0], 4, 1)
    assert set(codes[x.detach() < 0].tolist()) <= {8, 9, 10, 11, 12}
    torch.testing.assert_close(y, x, rtol=0, atol=0)
    with pytest.raises(ValueError, match="256"):
        F.stepwise(x, np.arange(256.0), np.ones(257))
    with pytest.raises(ValueError, match="len"):
        F.stepwise(x, [0.0, 1.0, 2.0], [1.0])


def test_resolve_activation_names_and_defaults():
    """Every name JAX resolves, with its default args and levels; stepwise
    and unknown names raise, as in JAX."""
    for name in jax_acts.CONTINUOUS + tuple(PIECEWISE):
        jspec, jb, jv = jax_acts.resolve_activation(name)
        spec, b, v = F.resolve_activation(name)
        assert (spec.name, spec.bits, spec.args, spec.n_borders) == (
            jspec.name, jspec.bits, jspec.args, jspec.n_borders), name
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    spec, _, v = F.resolve_activation("leaky_relu", args=(0.2,))
    np.testing.assert_array_equal(v.numpy(), np.float32([0.2, 1.0]))
    for name in ("stepwise", "nope"):
        with pytest.raises(ValueError, match="unknown activation"):
            jax_acts.resolve_activation(name)
        with pytest.raises(ValueError, match="unknown activation"):
            F.resolve_activation(name)


def test_surface_matches_jax():
    """Every exported name of both JAX modules exists in the port, each
    function with JAX's parameters and defaults, each module with the flax
    fields and their defaults, in their order."""
    assert set(jax_acts.__all__) <= set(acts.__all__)
    assert set(jax_mods.__all__) == set(M.activations.__all__)
    for name in jax_acts.__all__:
        if name == "store":
            assert F.store is acts.store
            continue
        jsig = inspect.signature(getattr(JF, name))
        sig = inspect.signature(getattr(F, name))
        assert [(p.name, p.default, p.kind) for p in sig.parameters.values()
                ] == [(p.name, p.default, p.kind)
                      for p in jsig.parameters.values()], name
    for name in jax_mods.__all__:
        fields = [(f.name, f.default) for f in
                  getattr(JM, name).__dataclass_fields__.values()
                  if f.name not in ("parent", "name")]
        params = [(p.name, p.default) for p in inspect.signature(
            getattr(M, name)).parameters.values()
                  if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]
        assert params == fields, name
    assert not hasattr(acts, "PORTED")


MODULES = {
    "Hardshrink": ("hardshrink", dict(lambd=0.3)),
    "Hardsigmoid": ("hardsigmoid", {}),
    "Hardtanh": ("hardtanh", dict(min_val=-0.5, max_val=2.0)),
    "LeakyReLU": ("leaky_relu", dict(negative_slope=0.2)),
    "ReLU": ("relu", {}),
    "ReLU6": ("relu6", {}),
    "Softshrink": ("softshrink", dict(lambd=0.7)),
    "Threshold": ("threshold", dict(threshold=0.1, value=2.0)),
    "Stepwise": ("stepwise", dict(borders=[0.2, 0.8], levels=[0.5, 1.0, 2.0],
                                  parity=True, shift=(0.1, 0.25))),
    "CELU": ("celu", dict(bits=2, alpha=0.5)),
    "ELU": ("elu", dict(alpha=1.5)),
    "GELU": ("gelu", dict(bits=4)),
    "Hardswish": ("hardswish", dict(bits=1)),
    "LogSigmoid": ("logsigmoid", {}),
    "Mish": ("mish", dict(bits=2)),
    "SELU": ("selu", {}),
    "Sigmoid": ("sigmoid", dict(bits=4)),
    "SiLU": ("silu", dict(borders=[-1.0, 0.0, 1.0],
                          values=[0.0, 0.3, 0.7, 1.0])),
    "Softplus": ("softplus", dict(beta=2.0, threshold=5.0)),
    "Softsign": ("softsign", {}),
    "Tanh": ("tanh", dict(bits=1)),
    "Tanhshrink": ("tanhshrink", {}),
}


@pytest.mark.parametrize("cls", list(MODULES))
def test_module_matches_functional(cls):
    fname, kw = MODULES[cls]
    x, g = _inputs(3)
    a = torch.from_numpy(x).requires_grad_()
    b = torch.from_numpy(x).requires_grad_()
    ya = getattr(M, cls)(**kw)(a)
    if fname == "stepwise":
        yb = F.stepwise(b, **kw)
    else:
        params = inspect.signature(getattr(F, fname)).parameters
        pos = [kw[p] for p in params if p in kw and
               params[p].kind == params[p].POSITIONAL_OR_KEYWORD]
        lut = {k: v for k, v in kw.items()
               if params[k].kind == params[k].KEYWORD_ONLY}
        yb = getattr(F, fname)(b, *pos, **lut)
    torch.testing.assert_close(ya, yb, rtol=0, atol=0)
    ya.backward(torch.from_numpy(g))
    yb.backward(torch.from_numpy(g))
    torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("FEWBIT_TPU_NATIVE", "interpret")


def test_bf16_stepwise_shift_follows_pallas(interpret):
    """The JAX package's two paths disagree on bf16 ``stepwise`` with a
    shift: its plain path recentres x - s in bf16, its Pallas kernel in f32
    (``_compute_codes``).  The port takes the f32 rule: its gradient equals
    the Pallas path's to the bit, and the JAX plain path's differs."""
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(256, 128).astype(np.float32), jnp.bfloat16)
    g = jnp.ones_like(x)
    args = ([-0.5, 0.0, 0.5], [0.1, 0.2, 0.3, 0.4], None, (0.1, 0.0))

    def jax_dx():
        _, vjp = jax.vjp(lambda u: JF.stepwise(u, *args), x)
        return np.asarray(vjp(g)[0].astype(jnp.float32))

    pallas = jax_dx()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FEWBIT_TPU_NATIVE", "0")
        plain = jax_dx()
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    tx.requires_grad_()
    F.stepwise(tx, *args).backward(torch.ones_like(tx))
    np.testing.assert_array_equal(tx.grad.float().numpy(), pallas)
    assert (plain != pallas).sum() > 0


NAMES = jax_acts.CONTINUOUS + tuple(PIECEWISE)


def test_act_envelopes_match_jax_eligible():
    """Kernels 4/5 and 6 take exactly what the JAX package's ``_eligible``
    takes, for every name and a 1-, 3-, 4- and 5-bit LUT, and stepwise
    (kernels 4 and 5 only: no name resolves to it for kernel 6)."""
    lut5 = dict(borders=np.linspace(-4, 4, 31), values=np.ones(32))
    triples = [((jax_acts.resolve_activation(name, **lut)[0],
                 F.resolve_activation(name, **lut)[0]))
               for name in NAMES for lut in ({}, dict(bits=1), dict(bits=4),
                                             lut5)
               if name in acts.CONTINUOUS or not lut]
    big = np.linspace(0, 3, 127)  # 128 levels: 7 bits, past the envelope
    for levels in (np.ones(5), np.ones(32), np.ones(128)):
        borders = big[:len(levels) - 1]
        for parity in (None, True):
            spec = acts.stepwise_triple(borders, levels, parity)[0]
            triples.append((jax_act.ActivationSpec(
                "stepwise", spec.bits, None, None, spec.args,
                spec.n_borders), spec))
    for jspec, spec in triples:
        for c in (64, 100, 128, 3072):
            for dt, jdt in ((torch.float32, jnp.float32),
                            (torch.bfloat16, jnp.bfloat16),
                            (torch.float16, jnp.float16)):
                want = pk._eligible(jspec, (16, c), jnp.dtype(jdt))
                assert K.act_kernel_ok(spec, c, dt) == want, spec
                assert K.dense_act_ok(spec, 128, c, dt) == (
                    want and spec.name != "stepwise"), spec


def test_ffn_envelope_matches_jax_pallas_ok(interpret):
    """``fewbit_ffn``'s kernel gate equals the JAX package's
    ``_pallas_ok`` for every name, width, dtype and shape tried."""
    shapes = [(1024, 128, 512, 128), (1000, 128, 512, 128),
              (1024, 100, 512, 128), (1024, 128, 500, 128)]
    for name in NAMES:
        for lut in ({}, dict(bits=1), dict(bits=4)):
            jspec = jax_acts.resolve_activation(name, **lut)[0]
            spec = F.resolve_activation(name, **lut)[0]
            jcfg = jax_ffn._FFNConfig(jspec, 256, True, True)
            cfg = port_ffn._FFNConfig(spec, 256, True, True)
            for n, kdim, m, h in shapes:
                for dt, jdt in ((torch.float32, jnp.float32),
                                (torch.bfloat16, jnp.bfloat16),
                                (torch.float16, jnp.float16)):
                    assert port_ffn._kernel_ok(cfg, n, kdim, m, h, dt) == (
                        jax_ffn._pallas_ok(jcfg, n, kdim, m, h,
                                           jnp.dtype(jdt))), (name, lut)
