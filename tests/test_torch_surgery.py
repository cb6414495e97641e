"""The port's model surgery, residual accounting (``fewbit_tpu_torch/util.py``)
and class-level patching (``fewbit_tpu_torch/patch.py``) against the JAX
package (``fewbit_tpu/util.py``, ``fewbit_tpu/patch.py``) on the same
weights and inputs, made from a numpy seed.

Tolerances: forwards and gradients in f32 against JAX's, ``atol`` 1e-5
(other summation orders; the few-bit GELU's codes are equal, its forward
exact); the converted port RoBERTa against the config-built one, on the
same device and from the same generators, to the bit.  Residual bytes are
counted exactly.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as TF
from torch import nn

import flax.linen as fnn
import jax
import jax.numpy as jnp

import fewbit_tpu.functional as JF
import fewbit_tpu.modules as JM
from fewbit_tpu import util as jutil
from fewbit_tpu.patch import use_fewbit_activation as jax_use_activation
from fewbit_tpu.patch import use_fewbit_dense as jax_use_dense

import fewbit_tpu_torch.functional as PF
from fewbit_tpu_torch.models import (RobertaConfig,
                                     RobertaForSequenceClassification)
from fewbit_tpu_torch.modules.linear import Dense
from fewbit_tpu_torch.modules import GELU, RandomizedDense
from fewbit_tpu_torch.patch import use_fewbit_activation, use_fewbit_dense
from fewbit_tpu_torch.train import classification_loss, synthetic_glue
from fewbit_tpu_torch.util import (convert_linear, device_memory_stats,
                                   estimate_memory_usage, map_module,
                                   memory_delta_bytes, peak_memory_bytes,
                                   profile_trace, residual_shapes)

ATOL = 1e-5
X = np.random.RandomState(0).randn(16, 32).astype(np.float32)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _copy_dense(layer, p):
    """A flax Dense's ``kernel``/``bias`` into a torch ``(out, in)`` layer."""
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(np.array(p["kernel"]).T))
        layer.bias.copy_(torch.from_numpy(np.array(p["bias"])))


# ---------------------------------------------------------------------------
# Surgery: the cases of tests/test_modules.py TestSurgery.
# ---------------------------------------------------------------------------


class JaxEncoder(fnn.Module):
    proj: fnn.Module
    out: fnn.Module
    activation: fnn.Module

    def __call__(self, x):
        return self.out(self.activation(self.proj(x)))


class Encoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.proj = nn.Linear(32, 24)
        self.activation = GELU()
        self.out = nn.Linear(24, 4)

    def forward(self, x, generator=None):
        args = () if generator is None else (generator,)
        return self.out(self.activation(self.proj(x, *args)), *args)


def _encoders():
    jmodel = JaxEncoder(proj=fnn.Dense(24, name="proj"),
                        out=fnn.Dense(4, name="out"), activation=JM.GELU())
    params = jmodel.init(jax.random.key(0), jnp.asarray(X))
    model = Encoder()
    for name in ("proj", "out"):
        _copy_dense(getattr(model, name), params["params"][name])
    return jmodel, params, model


def test_map_module_swaps_linear_and_matches_jax():
    jmodel, params, model = _encoders()
    weights = {n: p for n, p in model.named_parameters()}
    y_before = model(torch.from_numpy(X))
    swapped = map_module(model, lambda m, path: convert_linear(
        m, RandomizedDense, proj_dim_ratio=0.25))
    assert swapped is model
    assert isinstance(model.proj, RandomizedDense)
    assert isinstance(model.out, RandomizedDense)
    assert isinstance(model.activation, GELU)
    # The same parameters under the same state_dict keys.
    assert {n: p for n, p in model.named_parameters()} == weights
    y_after = model(torch.from_numpy(X), _gen())
    assert torch.equal(y_after, y_before)
    jswapped = jutil.map_module(jmodel, lambda m, path: jutil.convert_linear(
        m, JM.RandomizedDense, proj_dim_ratio=0.25))
    y_jax = jswapped.apply(params, jnp.asarray(X),
                           rngs={"sketch": jax.random.key(1)})
    np.testing.assert_allclose(y_after.detach().numpy(), np.asarray(y_jax),
                               atol=ATOL)


def test_map_module_path_filter_matches_jax():
    jmodel, _, model = _encoders()
    hits, jhits = [], []

    def spy(into):
        def fn(m, path):
            into.append(path)
            return m
        return fn

    map_module(model, spy(hits), patt=r".*/proj$")
    jutil.map_module(jmodel, spy(jhits), patt=r".*/proj$")
    assert hits == jhits == ["/proj"]
    every, jevery = [], []
    map_module(model, spy(every))
    jutil.map_module(jmodel, spy(jevery))
    assert every[-1] == jevery[-1] == "/"
    assert sorted(every) == sorted(jevery) == ["/", "/activation", "/out",
                                              "/proj"]


def test_map_module_paths_of_lists():
    model = nn.Sequential(nn.Linear(4, 4), nn.ModuleList(
        [nn.Linear(4, 4), nn.ReLU()]))
    seen = []
    map_module(model, lambda m, p: seen.append(p) or m)
    assert seen == ["/0", "/1/0", "/1/1", "/1", "/"]
    map_module(model, lambda m, p: convert_linear(
        m, RandomizedDense, proj_dim=2), patt=r"/1/\d+$")
    assert isinstance(model[1][0], RandomizedDense)
    assert isinstance(model[0], nn.Linear)
    # func's replacement of the root is what map_module returns.
    lin = nn.Linear(3, 3)
    assert isinstance(map_module(lin, lambda m, p: convert_linear(
        m, RandomizedDense, proj_dim=2)), RandomizedDense)


def test_map_module_validates_return():
    with pytest.raises(ValueError):
        map_module(Encoder(), lambda m, p: None)
    with pytest.raises(ValueError):
        jutil.map_module(_encoders()[0], lambda m, p: None)


def test_convert_passthrough():
    mod = GELU()
    assert convert_linear(mod, RandomizedDense) is mod
    jmod = JM.GELU()
    assert jutil.convert_linear(jmod, JM.RandomizedDense) is jmod


def test_convert_linear_keeps_configuration():
    dense = Dense(8, 6, torch.bfloat16, bias=False, device="cpu")
    new = convert_linear(dense, RandomizedDense, proj_dim=4,
                         matmul="countsketch")
    assert (new.in_features, new.out_features, new.dtype) == (8, 6,
                                                              torch.bfloat16)
    assert new.bias is None and new.weight is dense.weight
    assert (new.proj_dim, new.matmul) == (4, "countsketch")
    lin = nn.Linear(8, 6)
    new = convert_linear(lin, RandomizedDense, proj_dim_ratio=0.5)
    assert new.dtype is None and new.bias is lin.bias


SMALL = dict(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=2,
             intermediate_size=128, max_position_embeddings=66)
SKETCHED = r".*/(query|key|value|output|intermediate|ffn_output|head_dense" \
           r"|head_out)$"


def test_converted_roberta_equals_config_built_u():
    """The vanilla port RoBERTa converted (countsketch at 0.2 in every
    projection the config sketches) under the 3-bit GELU patch gives the
    logits, loss and gradients of the config-built model, path U
    (``gelu_bits=3, proj_dim_ratio=0.2, sketch="countsketch",
    fused_ffn=False``), to the bit."""
    u = RobertaForSequenceClassification(
        RobertaConfig(**SMALL, gelu_bits=3, proj_dim_ratio=0.2,
                      sketch="countsketch", fused_ffn=False),
        device="cpu", generator=_gen(0))
    model = RobertaForSequenceClassification(RobertaConfig(**SMALL),
                                             device="cpu")
    model.load_state_dict(u.state_dict())
    paths = []

    def convert(m, path):
        paths.append(path)
        return convert_linear(m, RandomizedDense, proj_dim_ratio=0.2,
                              matmul="countsketch")

    map_module(model, convert, SKETCHED)
    assert len(paths) == 2 * 6 + 2
    assert list(model.state_dict()) == list(u.state_dict())
    batch = {k: torch.from_numpy(v).long() for k, v in next(
        synthetic_glue(8, 64, vocab_size=1000)).items()}

    def run(m):
        logits = m(batch["input_ids"], batch["attention_mask"],
                   deterministic=False, dropout_generator=_gen(1),
                   sketch_generator=_gen(2))
        loss = classification_loss(logits, batch["labels"])
        loss.backward()
        return logits, loss, {n: p.grad for n, p in m.named_parameters()}

    want = run(u)
    with use_fewbit_activation("gelu", bits=3):
        got = run(model)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert list(got[2]) == list(want[2])
    for name in want[2]:
        assert torch.equal(got[2][name], want[2][name]), name


# ---------------------------------------------------------------------------
# Accounting.
# ---------------------------------------------------------------------------


def test_estimate_memory_usage_gelu_matches_jax():
    """A 1-D input packs as (3, 1024, 1) int32 in the port and (3, 1024)
    uint32 in JAX, plus the 8-level LUT: the same bytes."""
    n = 1 << 15
    got = estimate_memory_usage(lambda t: PF.gelu(t, bits=3),
                                torch.zeros(n))
    want = jutil.estimate_memory_usage(lambda t: JF.gelu(t, bits=3),
                                       jnp.zeros((n,), jnp.float32))
    assert got == want == 3 * n // 8 + 8 * 4
    shapes = list(residual_shapes(lambda t: PF.gelu(t, bits=3),
                                  torch.zeros(n)))
    assert shapes == [((3, 1024, 1), torch.int32), ((8,), torch.float32)]


def test_estimate_memory_usage_padding_differs_from_jax():
    """Rows of a 2-D input pad to a multiple of 32 per column in the port's
    ``(bits, ceil(N / 32), M)`` layout, where JAX pads the flat vector once:
    at (50, 48), 3 * 2 * 48 words against 3 * ceil(2400 / 32) = 3 * 75,
    252 bytes more.  Where N is a multiple of 32 the two are equal."""
    for shape, extra in (((50, 48), 3 * (2 * 48 - 75) * 4), ((64, 48), 0)):
        got = estimate_memory_usage(lambda t: PF.gelu(t, bits=3),
                                    torch.zeros(shape))
        want = jutil.estimate_memory_usage(lambda t: JF.gelu(t, bits=3),
                                           jnp.zeros(shape, jnp.float32))
        assert got - want == extra


@pytest.mark.parametrize("case", ["matmul", "linear", "square"])
def test_estimate_memory_usage_matches_jax(case):
    """Functions whose residuals are their inputs, in every argument (as
    ``jax.vjp`` differentiates in all of them); a tensor saved twice counts
    once."""
    rng = np.random.RandomState(5)
    x = rng.randn(12, 8).astype(np.float32)
    w = rng.randn(8, 6).astype(np.float32)
    fns = {"matmul": ((lambda a, b: a @ b), (x, w)),
           "linear": ((lambda a, b: a @ b + 1.0), (x, w)),
           "square": ((lambda a: a * a), (x,))}
    fn, args = fns[case]
    got = estimate_memory_usage(fn, *map(torch.from_numpy, args))
    want = jutil.estimate_memory_usage(fn, *map(jnp.asarray, args))
    assert got == want == sum(a.nbytes for a in args)
    total = estimate_memory_usage(fn, *map(torch.from_numpy, args),
                                  saved_only=False)
    jtotal = jutil.estimate_memory_usage(fn, *map(jnp.asarray, args),
                                         saved_only=False)
    assert total == jtotal


def test_memory_delta():
    n = 1 << 15
    x = torch.zeros(n)
    delta = memory_delta_bytes(lambda t: TF.gelu(t),
                               lambda t: PF.gelu(t, bits=3), x)
    jdelta = jutil.memory_delta_bytes(
        lambda t: jax.nn.gelu(t, approximate=False),
        lambda t: JF.gelu(t, bits=3), jnp.zeros((n,), jnp.float32))
    assert delta > n * 3
    assert delta == 4 * n - (3 * n // 8 + 32)
    assert jdelta > n * 3


def test_device_stats_on_cpu():
    assert device_memory_stats("cpu") == {}
    assert peak_memory_bytes("cpu") is None
    assert peak_memory_bytes(torch.device("cpu")) is None
    if not torch.cuda.is_available():
        assert device_memory_stats() == {} and peak_memory_bytes() is None
    cpu = jax.devices("cpu")[0]
    assert jutil.peak_memory_bytes(cpu) is None


def test_profile_trace_writes_a_trace(tmp_path):
    x = torch.randn(64, 64, requires_grad=True)
    with profile_trace(tmp_path) as prof:
        (PF.gelu(x, bits=3) @ x).sum().backward()
    assert prof is not None
    traces = list(tmp_path.rglob("*.json")) + list(tmp_path.rglob("*.gz"))
    assert traces, list(tmp_path.rglob("*"))


# ---------------------------------------------------------------------------
# Patching: the cases of tests/test_patch.py on nn.Linear + F.gelu.
# ---------------------------------------------------------------------------

PX = np.random.RandomState(0).randn(512, 32).astype(np.float32)


class JaxThirdParty(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        x = fnn.Dense(64)(x)
        x = jax.nn.gelu(x, approximate=False)
        return fnn.Dense(4)(x)


class ThirdParty(nn.Module):
    def __init__(self):
        super().__init__()
        self.dense_0 = nn.Linear(32, 64)
        self.dense_1 = nn.Linear(64, 4)

    def forward(self, x):
        return self.dense_1(TF.gelu(self.dense_0(x), approximate="none"))


def _third_party():
    jmodel = JaxThirdParty()
    params = jmodel.init(jax.random.key(0), jnp.asarray(PX))
    model = ThirdParty()
    for name in ("Dense_0", "Dense_1"):
        _copy_dense(getattr(model, name.lower()), params["params"][name])
    return jmodel, params, model


def _port_grads(model, **kw):
    x = torch.from_numpy(PX).requires_grad_()
    y = model(x)
    y.sum().backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return y.detach().numpy(), x.grad.numpy(), grads


def _jax_grads(jmodel, params, **kw):
    xj = jnp.asarray(PX)
    y = jmodel.apply(params, xj, **kw)
    gp, gx = jax.grad(lambda p, t: jmodel.apply(p, t, **kw).sum(),
                      argnums=(0, 1))(params, xj)
    return np.asarray(y), np.asarray(gx), gp["params"]


def _residual_bytes(model):
    return estimate_memory_usage(lambda: model(torch.from_numpy(PX)).sum())


def test_dense_patch_matches_jax_forward_dx_db():
    jmodel, params, model = _third_party()
    y_ref = model(torch.from_numpy(PX)).detach()
    base = _residual_bytes(model)
    original = nn.Linear.forward
    with use_fewbit_dense(proj_dim_ratio=0.1, generator=_gen(1)):
        assert nn.Linear.forward is not original
        y, dx, grads = _port_grads(model)
        patched = _residual_bytes(model)
    with jax_use_dense(proj_dim_ratio=0.1):
        jy, jdx, jgrads = _jax_grads(jmodel, params,
                                     rngs={"sketch": jax.random.key(1)})
    np.testing.assert_allclose(y, jy, atol=ATOL)
    np.testing.assert_allclose(y, y_ref.numpy(), atol=ATOL)
    # Only dW is sketched: dx and db are exact on both sides.
    np.testing.assert_allclose(dx, jdx, atol=ATOL)
    for name in ("Dense_0", "Dense_1"):
        np.testing.assert_allclose(grads[f"{name.lower()}.bias"].numpy(),
                                   np.asarray(jgrads[name]["bias"]),
                                   atol=ATOL)
    # Dense inputs are sketched at 10%; the GELU's residual stays.
    assert patched < base * 0.8, (patched, base)
    assert nn.Linear.forward is original
    assert torch.equal(model(torch.from_numpy(PX)).detach(), y_ref)


def test_patches_restore_after_an_exception():
    original = nn.Linear.forward
    gelu, tanh, sigmoid = TF.gelu, torch.tanh, torch.sigmoid
    with pytest.raises(RuntimeError, match="inside"):
        with use_fewbit_dense(proj_dim_ratio=0.5), \
                use_fewbit_activation("tanh"):
            assert torch.tanh is not tanh
            raise RuntimeError("inside")
    with pytest.raises(RuntimeError, match="inside"):
        with use_fewbit_activation("sigmoid"):
            raise RuntimeError("inside")
    assert nn.Linear.forward is original
    assert (TF.gelu, torch.tanh, torch.sigmoid) == (gelu, tanh, sigmoid)
    with pytest.raises(ValueError, match="unsupported"):
        with use_fewbit_activation("mish"):
            pass


def test_activation_patch_matches_jax():
    jmodel, params, model = _third_party()
    y_ref = model(torch.from_numpy(PX)).detach().numpy()
    base = _residual_bytes(model)
    exact_gelu = TF.gelu
    with use_fewbit_activation("gelu", bits=3):
        y, dx, grads = _port_grads(model)
        patched = _residual_bytes(model)
        # nn.GELU reaches it through torch.nn.functional.
        z = torch.randn(64, 3)
        assert torch.equal(nn.GELU()(z), PF.gelu(z, bits=3))
    with jax_use_activation("gelu", bits=3):
        jy, jdx, jgrads = _jax_grads(jmodel, params)
    np.testing.assert_allclose(y, jy, atol=ATOL)
    np.testing.assert_allclose(y, y_ref, atol=ATOL)
    np.testing.assert_allclose(dx, jdx, atol=ATOL)
    for name in ("Dense_0", "Dense_1"):
        p = name.lower()
        np.testing.assert_allclose(grads[f"{p}.weight"].numpy(),
                                   np.asarray(jgrads[name]["kernel"]).T,
                                   atol=1e-4)
        np.testing.assert_allclose(grads[f"{p}.bias"].numpy(),
                                   np.asarray(jgrads[name]["bias"]),
                                   atol=1e-4)
    # z (512 x 64 f32) is replaced by 3-bit codes and the LUT.
    assert base - patched == 512 * 64 * 4 - (3 * 16 * 64 * 4 + 32)
    assert TF.gelu is exact_gelu


@pytest.mark.parametrize("name", ["silu", "relu", "sigmoid", "tanh"])
def test_activation_patch_reaches_modules(name):
    x = torch.randn(128, 16)
    module = {"silu": nn.SiLU(), "relu": nn.ReLU(), "sigmoid": nn.Sigmoid(),
              "tanh": nn.Tanh()}[name]
    exact = module(x)
    few = getattr(PF, name)
    with use_fewbit_activation(name, bits=2):
        got = module(x)
        want = few(x) if name == "relu" else few(x, bits=2)
        assert torch.equal(getattr(TF, name)(x, inplace=False)
                           if name in ("silu", "relu") else
                           getattr(TF, name)(x), want)
    assert torch.equal(got, want)
    torch.testing.assert_close(got, exact)
    assert torch.equal(module(x), exact)


def test_patches_compose():
    _, _, model = _third_party()
    y_ref = model(torch.from_numpy(PX)).detach()
    with use_fewbit_dense(proj_dim_ratio=0.2, generator=_gen(5)), \
            use_fewbit_activation("gelu", bits=2):
        y = model(torch.from_numpy(PX))
        y.sum().backward()
    torch.testing.assert_close(y.detach(), y_ref, atol=ATOL, rtol=0)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


def test_dense_patch_generator_fallback(monkeypatch):
    """Without a generator the patched layer warns and uses a constant seed
    (JAX falls back to ``key(0)`` silently); under
    ``FEWBIT_TPU_STRICT_SKETCH=1`` it raises."""
    lin = nn.Linear(32, 8)
    x = torch.from_numpy(PX)
    with use_fewbit_dense(proj_dim_ratio=0.25):
        with pytest.warns(UserWarning, match="constant key"):
            y = lin(x)
        monkeypatch.setenv("FEWBIT_TPU_STRICT_SKETCH", "1")
        with pytest.raises(RuntimeError, match="constant key"):
            lin(x)
    torch.testing.assert_close(y, nn.functional.linear(x, lin.weight,
                                                       lin.bias))


def test_hf_roberta_activation_patch_binds_at_construction():
    """HF's ``GELUActivation`` binds ``nn.functional.gelu`` when it is
    built: a model built outside the activation patch keeps the exact GELU
    inside it; one built inside keeps the few-bit GELU after it.  Both
    give the same forward (the few-bit forward is exact), and the dense
    patch reaches every HF ``nn.Linear``."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.RobertaConfig(
        vocab_size=100, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=40, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    outside = transformers.RobertaModel(cfg).eval()
    with use_fewbit_activation("gelu", bits=3):
        inside = transformers.RobertaModel(cfg).eval()
    inside.load_state_dict(outside.state_dict())
    ids = torch.from_numpy(np.random.RandomState(1).randint(3, 100, (2, 16)))

    def run(m):
        return m(input_ids=ids).last_hidden_state

    def nbytes(m):
        return estimate_memory_usage(lambda: run(m).sum())

    exact = nbytes(outside)
    with use_fewbit_activation("gelu", bits=3):
        assert nbytes(outside) == exact
    codes = 2 * (3 * 1 * 64 * 4 + 32)
    z = 2 * (2 * 16 * 64 * 4)
    assert nbytes(inside) == exact - z + codes
    torch.testing.assert_close(run(inside), run(outside))
    with use_fewbit_dense(proj_dim=4, matmul="countsketch",
                          generator=_gen(3)):
        sketched = nbytes(outside)
        torch.testing.assert_close(run(outside), run(inside))
    assert sketched < exact
