"""The port's variance estimation (``fewbit_tpu_torch/functional/variance.py``,
``modules/variance.py``) against the JAX package on the same inputs, made
from a numpy seed.

Tolerances: the three estimators in f32 against JAX's in f32, ``rtol``
1e-5 (other summation orders); the brute-force SGD check 5% (as
``tests/test_linear.py``).  ``g`` of a ``sum`` loss is all ones, so the
``VarianceEstimator`` triple does not depend on the sketch and is held to
JAX's to 1e-5 as well.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fewbit_tpu.functional as JF
import fewbit_tpu.modules as JM

import fewbit_tpu_torch.functional as PF
from fewbit_tpu_torch.functional import (GradientStorage, catch_gradients,
                                         estimate_correlation,
                                         estimate_variance_rmm,
                                         estimate_variance_sgd)
from fewbit_tpu_torch.modules import (RandomizedDense, VarianceEstimator,
                                      VarianceEstimatorState)

RTOL = 1e-5


def _xg(seed, n, d_in, d_out, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, d_in).astype(dtype),
            rng.randn(n, d_out).astype(dtype))


def _triple(mod, x, g, batch_size=None, proj_dim=None):
    return (mod.estimate_correlation(x, g),
            mod.estimate_variance_sgd(x, g, batch_size),
            mod.estimate_variance_rmm(x, g, proj_dim))


@pytest.mark.parametrize("shape", [(16, 4, 3), (64, 16, 8), (256, 32, 24)])
@pytest.mark.parametrize("sizes", [(None, None), (64, 16)],
                         ids=["default", "given"])
def test_estimators_match_jax(shape, sizes):
    x, g = _xg(sum(shape), *shape)
    got = _triple(PF, torch.from_numpy(x), torch.from_numpy(g), *sizes)
    want = _triple(JF, jnp.asarray(x), jnp.asarray(g), *sizes)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.item(), float(b), rtol=RTOL)


def test_sgd_variance_brute_force():
    """``tests/test_linear.py``'s check on the port: the variance of the
    single-row estimators ``bs * g_i x_i^T`` over ``bs - 1``."""
    x, g = _xg(0, 16, 4, 3)
    v = estimate_variance_sgd(torch.from_numpy(x), torch.from_numpy(g))
    outers = np.einsum("ni,nj->nij", g, x) * 16
    brute = ((outers - outers.mean(0)) ** 2).sum(axis=(1, 2)).mean() / 15
    np.testing.assert_allclose(v.item(), brute, rtol=0.05)


def test_sgd_variance_rejects_a_row():
    x, g = _xg(1, 1, 4, 3)
    with pytest.raises(ValueError, match="at least 2 rows"):
        estimate_variance_sgd(torch.from_numpy(x), torch.from_numpy(g))
    with pytest.raises(ValueError, match="at least 2 rows"):
        JF.estimate_variance_sgd(jnp.asarray(x), jnp.asarray(g))
    x, g = _xg(1, 8, 4, 3)
    with pytest.raises(ValueError):
        estimate_variance_sgd(torch.from_numpy(x), torch.from_numpy(g), 1)


def test_bounds_and_accumulation_type():
    x, g = _xg(2, 32, 8, 8)
    corr = estimate_correlation(torch.from_numpy(x), torch.from_numpy(g))
    assert 0 <= corr.item() <= 1 + 1e-6
    assert estimate_variance_rmm(torch.from_numpy(x), torch.from_numpy(g),
                                 16).item() > 0
    # bf16 inputs accumulate in f32: the f32 result of the rounded values.
    xb = torch.from_numpy(x).bfloat16()
    gb = torch.from_numpy(g).bfloat16()
    for fn in (estimate_correlation, estimate_variance_sgd,
               estimate_variance_rmm):
        got = fn(xb, gb)
        assert got.dtype == torch.float32
        assert got.item() == fn(xb.float(), gb.float()).item()
    # f64 stays f64 (the chip script's reference recomputation).
    assert estimate_correlation(torch.from_numpy(x).double(),
                                torch.from_numpy(g).double()).dtype == \
        torch.float64


def test_catch_gradients_is_identity_and_records():
    x, g = _xg(3, 16, 8, 8)
    storage = GradientStorage()
    xt = torch.from_numpy(x).requires_grad_()
    y = catch_gradients(xt * 2.0, storage)
    assert torch.equal(y, xt.detach() * 2.0)
    assert torch.equal(storage.input, xt.detach() * 2.0)
    assert not storage.input.requires_grad
    y.backward(torch.from_numpy(g))
    assert torch.equal(storage.grad_output, torch.from_numpy(g))
    assert torch.equal(xt.grad, torch.from_numpy(g) * 2.0)


def _jax_estimator(x):
    state = JM.VarianceEstimatorState()
    wrapped = JM.VarianceEstimator(
        layer=JM.RandomizedDense(features=8, proj_dim_ratio=0.25),
        state=state)
    params = wrapped.init({"params": jax.random.key(0),
                           "sketch": jax.random.key(1)}, x)
    return wrapped, state, params


def _port_estimator(params, state=None):
    layer = RandomizedDense(16, 8, proj_dim_ratio=0.25, device="cpu")
    p = params["params"]["layer"]
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(np.array(p["kernel"]).T))
        layer.bias.copy_(torch.from_numpy(np.array(p["bias"])))
    return VarianceEstimator(layer, state)


def test_variance_estimator_matches_jax():
    """The port's triple on a RandomizedDense(8, proj_dim_ratio=0.25) under
    JAX's weights and a sum loss equals JAX's functions on (x, g), and its
    batch and sketch sizes the JAX module's.  The JAX module's own triple
    is not the reference: its two unordered callbacks leave x or y as the
    input (F-6, below), and under jit their order is not fixed."""
    x = np.random.RandomState(0).randn(64, 16).astype(np.float32)
    xj = jnp.asarray(x)
    wrapped, jstate, params = _jax_estimator(xj)
    jax.grad(lambda p: wrapped.apply(
        p, xj, rngs={"sketch": jax.random.key(2)}).sum())(params)
    jax.effects_barrier()

    calls = []
    state = VarianceEstimatorState(callback=lambda *a: calls.append(a))
    mod = _port_estimator(params, state)
    y = mod(torch.from_numpy(x), torch.Generator().manual_seed(2))
    y.sum().backward()
    assert (state.batch_size, state.proj_dim) == (jstate.batch_size,
                                                  jstate.proj_dim) == (64, 16)
    want = _triple(JF, xj, jnp.ones((64, 8), jnp.float32), 64, 16)
    np.testing.assert_allclose(state.variance, [float(w) for w in want],
                               rtol=RTOL)
    assert calls == [(*state.variance, 0)] and state.step == 1
    assert torch.equal(state.input, torch.from_numpy(x))
    assert torch.equal(state.grad_output, torch.ones(64, 8))


def test_jax_eager_estimator_records_the_layer_output():
    """ROADMAP queue 3, F-6: run eagerly (the callbacks in program order),
    the JAX module's second ``record_input`` (from ``catch_gradients`` on
    the output) overwrites the layer input, and its triple describes
    (y, g).  The port records x."""
    x = np.random.RandomState(0).randn(64, 16).astype(np.float32)
    xj = jnp.asarray(x)
    wrapped, jstate, params = _jax_estimator(xj)
    jax.grad(lambda p: wrapped.apply(
        p, xj, rngs={"sketch": jax.random.key(2)}).sum())(params)
    jax.effects_barrier()
    out = wrapped.apply(params, xj, rngs={"sketch": jax.random.key(2)})
    assert jstate.input.shape == (64, 8)
    wrong = _triple(JF, out, jnp.ones_like(out), 64, 16)
    np.testing.assert_allclose(jstate.variance, [float(w) for w in wrong],
                               rtol=RTOL)
    state = VarianceEstimatorState()
    _port_estimator(params, state)(
        torch.from_numpy(x), torch.Generator().manual_seed(2)).sum().backward()
    assert tuple(state.input.shape) == (64, 16)


def test_variance_estimator_passthrough_and_tuple_output():
    class Pair(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.inner = RandomizedDense(16, 8, proj_dim=12, device="cpu")
            self.proj_dim_ratio = self.inner.proj_dim_ratio
            self.proj_dim = self.inner.proj_dim
            self.proj_dim_min = self.proj_dim_max = None

        def forward(self, x, generator=None):
            return self.inner(x, generator=generator), "aux"

    x = torch.from_numpy(np.random.RandomState(4).randn(2, 10, 16)
                         .astype(np.float32))
    state = VarianceEstimatorState()
    y, aux = VarianceEstimator(Pair(), state)(
        x, generator=torch.Generator().manual_seed(0))
    assert aux == "aux"
    y.sum().backward()
    assert (state.batch_size, state.proj_dim) == (20, 12)
    assert state.variance is not None
    layer = RandomizedDense(16, 8, proj_dim_ratio=0.5, device="cpu")
    gen = torch.Generator().manual_seed(0)
    out = VarianceEstimator(layer)(x, gen)
    assert torch.equal(out, layer(x, torch.Generator().manual_seed(0)))


def test_variance_estimator_captures_the_layers_input_and_output_gradient():
    """As ``chip_smoke.py``'s surgery phase, at a tiny size: the attention
    projections of a RoBERTa (countsketch at 0.2) wrapped in
    ``VarianceEstimator`` by ``map_module``.  Each state's captures equal
    what hooks on the projection see (its input, the gradient of its
    output), and each triple equals the same functions on them in f64."""
    from fewbit_tpu_torch.models import (RobertaConfig,
                                         RobertaForSequenceClassification)
    from fewbit_tpu_torch.train import classification_loss
    from fewbit_tpu_torch.util import map_module

    model = RobertaForSequenceClassification(
        RobertaConfig(vocab_size=100, hidden_size=32, num_layers=2,
                      num_heads=2, intermediate_size=64,
                      max_position_embeddings=18, proj_dim_ratio=0.2,
                      sketch="countsketch"),
        device="cpu", generator=torch.Generator().manual_seed(0))
    states, seen = {}, {}

    def wrap(mod, path):
        states[path], seen[path] = VarianceEstimatorState(), {}

        def see_input(m, args):
            seen[path]["x"] = args[0].detach()

        def see_grad(m, args, out):
            out.register_hook(
                lambda g: seen[path].__setitem__("g", g.detach()))

        mod.register_forward_pre_hook(see_input)
        mod.register_forward_hook(see_grad)
        return VarianceEstimator(mod, states[path])

    map_module(model, wrap, r".*/attention/(query|key|value|output)$")
    assert len(states) == 8
    rng = np.random.RandomState(5)
    ids = torch.from_numpy(rng.randint(0, 100, (4, 16))).long()
    logits = model(ids, torch.ones(4, 16, dtype=torch.long),
                   deterministic=False,
                   dropout_generator=torch.Generator().manual_seed(1),
                   sketch_generator=torch.Generator().manual_seed(2))
    classification_loss(logits, torch.tensor([0, 1, 1, 0])).backward()
    for path, st in states.items():
        assert torch.equal(st.input, seen[path]["x"]), path
        assert torch.equal(st.grad_output, seen[path]["g"]), path
        x = st.input.reshape(-1, 32).double()
        g = st.grad_output.reshape(-1, 32).double()
        assert (st.batch_size, st.proj_dim) == (64, 12)
        want = [t.item() for t in (
            estimate_correlation(x, g),
            estimate_variance_sgd(x, g, st.batch_size),
            estimate_variance_rmm(x, g, st.proj_dim))]
        np.testing.assert_allclose(st.variance, want, rtol=RTOL)


def test_variance_example_on_cpu(capsys):
    from fewbit_tpu_torch.examples import variance_estimation

    rows = variance_estimation.main(["--device", "cpu"])
    assert [r["ratio"] for r in rows] == list(variance_estimation.RATIOS)
    ratios = [r["var_rmm"] / r["var_sgd"] for r in rows]
    assert all(a > b for a, b in zip(ratios, ratios[1:]))
    assert "rmm/sgd" in capsys.readouterr().out
