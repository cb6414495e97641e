"""Port parity for ``fewbit_tpu_torch.models.MLP`` against the JAX
package's ``MLP``: the JAX parameters carried across by
``load_flax_params``, the same input made from a seed with numpy, dropout
not involved.

Tolerances: both sides compute in f32 with other summation orders (atol
1e-5 of the largest value on outputs and gradients).  With a sketch the
draws differ between the packages, so only what the sketch does not touch
is compared there: the output, the input gradient and the biases'.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fewbit_tpu.models import MLP as JaxMLP

from fewbit_tpu_torch.models import MLP, flax_param_pairs, load_flax_params
from fewbit_tpu_torch.modules import RandomizedDense

FEATURES = (48, 40, 16)
IN = 24


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, 50, IN).astype(np.float32),
            rng.randn(2, 50, FEATURES[-1]).astype(np.float32))


def _pair(**switches):
    x, cot = _inputs()
    jmodel = JaxMLP(features=FEATURES, **switches)
    params = jmodel.init({"params": jax.random.key(0),
                          "sketch": jax.random.key(1)}, jnp.asarray(x))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    tmodel = MLP(FEATURES, device="cpu", in_features=IN, **switches)
    load_flax_params(tmodel, params)
    return jmodel, params, tmodel, x, cot


def _jax_run(jmodel, params, x, cot):
    def loss(p, xx):
        y = jmodel.apply({"params": p}, xx,
                         rngs={"sketch": jax.random.key(2)})
        return (y * cot).sum(), y

    (_, y), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                          has_aux=True)(params,
                                                        jnp.asarray(x))
    return np.asarray(y), np.asarray(gx), jax.tree_util.tree_map(np.asarray,
                                                                 gp)


def _torch_run(tmodel, x, cot):
    tx = torch.from_numpy(x).requires_grad_()
    y = tmodel(tx, torch.Generator().manual_seed(2))
    (y * torch.from_numpy(cot)).sum().backward()
    return y.detach().numpy(), tx.grad.numpy()


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("gelu_bits", [None, 3], ids=["exact", "3bit"])
def test_mlp_matches_jax(gelu_bits):
    """No sketch: output, input gradient and every parameter's gradient;
    with 3 bits the GELU backward is the few-bit one on both sides."""
    jmodel, params, tmodel, x, cot = _pair(gelu_bits=gelu_bits)
    assert len(list(tmodel.parameters())) == 2 * len(FEATURES)
    y, gx, gp = _jax_run(jmodel, params, x, cot)
    ty, tgx = _torch_run(tmodel, x, cot)
    _close(ty, y)
    _close(tgx, gx)
    n = 0
    for param, want in flax_param_pairs(tmodel, gp):
        _close(param.grad.numpy(), want)
        n += 1
    assert n == 2 * len(FEATURES)


def test_sketched_mlp_matches_jax_where_no_sketch_reaches():
    """The JAX default sketch (gaussian) in every layer: output, input
    gradient and bias gradients equal JAX's; weight gradients are finite
    estimates that differ from the exact ones."""
    jmodel, params, tmodel, x, cot = _pair(gelu_bits=3, proj_dim_ratio=0.3)
    assert all(isinstance(d, RandomizedDense) and d.matmul == "gaussian"
               for d in tmodel.dense)
    y, gx, gp = _jax_run(jmodel, params, x, cot)
    ty, tgx = _torch_run(tmodel, x, cot)
    _close(ty, y)
    _close(tgx, gx)
    for i, layer in enumerate(tmodel.dense):
        _close(layer.bias.grad.numpy(), gp[f"dense_{i}"]["bias"])
        w = layer.weight.grad.numpy()
        assert np.isfinite(w).all()
        assert not np.allclose(w, gp[f"dense_{i}"]["kernel"].T, atol=1e-3)


def test_mlp_defaults_equal_jax_and_build_on_the_card(monkeypatch):
    want = {f.name: f.default for f in dataclasses.fields(JaxMLP)
            if f.default is not dataclasses.MISSING}
    got = {k: p.default for k, p in inspect.signature(MLP).parameters.items()
           if p.default is not inspect.Parameter.empty}
    assert got["gelu_bits"] is want["gelu_bits"] is None
    assert got["proj_dim_ratio"] is want["proj_dim_ratio"] is None
    assert str(got["dtype"]).split(".")[-1] == jnp.dtype(want["dtype"]).name
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        MLP(FEATURES, in_features=IN)
