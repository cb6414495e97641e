"""Port parity at the reference's default few-bit config and for the rest
of the training loop: a tiny ``RobertaConfig(gelu_bits=3,
proj_dim_ratio=0.2)`` (sketch and FFN structure left at their defaults:
gaussian everywhere, ``FusedDenseActivation`` for the FFN) against the JAX
model with the same transplanted weights, one training step of it, the
eval step against the JAX one, and a checkpoint round trip.

Tolerances: f32 on both sides with other summation orders (logits rtol
1e-4, atol 1e-5; gradients 1e-2 of the largest entry and 1e-4 in relative
2-norm, as ``tests/test_torch_models.py``: a few-bit code within rounding
of a border may flip).  The sketched kernels' gradients are estimates from
other draws and are not compared.  The checkpoint round trip is exact.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from fewbit_tpu.models import RobertaConfig as JaxConfig
from fewbit_tpu.models import RobertaForSequenceClassification as JaxModel
from fewbit_tpu.train import TrainConfig as JaxTrainConfig
from fewbit_tpu.train import create_train_state
from fewbit_tpu.train.loop import classification_loss as jax_loss
from fewbit_tpu.train.loop import make_eval_step as jax_make_eval_step
from fewbit_tpu.train.loop import make_train_step as jax_make_train_step

from fewbit_tpu_torch.models import (RobertaConfig,
                                     RobertaForSequenceClassification,
                                     flax_param_pairs, load_flax_params)
from fewbit_tpu_torch.modules import FusedDenseActivation, RandomizedDense
from fewbit_tpu_torch.train import (TrainConfig, classification_loss,
                                    make_eval_step, make_train_step,
                                    restore_checkpoint, save_checkpoint,
                                    synthetic_glue)
from fewbit_tpu_torch.train.loop import clip_by_global_norm_

SMALL = dict(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=2,
             intermediate_size=128, max_position_embeddings=66,
             hidden_dropout=0.0, attention_dropout=0.0)
DEFAULT = dict(gelu_bits=3, proj_dim_ratio=0.2)
BS, SEQ = 8, 64


def _batch(seed=0):
    return next(synthetic_glue(BS, SEQ, vocab_size=SMALL["vocab_size"],
                               seed=seed))


def _torch_batch(b):
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


def _models(**extra):
    jmodel = JaxModel(JaxConfig(**SMALL, **extra))
    b = _batch()
    params = jmodel.init({"params": jax.random.key(0),
                          "sketch": jax.random.key(1)},
                         jnp.asarray(b["input_ids"]),
                         jnp.asarray(b["attention_mask"]),
                         deterministic=True)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tmodel = RobertaForSequenceClassification(
        RobertaConfig(**SMALL, **extra), device="cpu")
    load_flax_params(tmodel, params)
    return jmodel, params, tmodel, b


def test_default_config_matches_jax_and_trains():
    """F-1: the reference's default few-bit config runs in the port; its
    logits and every gradient that no sketch estimates equal JAX's."""
    jmodel, params, tmodel, b = _models(**DEFAULT)
    assert tmodel.cfg.sketch == "gaussian" and tmodel.cfg.fused_ffn
    layer = tmodel.roberta.layers[0]
    assert isinstance(layer.intermediate, FusedDenseActivation)
    assert layer.intermediate.matmul == "gaussian"
    assert layer.attention.query.matmul == "gaussian"

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(b["input_ids"]),
                              jnp.asarray(b["attention_mask"]),
                              deterministic=True,
                              rngs={"sketch": jax.random.key(2)})
        return jax_loss(logits, jnp.asarray(b["labels"])), logits

    (jl, jlogits), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
    tb = _torch_batch(b)
    logits = tmodel(tb["input_ids"], tb["attention_mask"],
                    sketch_generator=torch.Generator().manual_seed(2))
    loss = classification_loss(logits, tb["labels"])
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-5)
    assert abs(loss.item() - float(jl)) < 1e-5
    sketched = {id(m.weight) for m in tmodel.modules()
                if isinstance(m, (RandomizedDense, FusedDenseActivation))}
    assert len(sketched) == 6 * SMALL["num_layers"] + 2
    compared = 0
    for param, want in flax_param_pairs(tmodel, jgrads):
        got = param.grad.numpy()
        assert got.shape == want.shape and np.isfinite(got).all()
        if id(param) in sketched:
            continue
        assert (np.linalg.norm(got - want)
                <= 1e-4 * np.linalg.norm(want) + 1e-6)
        np.testing.assert_allclose(got, want, rtol=1e-2,
                                   atol=1e-2 * np.abs(want).max() + 1e-6)
        compared += 1
    assert compared == len(list(tmodel.parameters())) - len(sketched)

    step = make_train_step(tmodel, TrainConfig(total_steps=10,
                                               learning_rate=1e-3))
    before = {n: p.detach().clone() for n, p in tmodel.named_parameters()}
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):  # the first step's learning rate is 0
        assert np.isfinite(step(tb, gen)["loss"].item())
    moved = [n for n, p in tmodel.named_parameters()
             if not torch.equal(p, before[n])]
    assert len(moved) == len(before)


def test_eval_step_matches_jax(monkeypatch):
    """The same weights and a held batch: accuracy and loss equal JAX's
    eval step's, under the strict sketch mode (no fallback key taken)."""
    monkeypatch.setenv("FEWBIT_TPU_STRICT_SKETCH", "1")
    jmodel, params, tmodel, _ = _models(**DEFAULT)
    held = _batch(seed=4)
    jb = {k: jnp.asarray(v) for k, v in held.items()}
    state = create_train_state(jmodel, JaxTrainConfig(total_steps=10), jb)
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    want = jax_make_eval_step(jmodel)(state, jb)
    got = make_eval_step(tmodel)(_torch_batch(held))
    assert set(got) == {"accuracy", "loss"}
    assert got["accuracy"].item() == float(want["accuracy"])
    assert abs(got["loss"].item() - float(want["loss"])) < 1e-5
    assert not any(p.grad is not None for p in tmodel.parameters())


def test_checkpoint_round_trip_resumes_exactly(tmp_path):
    """Save after 2 steps, restore into a fresh model and step: steps 3
    and 4 on the same batches and generator give the uninterrupted run's
    losses to the bit (step 4 reads the restored optimizer state)."""
    cfg = RobertaConfig(**SMALL, **DEFAULT, num_labels=3)
    batches = [_torch_batch(_batch(seed=s)) for s in range(4)]

    def fresh():
        model = RobertaForSequenceClassification(
            cfg, device="cpu", generator=torch.Generator().manual_seed(1))
        return model, make_train_step(model, TrainConfig(
            total_steps=10, learning_rate=1e-3))

    model, step = fresh()
    gen = torch.Generator().manual_seed(7)
    losses = []
    for i, batch in enumerate(batches):
        if i == 2:
            save_checkpoint(tmp_path / "ckpt.pt", model, step)
            state = gen.get_state()
        losses.append(step(batch, gen)["loss"].item())
    model2, step2 = fresh()
    assert restore_checkpoint(tmp_path / "ckpt.pt", model2, step2) == 2
    gen2 = torch.Generator()
    gen2.set_state(state)
    resumed = [step2(b, gen2)["loss"].item() for b in batches[2:]]
    assert resumed == losses[2:]
    for (n, p), (_, q) in zip(model.named_parameters(),
                              model2.named_parameters()):
        assert torch.equal(p, q), n


@pytest.mark.parametrize("where", ["above", "below"])
def test_clip_by_global_norm_matches_optax(where):
    """F-5: the port's clip scales by max_norm / norm where the global norm
    reaches the bound, as ``optax.clip_by_global_norm`` does, with no
    epsilon (``clip_grad_norm_``'s max_norm / (norm + 1e-6) is 5% off at
    this norm of 2e-5)."""
    rng = np.random.RandomState(3)
    grads = [rng.randn(*s).astype(np.float32) for s in ((7, 5), (5,), (3,))]
    norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads))
    grads = [g * np.float32(2e-5 / norm) for g in grads]
    max_norm = 1e-5 if where == "above" else 1e-4
    tx = optax.clip_by_global_norm(max_norm)
    want, _ = tx.update([jnp.asarray(g) for g in grads], tx.init(grads))
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    got = clip_by_global_norm_(params, max_norm)
    assert abs(got.item() - 2e-5) < 1e-10
    for p, w in zip(params, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0)
    scale = 0.5 if where == "above" else 1.0
    np.testing.assert_allclose(params[0].grad.numpy(), grads[0] * scale,
                               rtol=1e-6)


@pytest.mark.parametrize("where", ["above", "below"])
def test_train_step_with_max_grad_norm_matches_jax(where):
    """F-5: two steps of the exact tiny model with ``max_grad_norm`` set,
    once below the gradient's norm (clipped) and once above it, give the
    JAX step's parameters; the step reports the norm its clip saw.  Adam's
    eps is 1 so that the update follows the clipped gradient's scale (with
    eps 1e-6 Adam divides it out); the first step's learning rate is 0, so
    the second step's update is compared."""
    jmodel, params, tmodel, b = _models()
    max_norm = 1e-3 if where == "above" else 1e3
    common = dict(total_steps=4, learning_rate=1e-2, eps=1.0,
                  max_grad_norm=max_norm)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    state = create_train_state(jmodel, JaxTrainConfig(**common), jb)
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
    jstep = jax.jit(jax_make_train_step(jmodel))
    step = make_train_step(tmodel, TrainConfig(**common))
    gen = torch.Generator().manual_seed(0)
    before = {n: p.detach().clone() for n, p in tmodel.named_parameters()}
    for i in range(2):
        state, metrics = jstep(state, jb, jax.random.key(i))
        out = step(_torch_batch(b), gen)
        assert abs(out["loss"].item() - float(metrics["loss"])) < 1e-5
        # The norm the step's clip saw, before clipping.
        assert (out["grad_norm"].item() > max_norm) == (where == "above")
    moved = 0
    for param, want in flax_param_pairs(tmodel, jax.tree_util.tree_map(
            np.asarray, state.params)):
        np.testing.assert_allclose(param.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-7)
    for n, p in tmodel.named_parameters():
        moved += int(not torch.equal(p, before[n]))
    assert moved == len(before)
