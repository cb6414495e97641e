"""Port parity for the GPT slice: the causal-LM training step of
``fewbit_tpu_torch`` against the JAX package on the CPU, with the same
transplanted weights and the same batch, dropout off.  Tiny GPT: vocab
1000, hidden 128, 2 layers, 2 heads, FFN 512, bs 8, seq 128.

Tolerances: both sides compute in f32 with different BLAS summation orders,
so values agree to a few f32 ulps per layer (logits rtol 1e-4, atol 1e-5;
loss 1e-5).  In the few-bit config the codes of a pre-activation within
rounding of a border may flip and the Pallas GELU uses a polynomial erf,
which moves a few gradient entries; unsketched gradients are therefore
held by relative norm (1e-4) and elementwise at 1e-2.  Sketched weight
gradients use each package's own random signs and are not compared here
(``tests/test_torch_fused.py`` compares them under shared signs).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fewbit_tpu.models import GPTConfig as JaxConfig
from fewbit_tpu.models import GPTForCausalLM as JaxModel
from fewbit_tpu.train import TrainConfig as JaxTrainConfig
from fewbit_tpu.train import causal_lm_loss as jax_loss
from fewbit_tpu.train import create_train_state
from fewbit_tpu.train import make_train_step as jax_make_train_step
from fewbit_tpu.train import synthetic_lm as jax_synthetic_lm

from fewbit_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     flax_param_pairs, load_flax_params)
from fewbit_tpu_torch.train import (TrainConfig, causal_lm_loss,
                                    make_train_step, synthetic_lm)

SMALL = dict(vocab_size=1000, hidden_size=128, num_layers=2, num_heads=2,
             intermediate_size=512, max_position_embeddings=128,
             hidden_dropout=0.0, attention_dropout=0.0)
# 8 x 128 = 1024 rows: ratio 0.25 puts the attention projections and the
# FFN down projection inside kernel 1's envelope (k_eff = 512), and the FFN
# up projection + GELU on kernel 6 with the plain sketch (k_eff = 256).
FEWBIT = dict(gelu_bits=3, proj_dim_ratio=0.25, sketch="countsketch")
BS, SEQ = 8, 128
CONFIGS = {"vanilla": {}, "fewbit": FEWBIT, "untied": dict(tie_lm_head=False)}


def _batch(seed=0):
    return next(synthetic_lm(BS, SEQ, vocab_size=SMALL["vocab_size"],
                             seed=seed))


def _torch_batch(b):
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


def _models(extra, scan_layers=True):
    jmodel = JaxModel(JaxConfig(**SMALL, **extra, scan_layers=scan_layers))
    b = _batch()
    params = jmodel.init({"params": jax.random.key(0),
                          "sketch": jax.random.key(1)},
                         jnp.asarray(b["input_ids"]),
                         jnp.asarray(b["attention_mask"]),
                         deterministic=True)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tmodel = GPTForCausalLM(GPTConfig(**SMALL, **extra), device="cpu")
    load_flax_params(tmodel, params)
    return jmodel, params, tmodel, b


def _jax_loss_grads(jmodel, params, b):
    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(b["input_ids"]),
                              jnp.asarray(b["attention_mask"]),
                              deterministic=True,
                              rngs={"sketch": jax.random.key(2)})
        return jax_loss(logits, jnp.asarray(b["labels"])), logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    return (float(loss), np.asarray(logits),
            jax.tree_util.tree_map(np.asarray, grads))


def _torch_loss_grads(tmodel, b):
    tb = _torch_batch(b)
    tmodel.zero_grad(set_to_none=True)
    logits = tmodel(tb["input_ids"], tb["attention_mask"],
                    sketch_generator=torch.Generator().manual_seed(2))
    loss = causal_lm_loss(logits, tb["labels"])
    loss.backward()
    return loss.item(), logits.detach().numpy()


def _close_by_norm(a, b, rtol=1e-4, floor=1e-6):
    return np.linalg.norm(a - b) <= rtol * np.linalg.norm(b) + floor


def test_synthetic_lm_matches_jax():
    for seed in (0, 5):
        ours, ref = synthetic_lm(4, 32, vocab_size=500, seed=seed), \
            jax_synthetic_lm(4, 32, vocab_size=500, seed=seed)
        for _ in range(3):
            a, b = next(ours), next(ref)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                assert a[k].tobytes() == b[k].tobytes()


def test_causal_lm_loss_masks_like_jax():
    rng = np.random.RandomState(0)
    logits = rng.randn(3, 9, 17).astype(np.float32)
    labels = rng.randint(0, 17, (3, 9)).astype(np.int32)
    labels[:, -1] = -100
    labels[1, :4] = -1
    got = causal_lm_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    want = float(jax_loss(jnp.asarray(logits), jnp.asarray(labels)))
    assert abs(got.item() - want) < 1e-5
    # Masked positions do not count, whatever their logits.
    logits[labels < 0] += 100.0
    again = causal_lm_loss(torch.from_numpy(logits),
                           torch.from_numpy(labels))
    assert abs(again.item() - got.item()) < 1e-6
    none = causal_lm_loss(torch.zeros(1, 2, 5), torch.full((1, 2), -100))
    assert none.item() == 0.0


@pytest.mark.parametrize("scan", [True, False], ids=["scanned", "unrolled"])
@pytest.mark.parametrize("extra", list(CONFIGS.values()), ids=list(CONFIGS))
def test_load_flax_params(extra, scan):
    """Every parameter is filled, from scanned or unrolled trees.  The
    slice tests below read gradient trees through the same pairs."""
    _, params, tmodel, _ = _models(extra, scan)
    n = 0
    for param, arr in flax_param_pairs(tmodel, params):
        np.testing.assert_array_equal(param.detach().numpy(), arr)
        n += 1
    assert n == len(list(tmodel.parameters()))


@pytest.mark.parametrize("extra", [{}, dict(tie_lm_head=False)],
                         ids=["tied", "untied"])
def test_vanilla_slice_matches_jax(extra):
    jmodel, params, tmodel, b = _models(extra)
    jl, jlogits, jgrads = _jax_loss_grads(jmodel, params, b)
    tl, tlogits = _torch_loss_grads(tmodel, b)
    assert tlogits.shape == (BS, SEQ, SMALL["vocab_size"])
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-4, atol=1e-5)
    assert abs(tl - jl) < 1e-5
    for param, want in flax_param_pairs(tmodel, jgrads):
        got = param.grad.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-3,
                                   atol=1e-3 * np.abs(want).max() + 1e-8)


def test_fewbit_slice_matches_jax(monkeypatch):
    _check_fewbit_slice(monkeypatch, FEWBIT)


@pytest.mark.parametrize("sketch", ["gaussian", "srht"])
def test_fewbit_slice_sketch_kinds_match_jax(monkeypatch, sketch):
    """The few-bit slice with the gaussian sketch and a structured one
    (srht) in place of the default countsketch: no kernel 1, and every
    sketch of the kind's own draws; logits, loss and every unsketched
    gradient as above."""
    _check_fewbit_slice(monkeypatch, {**FEWBIT, "sketch": sketch})


def _check_fewbit_slice(monkeypatch, extra):
    monkeypatch.setenv("FEWBIT_TPU_NATIVE", "interpret")
    # Unrolled layers: XLA compiles a scanned body with other fusions, and
    # activations a few ulps apart flip a code lying within 1e-6 of a
    # border more often (one flip moves a bias gradient by ~5e-4 of its
    # norm).  The transplant of scanned trees is tested above.
    jmodel, params, tmodel, b = _models(extra, scan_layers=False)
    jl, jlogits, jgrads = _jax_loss_grads(jmodel, params, b)
    tl, tlogits = _torch_loss_grads(tmodel, b)
    # The forward is exact in both packages.
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-4, atol=1e-5)
    assert abs(tl - jl) < 1e-5
    sketched = {id(p) for name, p in tmodel.named_parameters()
                if name.endswith(".weight") and any(
                    k in name for k in ("query", "key", "value", "output.",
                                        "intermediate", "ffn_output"))}
    assert len(sketched) == 2 * 6
    for param, want in flax_param_pairs(tmodel, jgrads):
        got = param.grad.numpy()
        assert got.shape == want.shape
        assert np.isfinite(got).all()
        if id(param) in sketched:
            continue
        assert _close_by_norm(got, want)
        np.testing.assert_allclose(got, want, rtol=1e-2,
                                   atol=1e-2 * np.abs(want).max() + 1e-6)


def test_causality():
    """Logits at position t do not depend on tokens after t."""
    tmodel = GPTForCausalLM(GPTConfig(**SMALL), device="cpu",
                            generator=torch.Generator().manual_seed(0))
    ids = torch.from_numpy(_batch()["input_ids"]).long()
    with torch.no_grad():
        base = tmodel(ids)
        later = ids.clone()
        later[:, 60:] = (later[:, 60:] + 17) % SMALL["vocab_size"]
        perturbed = tmodel(later)
    torch.testing.assert_close(base[:, :60], perturbed[:, :60], rtol=0,
                               atol=1e-5)
    assert not torch.allclose(base[:, 60:], perturbed[:, 60:])


def test_config_guards():
    # flash_attention=True builds and runs (the flash op's plain version on
    # the CPU), and agrees with the standard path.
    ids = torch.from_numpy(_batch()["input_ids"][:2, :40]).long()
    outs = []
    for flash in (True, False):
        model = GPTForCausalLM(
            GPTConfig(**SMALL, flash_attention=flash), device="cpu",
            generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            outs.append(model(ids, torch.ones_like(ids)))
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="dropout"):
        GPTConfig(flash_attention=True)
    with pytest.raises(ValueError, match="flash_attention"):
        GPTConfig(flash_attention="Auto")
    model = GPTForCausalLM(GPTConfig(**{**SMALL, "max_position_embeddings":
                                        16}, flash_attention="auto"),
                           device="cpu")
    with pytest.raises(ValueError, match="max_position_embeddings"):
        model(torch.zeros(1, 17, dtype=torch.long))


def test_vanilla_adamw_steps_match_jax():
    """Parameters after 2 AdamW steps (warmup 1 step: lr 0, then 1e-3)."""
    jmodel, params, tmodel, b = _models({})
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    state = create_train_state(jmodel, JaxTrainConfig(
        total_steps=10, learning_rate=1e-3), jb)
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray,
                                                        params))
    jstep = jax.jit(jax_make_train_step(jmodel, loss_fn=jax_loss))
    for i in range(2):
        state, _ = jstep(state, jb, jax.random.key(i))
    step = make_train_step(tmodel, TrainConfig(total_steps=10,
                                               learning_rate=1e-3),
                           loss_fn=causal_lm_loss)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        step(_torch_batch(b), gen)
    # Adam normalises each update to about lr = 1e-3 per entry; entries
    # whose tiny gradients differ in the last f32 bits may move by a
    # fraction of that.
    for param, want in flax_param_pairs(
            tmodel, jax.tree_util.tree_map(np.asarray, state.params)):
        np.testing.assert_allclose(param.detach().numpy(), want, rtol=0,
                                   atol=2e-4)


@pytest.mark.parametrize("scan", [True, False], ids=["scanned", "unrolled"])
def test_config_takes_scan_layers(scan):
    """``scan_layers`` is the JAX config's field: accepted, the reference's
    default, and without effect on the port's Python loop: the logits equal
    the JAX model's under either setting."""
    fields = JaxConfig.__dataclass_fields__
    assert GPTConfig().scan_layers is fields["scan_layers"].default
    jmodel, params, _, b = _models({}, scan)
    tmodel = GPTForCausalLM(GPTConfig(**SMALL, scan_layers=scan),
                            device="cpu")
    assert tmodel.cfg.scan_layers is scan
    load_flax_params(tmodel, params)
    _, jlogits, _ = _jax_loss_grads(jmodel, params, b)
    _, tlogits = _torch_loss_grads(tmodel, b)
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-4, atol=1e-5)


def test_config_takes_tp_fields_and_refuses_tensor_parallelism():
    fields = JaxConfig.__dataclass_fields__
    cfg = GPTConfig(tp_axis=None, tp_size=1)
    assert cfg.tp_axis is fields["tp_axis"].default is None
    assert cfg.tp_size == fields["tp_size"].default == 1
    assert GPTConfig(tp_axis="model", tp_size=2).tp_size == 2
    for kw in (dict(tp_size=2), dict(tp_axis="model"),
               dict(tp_axis="model", tp_size=5)):
        with pytest.raises(ValueError):
            GPTConfig(**kw)
