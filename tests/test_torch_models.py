"""Port parity for the whole slice: the RoBERTa training step of
``fewbit_tpu_torch`` against the JAX package on the CPU, with the same
transplanted weights and the same batch, dropout off.

Tolerances: both sides compute in f32 with different BLAS summation orders,
so values agree to a few f32 ulps per layer.  In the few-bit config the
codes of a pre-activation lying within rounding of a border may flip, which
moves a few gradient entries by a LUT step; gradients are therefore also
held by relative norm.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fewbit_tpu.models import RobertaConfig as JaxConfig
from fewbit_tpu.models import RobertaForSequenceClassification as JaxModel
from fewbit_tpu.train import TrainConfig as JaxTrainConfig
from fewbit_tpu.train.loop import classification_loss as jax_loss
from fewbit_tpu.train import create_train_state
from fewbit_tpu.train import make_train_step as jax_make_train_step
from fewbit_tpu.train import synthetic_glue as jax_synthetic_glue

from fewbit_tpu_torch.models import (RobertaConfig,
                                     RobertaForSequenceClassification,
                                     flax_param_pairs, load_flax_params)
from fewbit_tpu_torch.train import (TrainConfig, classification_loss,
                                    make_train_step, synthetic_glue)

SMALL = dict(vocab_size=1000, hidden_size=128, num_layers=2, num_heads=2,
             intermediate_size=512, max_position_embeddings=130,
             hidden_dropout=0.0, attention_dropout=0.0)
# 8 x 128 = 1024 rows: ratio 0.25 puts every projection and FFN block of
# the encoder inside the kernels' envelope (k_eff = 512); the head's 8 rows
# take the plain sketch.
FEWBIT = dict(gelu_bits=3, proj_dim_ratio=0.25, sketch="countsketch")
BS, SEQ = 8, 128


def _batch(seed=0):
    b = next(synthetic_glue(BS, SEQ, vocab_size=SMALL["vocab_size"],
                            seed=seed))
    return b


def _torch_batch(b):
    return {"input_ids": torch.from_numpy(b["input_ids"]).long(),
            "attention_mask": torch.from_numpy(b["attention_mask"]),
            "labels": torch.from_numpy(b["labels"]).long()}


def _models(fewbit: bool):
    return _models_for(FEWBIT if fewbit else {})


def _models_for(extra):
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
    loss = classification_loss(logits, tb["labels"])
    loss.backward()
    return loss.item(), logits.detach().numpy()


def _sketched(tmodel):
    """The weights whose gradient goes through a sketch."""
    out = set()
    for name, p in tmodel.named_parameters():
        if name.endswith("ffn.up_weight") or name.endswith("ffn.down_weight"):
            out.add(id(p))
        elif name.endswith(".weight") and any(
                k in name for k in ("query", "key", "value", "output.",
                                    "head_dense", "head_out")):
            out.add(id(p))
    return out


def _close_by_norm(a, b, rtol=1e-4, floor=1e-6):
    """|a - b| <= rtol |b| + floor in the 2-norm: the floor covers
    gradients that are zero up to rounding (a key bias under softmax)."""
    return np.linalg.norm(a - b) <= rtol * np.linalg.norm(b) + floor


def test_synthetic_glue_matches_jax():
    for seed in (0, 3):
        ours, ref = synthetic_glue(16, 64, seed=seed), jax_synthetic_glue(
            16, 64, seed=seed)
        for _ in range(3):
            a, b = next(ours), next(ref)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("fewbit", [False, True], ids=["vanilla", "fewbit"])
def test_load_flax_params(fewbit):
    _, params, tmodel, _ = _models(fewbit)
    n = 0
    for param, arr in flax_param_pairs(tmodel, params):
        np.testing.assert_array_equal(param.detach().numpy(), arr)
        n += 1
    assert n == len(list(tmodel.parameters()))
    if fewbit:
        assert tmodel.roberta.layers[0].ffn.up_weight.shape == (512, 128)


def test_vanilla_slice_matches_jax():
    jmodel, params, tmodel, b = _models(fewbit=False)
    jl, jlogits, jgrads = _jax_loss_grads(jmodel, params, b)
    tl, tlogits = _torch_loss_grads(tmodel, b)
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-4, atol=1e-5)
    assert abs(tl - jl) < 1e-5
    for param, want in flax_param_pairs(tmodel, jgrads):
        got = param.grad.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-3,
                                   atol=1e-3 * np.abs(want).max() + 1e-8)


def test_vanilla_adamw_steps_match_jax():
    """Parameters after 2 AdamW steps (warmup 1 step: lr 0, then 1e-3)."""
    jmodel, params, tmodel, b = _models(fewbit=False)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    state = create_train_state(jmodel, JaxTrainConfig(
        total_steps=10, learning_rate=1e-3), jb)
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray,
                                                        params))
    jstep = jax.jit(jax_make_train_step(jmodel))
    for i in range(2):
        state, _ = jstep(state, jb, jax.random.key(i))
    step = make_train_step(tmodel, TrainConfig(total_steps=10,
                                               learning_rate=1e-3))
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


def test_fewbit_slice_matches_jax(monkeypatch):
    monkeypatch.setenv("FEWBIT_TPU_NATIVE", "interpret")
    jmodel, params, tmodel, b = _models(fewbit=True)
    jl, jlogits, jgrads = _jax_loss_grads(jmodel, params, b)
    tl, tlogits = _torch_loss_grads(tmodel, b)
    # The forward is exact in both packages.
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-4, atol=1e-5)
    assert abs(tl - jl) < 1e-5
    sketched = _sketched(tmodel)
    assert len(sketched) == 2 * 6 + 2
    for param, want in flax_param_pairs(tmodel, jgrads):
        got = param.grad.numpy()
        assert got.shape == want.shape
        assert np.isfinite(got).all()
        if id(param) in sketched:
            continue
        assert _close_by_norm(got, want)
        np.testing.assert_allclose(got, want, rtol=1e-2,
                                   atol=1e-2 * np.abs(want).max() + 1e-6)


# The two few-bit FFN branches besides FewBitFFN: the fused dense + GELU
# (FusedDenseActivation, no sketch configured) and the unfused Dense ->
# few-bit GELU -> Dense with every projection sketched.
BRANCHES = {"fused_dense_act": dict(gelu_bits=3, fused_ffn=True),
            "unfused_gelu": dict(FEWBIT, fused_ffn=False)}


@pytest.mark.parametrize("extra", list(BRANCHES.values()),
                         ids=list(BRANCHES))
def test_fewbit_ffn_branches_match_jax(monkeypatch, extra):
    monkeypatch.setenv("FEWBIT_TPU_NATIVE", "interpret")
    jmodel, params, tmodel, b = _models_for(extra)
    layer = tmodel.roberta.layers[0]
    assert not hasattr(layer, "ffn")
    assert layer.fused_act == extra["fused_ffn"]
    jl, jlogits, jgrads = _jax_loss_grads(jmodel, params, b)
    tl, tlogits = _torch_loss_grads(tmodel, b)
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-4, atol=1e-5)
    assert abs(tl - jl) < 1e-5
    sketched = set()
    if extra.get("proj_dim_ratio"):
        sketched = _sketched(tmodel) | {
            id(q) for n, q in tmodel.named_parameters()
            if n.endswith("intermediate.weight")}
        assert len(sketched) == 2 * 6 + 2
    for param, want in flax_param_pairs(tmodel, jgrads):
        got = param.grad.numpy()
        assert got.shape == want.shape
        assert np.isfinite(got).all()
        if id(param) in sketched:
            continue
        assert _close_by_norm(got, want)
        np.testing.assert_allclose(got, want, rtol=1e-2,
                                   atol=1e-2 * np.abs(want).max() + 1e-6)


@pytest.mark.parametrize("scan", [True, False], ids=["scanned", "unrolled"])
def test_config_takes_scan_layers(scan):
    """``scan_layers`` is the JAX config's field: the port accepts it, its
    default is the reference's, and it changes nothing (a Python loop over
    the layers either way): the logits equal the JAX model's, whose
    parameter tree is stacked or per layer."""
    fields = JaxConfig.__dataclass_fields__
    assert RobertaConfig().scan_layers is fields["scan_layers"].default
    jmodel, params, tmodel, b = _models_for({"scan_layers": scan})
    assert tmodel.cfg.scan_layers is scan
    _, jlogits, _ = _jax_loss_grads(jmodel, params, b)
    _, tlogits = _torch_loss_grads(tmodel, b)
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-4, atol=1e-5)


def test_config_takes_tp_fields_and_refuses_tensor_parallelism():
    """``tp_axis``/``tp_size`` exist with the reference's defaults; a tp
    config builds where the JAX config's widths allow it (``tp_axis`` set
    exactly when ``tp_size > 1``, heads and FFN width divisible) and
    raises otherwise."""
    fields = JaxConfig.__dataclass_fields__
    cfg = RobertaConfig(tp_axis=None, tp_size=1)
    assert cfg.tp_axis is fields["tp_axis"].default is None
    assert cfg.tp_size == fields["tp_size"].default == 1
    assert RobertaConfig(tp_axis="model", tp_size=4).tp_size == 4
    for kw in (dict(tp_size=2), dict(tp_axis="model"),
               dict(tp_axis="model", tp_size=5)):
        with pytest.raises(ValueError):
            RobertaConfig(**kw)


@pytest.mark.parametrize("which", ["roberta", "roberta_backbone", "gpt",
                                   "gpt_backbone"])
def test_models_build_on_the_card_unless_asked(monkeypatch, which):
    """``device`` None means the card: without one the constructor raises
    and names ``device="cpu"`` (no model quietly lands on the CPU), and
    ``device="cpu"`` builds on the CPU."""
    from fewbit_tpu_torch.models import GPTConfig, GPTForCausalLM, GPTModel
    from fewbit_tpu_torch.models import RobertaModel

    tiny = dict(vocab_size=50, hidden_size=64, num_layers=1, num_heads=2,
                intermediate_size=128, max_position_embeddings=16)
    build = {"roberta": lambda **kw: RobertaForSequenceClassification(
                 RobertaConfig(**tiny), **kw),
             "roberta_backbone": lambda **kw: RobertaModel(
                 RobertaConfig(**tiny), **kw),
             "gpt": lambda **kw: GPTForCausalLM(GPTConfig(**tiny), **kw),
             "gpt_backbone": lambda **kw: GPTModel(GPTConfig(**tiny),
                                                   **kw)}[which]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build()
    model = build(device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
