"""Port parity for flash attention: the op of
``fewbit_tpu_torch.ops.flash_attention`` against the JAX library's
reference (``mha_reference_no_custom_vjp`` and its ``jax.vjp``), the
``flash_attention`` rule of ``fewbit_tpu_torch.models.flash`` against
``fewbit_tpu.models.flash``, and the flash paths of tiny GPT and RoBERTa
models against the JAX models on the CPU, where the JAX models take their
standard attention and the port the plain versions of the flash kernels.

Tolerances: the op is f32 on both sides with other summation orders, and
the port's backward recomputes P from one log-sum-exp where the library's
reference divides by l: values agree to 1e-5 of their scale (atol 1e-5
times max(1, max |reference|), rtol 1e-4).  The models use the tolerances
of ``tests/test_torch_gpt.py``: logits rtol 1e-4, atol 1e-5; loss 1e-5;
unsketched gradients rtol 1e-3 (vanilla), or by relative norm 1e-4 and
elementwise 1e-2 (few-bit, where a code within rounding of a border may
flip).  Flash and the standard path differ at padded query rows (pad to
pad against pad to real keys), which no logit, loss or gradient reads.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas.ops.tpu import flash_attention as fa

from fewbit_tpu.models import GPTConfig as JaxGPTConfig
from fewbit_tpu.models import GPTForCausalLM as JaxGPT
from fewbit_tpu.models import RobertaConfig as JaxRobertaConfig
from fewbit_tpu.models import RobertaForSequenceClassification as JaxRoberta
from fewbit_tpu.train import causal_lm_loss as jax_lm_loss
from fewbit_tpu.train.loop import classification_loss as jax_cls_loss

from fewbit_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     RobertaConfig,
                                     RobertaForSequenceClassification,
                                     flax_param_pairs, load_flax_params)
from fewbit_tpu_torch.models.flash import (FLASH_AUTO_MIN_SEQ, auto_blocks,
                                           use_flash)
from fewbit_tpu_torch.ops import kernels as K
from fewbit_tpu_torch.ops.flash_attention import (
    DEFAULT_MASK_VALUE, SegmentIds, flash_attention, flash_backward_plain,
    flash_forward_plain)
from fewbit_tpu_torch.train import (causal_lm_loss, classification_loss,
                                    synthetic_glue, synthetic_lm)

B, H, D = 2, 2, 64
SCALE = D ** -0.5


def _close(got, want, rtol=1e-4, atol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol * max(1.0, np.abs(want).max()))


def _op_inputs(s, seed, d=D):
    """q, k, v, dO ``(B, H, s, d)`` and padded segment ids ``(B, s)``."""
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(B, H, s, d).astype(np.float32)
                   for _ in range(4))
    lengths = rng.randint(s // 2, s + 1, size=B)
    ids = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    return q, k, v, do, ids


# ---------------------------------------------------------------------------
# The op.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [64, 32], ids=["d64", "d32"])
@pytest.mark.parametrize("s", [128, 100])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("seg", [False, True], ids=["noseg", "seg"])
def test_plain_matches_library_reference(s, causal, seg, d):
    """The plain forward and backward against the library's reference and
    its VJP, at every row (padded query rows included), at the head
    dimension the kernels take and at 32 (the plain versions take any)."""
    q, k, v, do, ids = _op_inputs(s, s + 2 * causal + seg, d)
    scale = d ** -0.5
    jseg = fa.SegmentIds(q=jnp.asarray(ids), kv=jnp.asarray(ids)) \
        if seg else None

    def ref(q_, k_, v_):
        return fa.mha_reference_no_custom_vjp(
            q_, k_, v_, segment_ids=jseg, causal=causal, sm_scale=scale)

    want, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    dq_want, dk_want, dv_want = vjp(jnp.asarray(do))
    _, l, m = fa.mha_reference_no_custom_vjp(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), segment_ids=jseg,
        causal=causal, sm_scale=scale, save_residuals=True)

    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    tids = torch.from_numpy(ids) if seg else None
    o, lse = flash_forward_plain(tq, tk, tv, tids, tids, causal, scale)
    _close(o, want)
    _close(lse, np.asarray(m) + np.log(np.asarray(l)))
    dq, dk, dv = flash_backward_plain(tq, tk, tv, tids, tids, o, lse, tdo,
                                      causal, scale)
    _close(dq, dq_want)
    _close(dk, dk_want)
    _close(dv, dv_want)
    # On the CPU the wrappers are the plain versions and launch nothing.
    launches = K.launch_counts()
    o2, lse2 = K.flash_forward(tq, tk, tv, tids, tids, causal, scale)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)
    di = (o * tdo).sum(-1)
    dk2, dv2 = K.flash_backward_dkv(tq, tk, tv, tids, tids, lse, tdo, di,
                                    causal, scale)
    dq2 = K.flash_backward_dq(tq, tk, tv, tids, tids, lse, tdo, di, causal,
                              scale)
    for a, b in ((dq2, dq), (dk2, dk), (dv2, dv)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert K.launch_counts() == launches


def test_mask_value_is_the_library_s():
    assert DEFAULT_MASK_VALUE == fa.DEFAULT_MASK_VALUE
    # A row whose first keys are all masked still normalises over its own
    # keys only: the finite mask value never turns into NaN.
    q, k, v, _, _ = _op_inputs(64, 1)
    ids = np.ones((B, 64), np.int32)
    ids[:, :48] = 0
    ids_t = torch.from_numpy(ids)
    o, lse = flash_forward_plain(*map(torch.from_numpy, (q, k, v)),
                                 ids_t, ids_t, True, SCALE)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()


def _model_layout(*arrays):
    """``(b, h, s, d)`` numpy arrays as the models hand them to the op:
    ``transpose(1, 2)`` views of ``(b, s, h, d)`` tensors."""
    return [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))
            .transpose(1, 2).requires_grad_() for a in arrays]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_function_matches_autograd_through_plain(causal):
    q, k, v, do, ids = _op_inputs(100, 7 + causal)
    seg = SegmentIds(torch.from_numpy(ids), torch.from_numpy(ids))
    grads = []
    for use_function in (True, False):
        tq, tk, tv = _model_layout(q, k, v)
        if use_function:
            out = flash_attention(tq, tk, tv, seg, causal=causal,
                                  sm_scale=SCALE)
        else:
            out = flash_forward_plain(tq, tk, tv, seg.q.int(), seg.kv.int(),
                                      causal, SCALE)[0]
        (out * torch.from_numpy(do)).sum().backward()
        grads.append([out.detach()] + [t.grad for t in (tq, tk, tv)])
    for got, want in zip(*grads):
        _close(got, want)


def test_function_saves_no_square_tensor():
    """The op keeps q, k, v, o, the (b, h, s) log-sum-exp and the segment
    ids: nothing of shape (s, s)."""
    s = 96
    q, k, v, _, ids = _op_inputs(s, 3)
    seg = SegmentIds(torch.from_numpy(ids), torch.from_numpy(ids))
    for use_function, want_square in ((True, False), (False, True)):
        tq, tk, tv = _model_layout(q, k, v)
        shapes = []

        def pack(t):
            shapes.append(tuple(t.shape))
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            if use_function:
                flash_attention(tq, tk, tv, seg, causal=True, sm_scale=SCALE)
            else:  # autograd through the plain forward: the hook sees it
                flash_forward_plain(tq, tk, tv, seg.q.int(), seg.kv.int(),
                                    True, SCALE)
        square = [sh for sh in shapes if sh[-2:] == (s, s)]
        assert bool(square) == want_square, shapes
        if use_function:
            assert (B, H, s) in shapes and (B, s) in shapes


# ---------------------------------------------------------------------------
# When the models take the op.
# ---------------------------------------------------------------------------


def test_use_flash_matches_jax_rule():
    """The JAX package's rule with the device type "cuda" in place of the
    backend "tpu" (tests/test_models.py::test_flash_auto_resolution); True
    takes the op on any device (its plain version on the CPU)."""
    from fewbit_tpu.models.flash import auto_blocks as jax_auto_blocks
    from fewbit_tpu.models.flash import FLASH_AUTO_MIN_SEQ as JAX_MIN_SEQ

    assert FLASH_AUTO_MIN_SEQ == JAX_MIN_SEQ == 1024
    for s in (100, 128, 192, 1024, 1100, 1536, 4096):
        assert auto_blocks(s) == jax_auto_blocks(s)
    assert use_flash(True, 128, 0.0, "cuda")
    assert use_flash(True, 4096, 0.0, "cpu")
    assert not use_flash(False, 4096, 0.0, "cuda")
    assert not use_flash(None, 4096, 0.0, "cuda")
    assert use_flash("auto", FLASH_AUTO_MIN_SEQ, 0.0, "cuda")
    assert use_flash("auto", FLASH_AUTO_MIN_SEQ, 0.0, torch.device("cuda", 0))
    assert not use_flash("auto", FLASH_AUTO_MIN_SEQ - 1, 0.0, "cuda")
    assert not use_flash("auto", FLASH_AUTO_MIN_SEQ, 0.1, "cuda")
    assert not use_flash("auto", FLASH_AUTO_MIN_SEQ, 0.0, "cpu")
    assert not use_flash("auto", 1100, 0.0, "cuda")
    # A deterministic (eval) call applies no dropout: "auto" takes flash.
    assert use_flash("auto", FLASH_AUTO_MIN_SEQ, 0.1, "cuda",
                     deterministic=True)
    with pytest.raises(ValueError):
        use_flash("always", 128, 0.0, "cuda")
    with pytest.raises(ValueError):
        use_flash("Auto", 4096, 0.0, "cpu")


def test_auto_keeps_standard_attention_outside_the_kernels_envelope(
        monkeypatch):
    """"auto" takes flash only at a head dimension F1-F3 take
    (FLASH_HEAD_DIM); True goes on to the kernel, which refuses.  The
    models hand use_flash their own head dimension."""
    from fewbit_tpu_torch.models import gpt, roberta
    from fewbit_tpu_torch.ops.kernels import FLASH_HEAD_DIM

    assert FLASH_HEAD_DIM == 64
    s = FLASH_AUTO_MIN_SEQ
    assert use_flash("auto", s, 0.0, "cuda", head_dim=FLASH_HEAD_DIM)
    assert use_flash("auto", s, 0.0, "cuda", head_dim=None)
    for d in (32, 128, 96):
        assert not use_flash("auto", s, 0.0, "cuda", head_dim=d)
        assert not use_flash("auto", s, 0.1, "cuda", True, d)
        assert use_flash(True, s, 0.0, "cuda", head_dim=d)
    # Both models pass their head dimension: hidden 128 over 4 heads is 32.
    seen = []

    def spy(setting, seq_len, dropout, device, deterministic=False,
            head_dim=None):
        seen.append(head_dim)
        return False

    ids = torch.zeros(1, 8, dtype=torch.long)
    small = dict(vocab_size=50, hidden_size=128, num_layers=1, num_heads=4,
                 intermediate_size=128, flash_attention="auto")
    for mod, model in (
            (roberta, RobertaForSequenceClassification(
                RobertaConfig(**small), device="cpu")),
            (gpt, GPTForCausalLM(GPTConfig(**small), device="cpu"))):
        assert mod.use_flash is use_flash
        monkeypatch.setattr(mod, "use_flash", spy)
        with torch.no_grad():
            model(ids, torch.ones_like(ids))
    assert seen == [32, 32]


@pytest.mark.parametrize("cls", [RobertaConfig, GPTConfig])
def test_configs_take_the_flash_fields(cls):
    """Both configs take flash_attention and flash_blocks, and validate them
    as the JAX configs do."""
    cls(flash_attention="auto")  # default dropout > 0: fine
    cls(flash_attention=True, attention_dropout=0.0, flash_blocks=(256, 256))
    assert cls().flash_blocks is None and cls().flash_attention is False
    with pytest.raises(ValueError, match="dropout"):
        cls(flash_attention=True)
    with pytest.raises(ValueError, match="flash_attention"):
        cls(flash_attention="Auto", attention_dropout=0.0)


# ---------------------------------------------------------------------------
# The models' flash paths against the JAX models.
# ---------------------------------------------------------------------------

SMALL = dict(vocab_size=1000, hidden_size=128, num_layers=2, num_heads=2,
             intermediate_size=512, hidden_dropout=0.0,
             attention_dropout=0.0, flash_attention=True)
FEWBIT = dict(gelu_bits=3, proj_dim_ratio=0.25, sketch="countsketch")
BS, SEQ = 8, 128


def _transplant(jmodel, tmodel, b):
    params = jmodel.init({"params": jax.random.key(0),
                          "sketch": jax.random.key(1)},
                         jnp.asarray(b["input_ids"]),
                         jnp.asarray(b["attention_mask"]),
                         deterministic=True)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    load_flax_params(tmodel, params)
    return params


def _jax_loss_grads(jmodel, params, b, loss):
    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(b["input_ids"]),
                              jnp.asarray(b["attention_mask"]),
                              deterministic=True,
                              rngs={"sketch": jax.random.key(2)})
        return loss(logits, jnp.asarray(b["labels"])), logits

    (value, logits), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    return (float(value), np.asarray(logits),
            jax.tree_util.tree_map(np.asarray, grads))


def _torch_loss_grads(tmodel, b, loss):
    """Loss and logits of one forward and backward; asserts that the
    forward saved no (b, h, seq, seq) tensor, so it went through the flash
    op."""
    tmodel.zero_grad(set_to_none=True)
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        logits = tmodel(torch.from_numpy(b["input_ids"]).long(),
                        torch.from_numpy(b["attention_mask"]),
                        sketch_generator=torch.Generator().manual_seed(2))
    assert not [s for s in shapes if len(s) == 4 and s[-2:] == (SEQ, SEQ)]
    value = loss(logits, torch.from_numpy(b["labels"]).long())
    value.backward()
    return value.item(), logits.detach().numpy()


def _check_grads(tmodel, jgrads, fewbit):
    sketched = {id(p) for name, p in tmodel.named_parameters()
                if name.endswith("weight") and any(
                    k in name for k in ("query", "key", "value", "output.",
                                        "intermediate", "ffn_output",
                                        "ffn.up", "ffn.down", "head_dense",
                                        "head_out"))} if fewbit else set()
    # The key bias adds one constant per query row to the logits, which the
    # softmax ignores: its gradient is rounding noise on both sides.
    key_bias = {id(p) for name, p in tmodel.named_parameters()
                if name.endswith("key.bias")}
    for param, want in flax_param_pairs(tmodel, jgrads):
        got = param.grad.numpy()
        assert got.shape == want.shape and np.isfinite(got).all()
        if id(param) in key_bias:
            assert np.abs(got).max() < 1e-6 and np.abs(want).max() < 1e-6
            continue
        if id(param) in sketched:
            continue
        if fewbit:
            assert np.linalg.norm(got - want) <= \
                1e-4 * np.linalg.norm(want) + 1e-6
            np.testing.assert_allclose(got, want, rtol=1e-2,
                                       atol=1e-2 * np.abs(want).max() + 1e-6)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-3,
                                       atol=1e-3 * np.abs(want).max() + 1e-8)


@pytest.mark.parametrize("fewbit", [False, True], ids=["vanilla", "fewbit"])
def test_gpt_flash_matches_jax(monkeypatch, fewbit):
    """Causal flash with segment ids from the attention mask.  The batch
    seed is one where no few-bit code lies within rounding of a border, so
    that the attention's own rounding flips none (one flip moves the
    gradients by about 2e-4 of their norm)."""
    monkeypatch.setenv("FEWBIT_TPU_NATIVE", "interpret")
    extra = FEWBIT if fewbit else {}
    cfg = dict(SMALL, max_position_embeddings=SEQ, **extra)
    # Unrolled layers, as in tests/test_torch_gpt.py's few-bit test.
    jmodel = JaxGPT(JaxGPTConfig(**cfg, scan_layers=False))
    tmodel = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    b = next(synthetic_lm(BS, SEQ, vocab_size=SMALL["vocab_size"], seed=2))
    params = _transplant(jmodel, tmodel, b)
    jl, jlogits, jgrads = _jax_loss_grads(jmodel, params, b, jax_lm_loss)
    tl, tlogits = _torch_loss_grads(tmodel, b, causal_lm_loss)
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-4, atol=1e-5)
    assert abs(tl - jl) < 1e-5
    _check_grads(tmodel, jgrads, fewbit)


@pytest.mark.parametrize("fewbit", [False, True], ids=["vanilla", "fewbit"])
def test_roberta_flash_matches_jax_on_padded_batch(monkeypatch, fewbit):
    """Non-causal flash with segment ids from the padding mask."""
    monkeypatch.setenv("FEWBIT_TPU_NATIVE", "interpret")
    extra = FEWBIT if fewbit else {}
    cfg = dict(SMALL, max_position_embeddings=SEQ + 2, **extra)
    jmodel = JaxRoberta(JaxRobertaConfig(**cfg))
    tmodel = RobertaForSequenceClassification(RobertaConfig(**cfg),
                                              device="cpu")
    b = next(synthetic_glue(BS, SEQ, vocab_size=SMALL["vocab_size"], seed=1))
    assert (b["attention_mask"] == 0).any()  # padded rows are exercised
    params = _transplant(jmodel, tmodel, b)
    jl, jlogits, jgrads = _jax_loss_grads(jmodel, params, b, jax_cls_loss)
    tl, tlogits = _torch_loss_grads(tmodel, b, classification_loss)
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-4, atol=1e-5)
    assert abs(tl - jl) < 1e-5
    _check_grads(tmodel, jgrads, fewbit)
