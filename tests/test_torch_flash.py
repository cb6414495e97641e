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


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch while this module runs: its small
    models run many small ops, whose parallel regions stall when the test
    workers share the cores (the module took 1272 s under six workers with
    torch's default threads, about 220 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


@pytest.mark.parametrize("d", [64, 32, 128], ids=["d64", "d32", "d128"])
@pytest.mark.parametrize("s", [128, 100])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("seg", [False, True], ids=["noseg", "seg"])
def test_plain_matches_library_reference(s, causal, seg, d):
    """The plain forward and backward against the library's reference and
    its VJP, at every row (padded query rows included), at the head
    dimensions the kernels take (the plain versions take any)."""
    _plain_against_library(s, causal, seg, d)


# The other instantiations, and two head dimensions below theirs, which the
# wrappers copy into zero-padded operands: 20 (the instantiation at 32) and
# 40 (at 48).  One sequence length and mask each.
OTHER_HEAD_DIMS = [(16, 128, True, True), (48, 100, False, True),
                   (80, 100, True, True), (96, 128, False, False),
                   (112, 100, True, False), (20, 100, True, True),
                   (40, 128, False, True)]


@pytest.mark.parametrize("d,s,causal,seg", OTHER_HEAD_DIMS,
                         ids=[f"d{c[0]}" for c in OTHER_HEAD_DIMS])
def test_plain_matches_library_reference_at_every_head_dim(d, s, causal,
                                                           seg):
    """The same at head dimensions 16, 48, 80, 96 and 112 (the other
    instantiations of F1-F3) and at 20 and 40, which run on the
    instantiations at 32 and 48 with zeros past d."""
    _plain_against_library(s, causal, seg, d)


@pytest.mark.parametrize("d", [256, 384], ids=["d256", "d384"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("seg", [False, True], ids=["noseg", "seg"])
def test_plain_matches_library_reference_at_wide_head_dims(causal, seg, d):
    """The same at head dimensions 256 (Pythia-1B's heads) and 384, which
    the wide kernels take on the card as chunks of 128 columns."""
    _plain_against_library(100, causal, seg, d)


def _plain_against_library(s, causal, seg, d):
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
    (FLASH_HEAD_DIMS: every d from 1 to 128 and every multiple of 128
    above, as JAX's TPU kernels take them; up to 128 each runs on the
    instantiation at the next multiple of 16, above on the wide kernels),
    on a CUDA device only; at any other True goes on to the kernel, which
    refuses with the head dimension in its message.  The models hand
    use_flash their own head dimension."""
    from fewbit_tpu_torch.models import gpt, roberta
    from fewbit_tpu_torch.ops.kernels import (FLASH_HEAD_DIMS,
                                              FLASH_INSTANCES,
                                              flash_instance)

    assert all(d in FLASH_HEAD_DIMS for d in range(1, 129))
    assert all(d in FLASH_HEAD_DIMS for d in (256, 384, 512, 1280))
    assert FLASH_INSTANCES == (16, 32, 48, 64, 80, 96, 112, 128)
    assert [flash_instance(d) for d in (1, 16, 17, 20, 40, 80, 127)] == [
        16, 16, 32, 32, 48, 80, 128]
    assert [flash_instance(d) for d in (256, 384, 512)] == [256, 384, 512]
    s = FLASH_AUTO_MIN_SEQ
    assert use_flash("auto", s, 0.0, "cuda", head_dim=None)
    for d in (*range(1, 129), 256, 384, 512):
        assert use_flash("auto", s, 0.0, "cuda", head_dim=d)
        assert use_flash("auto", s, 0.1, "cuda", True, d)
        assert not use_flash("auto", s, 0.0, "cpu", head_dim=d)
        assert not use_flash("auto", s, 0.1, "cuda", head_dim=d)
        assert not use_flash("auto", s - 1, 0.0, "cuda", head_dim=d)
    refused = (129, 144, 192, 200, 255, 257)
    for d in (0, *refused):
        assert d not in FLASH_HEAD_DIMS
        with pytest.raises(ValueError, match=f"head dimension {d}"):
            flash_instance(d)
    for d in refused:
        assert not use_flash("auto", s, 0.0, "cuda", head_dim=d)
        assert not use_flash("auto", s, 0.1, "cuda", True, d)
        assert use_flash(True, s, 0.0, "cuda", head_dim=d)
        # The kernel's envelope refuses it (checked before any device is
        # touched, so a CPU tensor posing as CUDA is enough here).
        q = torch.zeros(1, 1, 8, d)
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
        with pytest.raises(ValueError, match=f"head dimension {d}"):
            K._flash_checks(q, q, q, None, None)
        monkeypatch.undo()
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


def _jax_step(jmodel, loss, capture=None):
    """JAX's ``(params, batch) -> (loss, logits, grads)`` as numpy, jitted
    once for every batch of one shape; with ``capture``, a module name, also
    that module's output in each layer (``layer_i``), in layer order."""
    def loss_fn(p, ids, mask, labels):
        logits, state = jmodel.apply(
            {"params": p}, ids, mask, deterministic=True,
            rngs={"sketch": jax.random.key(2)},
            capture_intermediates=lambda m, _: m.name == capture,
            mutable=["intermediates"])
        return loss(logits, labels), (logits, state["intermediates"])

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

    def run(params, b):
        (value, (logits, seen)), grads = step(params, *(
            jnp.asarray(b[k]) for k in ("input_ids", "attention_mask",
                                        "labels")))
        out = (float(value), np.asarray(logits),
               jax.tree_util.tree_map(np.asarray, grads))
        if capture is None:
            return out
        layers = next(iter(seen.values()))
        return out + ([np.asarray(layers[f"layer_{i}"][capture]["__call__"]
                                  [0]) for i in range(len(layers))],)

    return run


def _jax_loss_grads(jmodel, params, b, loss):
    return _jax_step(jmodel, loss)(params, b)


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
    seq = b["input_ids"].shape[1]
    assert not [s for s in shapes if len(s) == 4 and s[-2:] == (seq, seq)]
    value = loss(logits, torch.from_numpy(b["labels"]).long())
    value.backward()
    return value.item(), logits.detach().numpy()


def _compared(tmodel, jgrads, fewbit):
    """``(param, JAX's gradient)`` of every parameter whose gradient is
    held to JAX's: all but few-bit's sketched weights (each package draws
    its own sketch) and the key bias, whose gradient is rounding noise on
    both sides (it adds one constant per query row to the logits, which the
    softmax ignores; checked to be below 1e-6 here)."""
    sketched = {id(p) for name, p in tmodel.named_parameters()
                if name.endswith("weight") and any(
                    k in name for k in ("query", "key", "value", "output.",
                                        "intermediate", "ffn_output",
                                        "ffn.up", "ffn.down", "head_dense",
                                        "head_out"))} if fewbit else set()
    key_bias = {id(p) for name, p in tmodel.named_parameters()
                if name.endswith("key.bias")}
    out = []
    for param, want in flax_param_pairs(tmodel, jgrads):
        got = param.grad.numpy()
        assert got.shape == want.shape and np.isfinite(got).all()
        if id(param) in key_bias:
            assert np.abs(got).max() < 1e-6 and np.abs(want).max() < 1e-6
        elif id(param) not in sketched:
            out.append((param, want))
    return out


def _check_grads(tmodel, jgrads, fewbit):
    for param, want in _compared(tmodel, jgrads, fewbit):
        got = param.grad.numpy()
        if fewbit:
            assert np.linalg.norm(got - want) <= \
                1e-4 * np.linalg.norm(want) + 1e-6
            np.testing.assert_allclose(got, want, rtol=1e-2,
                                       atol=1e-2 * np.abs(want).max() + 1e-6)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-3,
                                       atol=1e-3 * np.abs(want).max() + 1e-8)


# A few-bit code may differ between the packages where a border lies
# between their pre-activations: their FFN inputs differ by the rounding of
# their f32 sums upstream (the attention's among them; up to 4.1e-6 in the
# pre-activation at these widths), and each package's own f32 product
# rounds by up to 3.6e-6.  One flip moves the gradients by about 2e-4 of
# their norm, above the bound, so the port's backward is held to JAX's on
# JAX's codes: they may differ from the port's only within FLIP_EPS of a
# border lying between the two f64 pre-activations, on at most
# FLIP_FRACTION of the elements (as chip_smoke.py holds a kernel's codes).
FLIP_EPS, FLIP_FRACTION = 1e-5, 1e-4


class _PortCodes:
    """The port's few-bit FFN on the CPU, where kernels 6 and 5 run their
    plain versions: each forward records every layer's input, weights and
    codes; the backward of a layer in ``take`` runs on the codes given
    there instead of the forward's."""

    def __init__(self, monkeypatch):
        from fewbit_tpu_torch.ops.bitpack import pack_codes, unpack_codes

        self.take = {}
        self.reset()
        forward, backward = K.dense_act_plain, K.act_backward_plain

        def dense_act(spec, x, w, bias, borders, *args, **kwargs):
            y, packed = forward(spec, x, w, bias, borders, *args, **kwargs)
            self.layer_of[packed.data_ptr()] = len(self.codes)
            self.codes.append(unpack_codes(packed, spec.bits,
                                           x.shape[0]).numpy())
            self.dense.append(tuple(t.detach().numpy() for t in (x, w, bias)))
            self.borders = borders.double().numpy()
            return y, packed

        def act_backward(spec, packed, levels, g):
            layer = self.layer_of[packed.data_ptr()]
            if layer in self.take:
                packed = pack_codes(torch.from_numpy(self.take[layer]),
                                    spec.bits)
            return backward(spec, packed, levels, g)

        monkeypatch.setattr(K, "dense_act_plain", dense_act)
        monkeypatch.setattr(K, "act_backward_plain", act_backward)

    def reset(self):
        self.codes, self.dense, self.layer_of = [], [], {}

    def take_jax_codes(self, jax_inputs):
        """Sets ``take`` to JAX's codes of every layer: its Pallas kernel
        (interpret mode) on its FFN input (``jax_inputs``, by layer) and
        the same weights, as its model runs it.  Asserts where they differ
        from the port's.  Returns how many differ."""
        from fewbit_tpu.functional.activations import \
            resolve_activation as jax_resolve_activation
        from fewbit_tpu.ops import pallas_kernels as pk

        spec, borders, _ = jax_resolve_activation("gelu", bits=3)
        self.take, moved = {}, 0
        for lay, ((x, w, bias), jx) in enumerate(zip(self.dense,
                                                     jax_inputs)):
            jx = jx.reshape(x.shape)
            out = pk.fused_dense_act(spec, jnp.asarray(jx), jnp.asarray(w),
                                     jnp.asarray(bias), borders)
            assert out is not None  # JAX's kernel took the block
            jcodes = np.asarray(pk.unpack_block_layout(
                out[1], spec.bits, (x.shape[0], w.shape[1])), np.int32)
            flips = jcodes != self.codes[lay]
            rows, cols = np.nonzero(flips)
            zp = np.einsum("nk,kn->n", x[rows].astype(np.float64),
                           w[:, cols].astype(np.float64)) + bias[cols]
            zj = np.einsum("nk,kn->n", jx[rows].astype(np.float64),
                           w[:, cols].astype(np.float64)) + bias[cols]
            lo = np.minimum(zp, zj)[:, None] - FLIP_EPS
            hi = np.maximum(zp, zj)[:, None] + FLIP_EPS
            assert ((self.borders >= lo) & (self.borders <= hi)).any(1).all()
            assert flips.sum() <= FLIP_FRACTION * flips.size, flips.sum()
            self.take[lay] = jcodes
            moved += int(flips.sum())
        return moved


# Widths of the other head dimensions the kernels take: hidden 128 over 4
# heads (the JAX package's example models), 256 over 2, and a sequence
# length that no head dimension equals (the saved-tensor check below tells
# (b, h, s, s) from (b, h, s, d) by it).
HEAD_DIM_WIDTHS = {32: (dict(hidden_size=128, num_heads=4), SEQ),
                   128: (dict(hidden_size=256, num_heads=2), 96),
                   256: (dict(hidden_size=512, num_heads=2), 96)}
# Head dimension 80, Cerebras-GPT-2.7B's (32 heads of 80), at hidden 640
# over 8 heads (JAX's kernel 6 takes widths that are multiples of 128, and
# the few-bit check reads its codes): GPT only.
GPT_D80 = (dict(hidden_size=640, num_heads=8), SEQ)
# GPT's batch seeds, the same at every head dimension.
GPT_BATCH_SEEDS = (2, 3, 4, 5)


@pytest.mark.parametrize("fewbit", [False, True], ids=["vanilla", "fewbit"])
def test_gpt_flash_matches_jax(monkeypatch, fewbit):
    """Causal flash with segment ids from the attention mask, on the
    batches of GPT_BATCH_SEEDS; the few-bit backward on JAX's codes, which
    may differ from the port's only within rounding of a border
    (``_PortCodes.take_jax_codes``)."""
    _gpt_flash_case(monkeypatch, fewbit, {}, SEQ)


@pytest.mark.parametrize("fewbit", [False, True], ids=["vanilla", "fewbit"])
@pytest.mark.parametrize("d", sorted(HEAD_DIM_WIDTHS),
                         ids=["d32", "d128", "d256"])
def test_gpt_flash_matches_jax_at_head_dims(monkeypatch, fewbit, d):
    """As test_gpt_flash_matches_jax (head dimension 64) at head dimensions
    32, 128 and 256 (hidden 512 over 2 heads: Pythia-1B's head width, which
    the wide kernels take on the card); two layers, the same tolerances."""
    _gpt_flash_case(monkeypatch, fewbit, *HEAD_DIM_WIDTHS[d])


@pytest.mark.parametrize("fewbit", [False, True], ids=["vanilla", "fewbit"])
def test_gpt_flash_matches_jax_at_head_dim_80(monkeypatch, fewbit):
    """As test_gpt_flash_matches_jax at head dimension 80, the width of
    Cerebras-GPT-2.7B's heads (F1-F3's instantiation at 80 on the card;
    bf16 and f32 rows of 160 and 320 bytes), hidden 640 over 8 heads, two
    layers, JAX's parameters through load_flax_params; the same
    tolerances."""
    assert GPTConfig(**{**SMALL, **GPT_D80[0]}).head_dim == 80
    _gpt_flash_case(monkeypatch, fewbit, *GPT_D80)


def _gpt_flash_case(monkeypatch, fewbit, widths, seq):
    monkeypatch.setenv("FEWBIT_TPU_NATIVE", "interpret")
    extra = FEWBIT if fewbit else {}
    cfg = dict(SMALL, max_position_embeddings=seq, **extra, **widths)
    # Unrolled layers, as in tests/test_torch_gpt.py's few-bit test.
    jmodel = JaxGPT(JaxGPTConfig(**cfg, scan_layers=False))
    tmodel = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    codes = _PortCodes(monkeypatch) if fewbit else None
    jax_step = _jax_step(jmodel, jax_lm_loss, "ffn_norm" if fewbit else None)
    params = None
    for seed in GPT_BATCH_SEEDS:
        b = next(synthetic_lm(BS, seq, vocab_size=SMALL["vocab_size"],
                              seed=seed))
        if params is None:
            params = _transplant(jmodel, tmodel, b)
        jl, jlogits, jgrads, *jax_inputs = jax_step(params, b)

        def run():
            if codes is not None:
                codes.reset()
            return _torch_loss_grads(tmodel, b, causal_lm_loss)

        tl, tlogits = run()
        np.testing.assert_allclose(tlogits, jlogits, rtol=1e-4, atol=1e-5)
        assert abs(tl - jl) < 1e-5
        if fewbit:
            moved = codes.take_jax_codes(jax_inputs[0])
            print(f"batch seed {seed}: {moved} codes differ from JAX's")
            run()
            codes.take = {}
        _check_grads(tmodel, jgrads, fewbit)


@pytest.mark.parametrize("fewbit", [False, True], ids=["vanilla", "fewbit"])
def test_roberta_flash_matches_jax_on_padded_batch(monkeypatch, fewbit):
    """Non-causal flash with segment ids from the padding mask."""
    _roberta_flash_case(monkeypatch, fewbit, {}, SEQ)


@pytest.mark.parametrize("fewbit", [False, True], ids=["vanilla", "fewbit"])
@pytest.mark.parametrize("d", sorted(HEAD_DIM_WIDTHS),
                         ids=["d32", "d128", "d256"])
def test_roberta_flash_matches_jax_at_head_dims(monkeypatch, fewbit, d):
    """As test_roberta_flash_matches_jax_on_padded_batch (head dimension
    64) at head dimensions 32, 128 and 256."""
    _roberta_flash_case(monkeypatch, fewbit, *HEAD_DIM_WIDTHS[d])


def _roberta_flash_case(monkeypatch, fewbit, widths, seq):
    monkeypatch.setenv("FEWBIT_TPU_NATIVE", "interpret")
    extra = FEWBIT if fewbit else {}
    cfg = dict(SMALL, max_position_embeddings=seq + 2, **extra, **widths)
    jmodel = JaxRoberta(JaxRobertaConfig(**cfg))
    tmodel = RobertaForSequenceClassification(RobertaConfig(**cfg),
                                              device="cpu")
    b = next(synthetic_glue(BS, seq, vocab_size=SMALL["vocab_size"], seed=1))
    assert (b["attention_mask"] == 0).any()  # padded rows are exercised
    params = _transplant(jmodel, tmodel, b)
    jl, jlogits, jgrads = _jax_loss_grads(jmodel, params, b, jax_cls_loss)
    tl, tlogits = _torch_loss_grads(tmodel, b, classification_loss)
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-4, atol=1e-5)
    assert abs(tl - jl) < 1e-5
    _check_grads(tmodel, jgrads, fewbit)


def test_gpt_at_cerebras_590m_widths_matches_jax(monkeypatch):
    """One layer of Cerebras-GPT-590M's widths (hidden 1536 over 12 heads
    of 128, FFN 6144; vocabulary cut to 1000, 256 positions): the JAX
    parameters load through load_flax_params and flax_param_pairs, and the
    port's flash path (its plain versions here) gives JAX's logits, loss
    and gradients at the tolerances above."""
    monkeypatch.setenv("FEWBIT_TPU_NATIVE", "interpret")
    cfg = dict(SMALL, hidden_size=1536, num_heads=12, num_layers=1,
               intermediate_size=6144, max_position_embeddings=256)
    jmodel = JaxGPT(JaxGPTConfig(**cfg, scan_layers=False))
    tmodel = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    assert GPTConfig(**cfg).head_dim == 128
    b = next(synthetic_lm(2, 96, vocab_size=SMALL["vocab_size"], seed=4))
    params = _transplant(jmodel, tmodel, b)
    jl, jlogits, jgrads = _jax_loss_grads(jmodel, params, b, jax_lm_loss)
    tl, tlogits = _torch_loss_grads(tmodel, b, causal_lm_loss)
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-4, atol=1e-5)
    assert abs(tl - jl) < 1e-5
    _check_grads(tmodel, jgrads, False)


def test_gpt_at_pythia_1b_widths_matches_jax(monkeypatch):
    """One layer of Pythia-1B's widths (hidden 2048 over 8 heads of 256,
    FFN 8192, an untied head; vocabulary cut to 1000, 256 positions; the
    widths only: the JAX package has neither rotary embeddings nor the
    parallel residual): the JAX parameters load through load_flax_params
    and flax_param_pairs, and the port's flash path (its plain versions
    here) gives JAX's logits, loss and gradients at the tolerances above."""
    monkeypatch.setenv("FEWBIT_TPU_NATIVE", "interpret")
    cfg = dict(SMALL, hidden_size=2048, num_heads=8, num_layers=1,
               intermediate_size=8192, max_position_embeddings=256,
               tie_lm_head=False)
    jmodel = JaxGPT(JaxGPTConfig(**cfg, scan_layers=False))
    tmodel = GPTForCausalLM(GPTConfig(**cfg), device="cpu")
    assert GPTConfig(**cfg).head_dim == 256
    assert any("lm_head" in n for n, _ in tmodel.named_parameters())
    b = next(synthetic_lm(2, 96, vocab_size=SMALL["vocab_size"], seed=4))
    params = _transplant(jmodel, tmodel, b)
    jl, jlogits, jgrads = _jax_loss_grads(jmodel, params, b, jax_lm_loss)
    tl, tlogits = _torch_loss_grads(tmodel, b, causal_lm_loss)
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-4, atol=1e-5)
    assert abs(tl - jl) < 1e-5
    _check_grads(tmodel, jgrads, False)
