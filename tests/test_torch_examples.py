"""The port's examples (``fewbit_tpu_torch/examples``) and its
``summarize_runs`` against the JAX scripts under ``examples/`` and
``tools/``: configurations, data streams, the first training step,
evaluation, the MLM pretrain's optimizer and transplant, the memory table,
the ``--glue`` fine-tune on a fixture with its logs and checkpoint, and
each twin end to end at a few steps on the CPU.

The JAX scripts are loaded from their files; they import JAX inside their
functions.  Their configurations are built from the scripts' own source
(the ``configs`` literal of ``main`` and the config call, evaluated with
the row's values), so that an edit of a script shows here.

Weights are drawn with numpy into ``jax.eval_shape`` trees (flax's eager
init takes seconds a model) and carried into the port by
``load_flax_params``.  The first-step checks run a test-built config of
each twin: 1 layer, dropout 0 (no dropout draw enters), the JAX layers
unrolled (XLA fuses a scanned body otherwise, and activations a few ulps
apart flip a code lying within 1e-6 of a border more often).

Tolerances: the loss within rtol 1e-5; the exact and few-bit rows' every
gradient within atol 1e-5 + rtol 1e-4 (f32 sums over 2048 or 4096 rows in
other orders: 1.2e-5 apart at 0.04 in GPT's FFN weight); a sketched weight
gradient is an estimate from each package's own draws and is not compared,
the other gradients of a sketched row are held as the exact ones;
evaluation within rtol 1e-5; the MLM optimizer's step within atol 1e-6.
"""

import ast
import dataclasses
import importlib.util
import io
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import fewbit_tpu.models as jm
from fewbit_tpu import train as jt
from fewbit_tpu.train.loop import TrainState as JaxTrainState
from fewbit_tpu.train.loop import classification_loss as jax_cls_loss

from fewbit_tpu_torch.examples import classification_parity_real_text as CL
from fewbit_tpu_torch.examples import convergence_parity as CP
from fewbit_tpu_torch.examples import finetune_glue as FG
from fewbit_tpu_torch.examples import lm_parity_real_text as LM
from fewbit_tpu_torch.examples import memory_profile as MP
from fewbit_tpu_torch.examples import variance_estimation as VE
from fewbit_tpu_torch.examples._common import (mean_accuracy, on_device,
                                               step_generator)
from fewbit_tpu_torch.models import load_flax_params
from fewbit_tpu_torch.modules import (FusedDenseActivation, FewBitFFN,
                                      RandomizedDense)
from fewbit_tpu_torch.tools import summarize_runs as SR
from fewbit_tpu_torch.train import restore_checkpoint

ROOT = Path(__file__).resolve().parent.parent
TEST_CFG = dict(num_layers=1, hidden_dropout=0.0, attention_dropout=0.0)
K_BATCHES = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the examples run many
    small ops, whose parallel regions stall for minutes when the test
    workers share the cores (the module took 1436 s under six workers
    with torch's default threads, 66 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(rel):
    """A JAX script as a module (its JAX imports run when its functions
    do)."""
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(
        "jax_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree(rel):
    return ast.parse((ROOT / rel).read_text())


def _script_configs(rel):
    """The ``configs = [...]`` rows of the script's ``main``."""
    for node in ast.walk(_tree(rel)):
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "configs"):
            return ast.literal_eval(node.value)
    raise AssertionError(f"no configs in {rel}")


def _script_call(rel, func, **names):
    """The script's first call of ``func``, evaluated with ``names``."""
    for node in ast.walk(_tree(rel)):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "id", None) == func):
            code = compile(ast.Expression(node), rel, "eval")
            return eval(code, {"jnp": jnp, "max": max, **names})
    raise AssertionError(f"no call of {func} in {rel}")


def _assert_same_config(port, ref):
    assert ({f.name for f in dataclasses.fields(port)}
            == {f.name for f in dataclasses.fields(ref)})
    for f in dataclasses.fields(ref):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if f.name == "dtype":
            assert str(got) == f"torch.{jnp.dtype(want).name}"
        else:
            assert got == want, f.name


# ---------------------------------------------------------------------------
# Configurations, field by field.
# ---------------------------------------------------------------------------

CONV = "examples/convergence_parity.py"
LMS = "examples/lm_parity_real_text.py"
CLS = "examples/classification_parity_real_text.py"
FINE = "examples/finetune_glue.py"


@pytest.mark.parametrize("twin,rel", [(CP, CONV), (LM, LMS), (CL, CLS)],
                         ids=["convergence", "lm", "classification"])
def test_rows_are_the_scripts(twin, rel):
    assert [tuple(r) for r in twin.CONFIGS] == _script_configs(rel)


@pytest.mark.parametrize("row", CP.CONFIGS, ids=[r[0] for r in CP.CONFIGS])
def test_convergence_config(row):
    _, gb, pr = row
    _assert_same_config(CP.model_config(gb, pr), _script_call(
        CONV, "RobertaConfig", RobertaConfig=jm.RobertaConfig, gelu_bits=gb,
        proj_dim_ratio=pr))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("row", LM.CONFIGS, ids=[r[0] for r in LM.CONFIGS])
def test_lm_config(row, dtype):
    _, gb, pr, sk = row
    _assert_same_config(LM.model_config(gb, pr, sk, dtype=dtype),
                        _script_call(LMS, "GPTConfig",
                                     GPTConfig=jm.GPTConfig, gelu_bits=gb,
                                     proj_dim_ratio=pr, sketch=sk, seq=128,
                                     dtype=dtype))


@pytest.mark.parametrize("num_labels", [2, 14])
@pytest.mark.parametrize("row", CL.CONFIGS, ids=[r[0] for r in CL.CONFIGS])
def test_classification_config(row, num_labels):
    _, bits, ratio, sketch = row
    jax_cls = _load(CLS)
    _assert_same_config(
        CL.model_config(num_labels, bits, ratio, sketch or "countsketch"),
        jax_cls.model_config(num_labels, bits, ratio,
                             sketch or "countsketch"))


FINE_FLAGS = {"default": [],
              "gaussian 3-bit 20%": ["--num-bits", "3",
                                     "--proj-dim-ratio", "0.2"],
              "countsketch 3-bit 20%": ["--num-bits", "3",
                                        "--proj-dim-ratio", "0.2",
                                        "--matmul", "countsketch"],
              "narrow": ["--layers", "2", "--hidden", "128"]}


@pytest.mark.parametrize("flags", list(FINE_FLAGS.values()),
                         ids=list(FINE_FLAGS))
def test_finetune_config(flags):
    args = FG.parse_args(["--device", "cpu", *flags])
    ref = _script_call(FINE, "RobertaConfig", RobertaConfig=jm.RobertaConfig,
                       args=args)
    _assert_same_config(FG.model_config(args), ref)
    if not flags:  # full-width RoBERTa-base
        assert (ref.num_layers, ref.hidden_size, ref.num_heads,
                ref.intermediate_size) == (12, 768, 12, 3072)


# ---------------------------------------------------------------------------
# Data streams, to the bit.
# ---------------------------------------------------------------------------


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k])


def _take(stream, k=K_BATCHES):
    return [next(stream) for _ in range(k)]


def test_convergence_data():
    data, batch0, held = CP.make_data(CP.model_config(None, None))
    ref = jt.synthetic_glue(32, seq_len=64, vocab_size=1024, seed=1)
    _assert_batches_equal([batch0, *_take(data)], _take(ref, K_BATCHES + 1))
    _assert_batches_equal(held, [next(jt.synthetic_glue(
        32, seq_len=64, vocab_size=1024, seed=999 + i)) for i in range(8)])


def test_lm_data():
    data, batch0, held = LM.make_data()
    train_ids, val_ids = jt.byte_lm_arrays(jt.real_text_corpus(),
                                           seq_len=128)
    ref = jt.byte_lm_batches(train_ids, 32, seed=7)
    _assert_batches_equal([batch0, *_take(data)], _take(ref, K_BATCHES + 1))
    n_val = (len(val_ids) // 32) * 32
    val = jt.byte_lm_batches(val_ids[:n_val], 32, seed=0)
    _assert_batches_equal(held, _take(val, n_val // 32))


@pytest.mark.parametrize("task", ["doc", "pair"])
def test_classification_data(task):
    train, val, n_cls = CL.task_data(task)
    if task == "doc":
        jtrain, jval, jn = jt.real_doc_arrays()
    else:
        (jtrain, jval), jn = jt.real_pair_arrays(min_segment=64), 2
    assert n_cls == jn
    _assert_batches_equal([train, val], [jtrain, jval])
    for seed in (0, 2):
        stream, batch0 = CL.train_stream(train, 32, seed)
        ref = jt.batches_from_arrays(jtrain, 32, seed=7 + seed)
        _assert_batches_equal([batch0, *_take(stream)],
                              _take(ref, K_BATCHES + 1))
    n_val = (len(jval["labels"]) // 32) * 32
    _assert_batches_equal(CL.val_batches(val, 32), [
        {k: v[i:i + 32] for k, v in jval.items()}
        for i in range(0, n_val, 32)])


def test_mlm_corruption_stream(monkeypatch):
    """The batches the JAX script's ``pretrain_backbone`` feeds its jitted
    step (the step replaced by a recorder, its model by a one-layer stand
    in: neither draws from the corruption stream)."""
    import flax.linen as nn

    jax_cls = _load(CLS)
    seen = []

    def record(fn):
        def step(params, opt_state, ids, corrupt, originals, key):
            seen.append(tuple(np.asarray(a) for a in (ids, corrupt,
                                                      originals)))
            return params, opt_state, jnp.float32(0.0)
        return step

    class Stub(nn.Module):
        cfg: object

        @nn.compact
        def __call__(self, ids, mask, deterministic=True):
            return nn.Embed(8, 4)(ids % 8)

    monkeypatch.setattr(jax, "jit", record)
    monkeypatch.setattr(jm, "RobertaModel", Stub)
    jax_cls.pretrain_backbone(K_BATCHES, batch=32, seed=0)
    monkeypatch.undo()
    windows = CL.mlm_windows(CL.real_text_corpus())
    got = _take(CL.mlm_batches(windows, 32, seed=0))
    assert len(seen) == K_BATCHES
    for g, w in zip(got, seen):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert not got[0][1][:, 0].any() and got[0][1].mean() == pytest.approx(
        0.15, abs=0.02)


# ---------------------------------------------------------------------------
# The first step against JAX, weights carried across.
# ---------------------------------------------------------------------------


def _draw_params(init, seed=0):
    """Weights drawn with numpy into the shapes of ``init(key)``."""
    shapes = jax.eval_shape(init, jax.random.key(0))["params"]
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if "kernel" in name:
            return z * leaf.shape[-2] ** -0.5
        if name == "embedding":
            return z * 0.5
        return 1.0 + 0.1 * z if name == "scale" else 0.1 * z

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _model_params(jmodel, batch):
    ids = jnp.asarray(batch["input_ids"])
    mask = jnp.asarray(batch["attention_mask"])
    return _draw_params(lambda k: jmodel.init(
        {"params": k, "sketch": k}, ids, mask, deterministic=True))


def _jax_loss_grads(jmodel, params, batch, loss_fn):
    b = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(p):
        logits = jmodel.apply({"params": p}, b["input_ids"],
                              b["attention_mask"], deterministic=True,
                              rngs={"sketch": jax.random.key(2)})
        return loss_fn(logits, b["labels"])

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return float(value), jax.tree_util.tree_map(np.asarray, grads)


def _sketched(model):
    """The weights whose gradient is an estimate from a sketch."""
    out = set()
    for m in model.modules():
        if isinstance(m, (RandomizedDense, FusedDenseActivation)) and (
                getattr(m, "proj_dim_ratio", None)):
            out.add(id(m.weight))
        if isinstance(m, FewBitFFN):
            out |= {id(m.up_weight), id(m.down_weight)}
    return out


def _check_first_step(model, step, jmodel, params, batch, loss_fn,
                      sketched_rows):
    load_flax_params(model, params)
    want_loss, want_grads = _jax_loss_grads(jmodel, params, batch, loss_fn)
    loss = step.loss_and_grads(on_device(batch, "cpu"),
                               step_generator(0, 0)).item()
    assert loss == pytest.approx(want_loss, rel=1e-5)
    sketched = _sketched(model)
    assert bool(sketched) == sketched_rows
    compared = 0
    for param, want in model.flax_param_pairs(want_grads):
        got = param.grad.numpy()
        assert got.shape == want.shape and np.isfinite(got).all()
        if id(param) in sketched:
            continue
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        compared += 1
    assert compared == len(list(model.parameters())) - len(sketched)


def _jax_cfg(cfg_cls, port_cfg, **extra):
    """The JAX config of a port config's fields (dtype f32)."""
    fields = {f.name: getattr(port_cfg, f.name)
              for f in dataclasses.fields(port_cfg) if f.name != "dtype"}
    return cfg_cls(**{**fields, **extra})


@pytest.mark.parametrize("row", CP.CONFIGS, ids=[r[0] for r in CP.CONFIGS])
def test_convergence_first_step_matches_jax(row):
    _, gb, pr = row
    cfg = dataclasses.replace(CP.model_config(gb, pr), **TEST_CFG)
    data, _, _ = CP.make_data(cfg)
    batch = next(data)
    jmodel = jm.RobertaForSequenceClassification(
        _jax_cfg(jm.RobertaConfig, cfg, scan_layers=False))
    model, step = CP.build(cfg, 10, "cpu")
    _check_first_step(model, step, jmodel, _model_params(jmodel, batch),
                      batch, jax_cls_loss, bool(pr))


@pytest.mark.parametrize("row", LM.CONFIGS, ids=[r[0] for r in LM.CONFIGS])
def test_lm_first_step_matches_jax(row):
    _, gb, pr, sk = row
    cfg = dataclasses.replace(LM.model_config(gb, pr, sk), **TEST_CFG)
    data, _, _ = LM.make_data()
    batch = next(data)
    jmodel = jm.GPTForCausalLM(_jax_cfg(jm.GPTConfig, cfg,
                                        scan_layers=False))
    model, step = LM.build(cfg, 10, "cpu")
    _check_first_step(model, step, jmodel, _model_params(jmodel, batch),
                      batch, jt.causal_lm_loss, bool(pr))


@pytest.mark.parametrize("row", CL.CONFIGS, ids=[r[0] for r in CL.CONFIGS])
def test_classification_first_step_matches_jax(row):
    _, bits, ratio, sketch = row
    train, _, n_cls = CL.task_data("doc")
    cfg = dataclasses.replace(
        CL.model_config(n_cls, bits, ratio, sketch or "countsketch"),
        **TEST_CFG)
    stream, _ = CL.train_stream(train, 32)
    batch = next(stream)
    jmodel = jm.RobertaForSequenceClassification(
        _jax_cfg(jm.RobertaConfig, cfg, scan_layers=False))
    model, step = CL.build(cfg, 10, "cpu")
    _check_first_step(model, step, jmodel, _model_params(jmodel, batch),
                      batch, jax_cls_loss, bool(ratio))


def _jax_byte_mlm(cfg):
    """The JAX script's ``ByteMLM`` (local to ``pretrain_backbone``)."""
    import flax.linen as nn

    class ByteMLM(nn.Module):
        @nn.compact
        def __call__(self, ids, deterministic=True):
            h = jm.RobertaModel(cfg, name="roberta")(
                ids, jnp.ones_like(ids), deterministic=deterministic)
            return nn.Dense(CL.VOCAB, name="lm_head")(h)

    return ByteMLM()


def test_mlm_first_step_matches_jax():
    cfg = dataclasses.replace(CL.model_config(2), **TEST_CFG)
    jmodel = _jax_byte_mlm(_jax_cfg(jm.RobertaConfig, cfg,
                                    scan_layers=False))
    ids, corrupt, originals = next(CL.mlm_batches(
        CL.mlm_windows(CL.real_text_corpus()), 32))
    params = _draw_params(lambda k: jmodel.init({"params": k},
                                                jnp.asarray(ids[:2])))

    def loss_fn(p):  # the script's
        logits = jmodel.apply({"params": p}, jnp.asarray(ids),
                              deterministic=False)
        per = optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), jnp.asarray(originals))
        m = jnp.asarray(corrupt).astype(jnp.float32)
        return (per * m).sum() / jnp.maximum(m.sum(), 1)

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(params)
    model = CL.ByteMLM(cfg, "cpu")
    load_flax_params(model, jax.tree_util.tree_map(np.asarray, params))
    t = [torch.from_numpy(a) for a in (ids, corrupt, originals)]
    loss = CL.mlm_loss(model(t[0].long(), deterministic=False), t[1], t[2])
    loss.backward()
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    pairs = list(model.flax_param_pairs(jax.tree_util.tree_map(np.asarray,
                                                               want)))
    assert len(pairs) == len(list(model.parameters()))
    for param, w in pairs:
        np.testing.assert_allclose(param.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# Evaluation under carried weights.
# ---------------------------------------------------------------------------


def _jax_state(jmodel, params):
    return JaxTrainState.create(apply_fn=jmodel.apply, params=params,
                                tx=optax.identity())


@pytest.mark.parametrize("twin", ["convergence", "classification"])
def test_accuracy_matches_jax(twin):
    if twin == "convergence":
        cfg = dataclasses.replace(CP.model_config(3, 0.2), **TEST_CFG)
        _, _, held = CP.make_data(cfg, eval_batches=3)
        model, _ = CP.build(cfg, 10, "cpu")
    else:
        train, val, n_cls = CL.task_data("doc")
        cfg = dataclasses.replace(CL.model_config(n_cls, 3, 0.2), **TEST_CFG)
        held = CL.val_batches(val, 32)[:3]
        model, _ = CL.build(cfg, 10, "cpu")
    jmodel = jm.RobertaForSequenceClassification(
        _jax_cfg(jm.RobertaConfig, cfg, scan_layers=False))
    params = _model_params(jmodel, held[0])
    load_flax_params(model, params)
    state = _jax_state(jmodel, params)
    jeval = jt.make_eval_step(jmodel)
    want = np.mean([float(jeval(state, {k: jnp.asarray(v) for k, v in
                                        b.items()})["accuracy"])
                    for b in held])
    assert mean_accuracy(model, held, "cpu") == pytest.approx(want, rel=1e-5)


def test_bits_per_byte_matches_jax():
    cfg = dataclasses.replace(LM.model_config(3, 0.2, "countsketch"),
                              **TEST_CFG)
    _, _, held = LM.make_data()
    held = held[:2]
    jmodel = jm.GPTForCausalLM(_jax_cfg(jm.GPTConfig, cfg,
                                        scan_layers=False))
    params = _model_params(jmodel, held[0])
    model, _ = LM.build(cfg, 10, "cpu")
    load_flax_params(model, params)

    @jax.jit
    def eval_loss(batch):  # the script's eval_loss, with a sketch key
        logits = jmodel.apply({"params": params}, batch["input_ids"],
                              batch["attention_mask"], deterministic=True,
                              rngs={"sketch": jax.random.key(0)})
        return jt.causal_lm_loss(logits, batch["labels"])

    nats = sum(float(eval_loss({k: jnp.asarray(v) for k, v in b.items()}))
               for b in held) / len(held)
    assert LM.bits_per_byte(model, held, "cpu") == pytest.approx(
        nats / np.log(2.0), rel=1e-5)


# ---------------------------------------------------------------------------
# The MLM pretrain: optimizer and transplant.
# ---------------------------------------------------------------------------


def test_mlm_optimizer_matches_optax():
    """Steps 0, 1 and 2 of a 4-step linear decay: the port's AdamW equals
    the script's ``optax.adamw`` on a small tree."""
    lr, steps = 3e-3, 4
    rng = np.random.RandomState(5)
    shapes = ((6, 4), (4,), (3,))
    init = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    tx = optax.adamw(optax.linear_schedule(lr, 0.0, steps), b1=0.9,
                     b2=0.98, weight_decay=0.01)
    jparams = [jnp.asarray(a) for a in init]
    opt_state = tx.init(jparams)
    params = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    opt, sched = CL.mlm_optimizer(params, lr, steps)
    for g in grads:
        updates, opt_state = tx.update([jnp.asarray(a) for a in g],
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, a in zip(params, g):
            p.grad = torch.from_numpy(a.copy())
        opt.step()
        sched.step()
        for p, w in zip(params, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                       rtol=0, atol=1e-6)
    assert sched.get_last_lr()[0] == pytest.approx(lr * (1 - 3 / steps))


def test_backbone_transplant():
    """Every configuration gets the pretrained encoder's tensors and the
    head its own seed draws."""
    backbone = CL.pretrain_backbone(2, "cpu", batch=4)
    for seed in (0, 1):
        heads = []
        for _, bits, ratio, sketch in CL.CONFIGS:
            cfg = CL.model_config(14, bits, ratio, sketch or "countsketch")
            model, _ = CL.build(cfg, 10, "cpu", seed=seed, backbone=backbone)
            state = model.roberta.state_dict()
            assert set(state) == set(backbone)
            for k, v in backbone.items():
                assert torch.equal(state[k], v), k
            fresh, _ = CL.build(cfg, 10, "cpu", seed=seed)
            for name in ("head_dense", "head_out"):
                assert torch.equal(getattr(model, name).weight,
                                   getattr(fresh, name).weight)
            assert not torch.equal(model.roberta.embeddings.word_embeddings
                                   .weight,
                                   fresh.roberta.embeddings.word_embeddings
                                   .weight)
            heads.append(model.head_out.weight)
        assert all(torch.equal(h, heads[0]) for h in heads)


# ---------------------------------------------------------------------------
# The memory table.
# ---------------------------------------------------------------------------


def test_memory_table_matches_jax():
    """At 32768 elements (32 rows of 1024) the few-bit residual bytes per
    element equal the JAX script's table as printed.  The exact column is
    what each framework's autograd keeps: torch one f32 tensor (4 bytes),
    JAX its VJP closure (5 to 12)."""
    jax_mp = _load("examples/memory_profile.py")
    out = io.StringIO()
    argv = sys.argv
    sys.argv = ["memory_profile.py", "--elems", "32768"]
    try:
        with redirect_stdout(out):
            jax_mp.main()
    finally:
        sys.argv = argv
    want = [line.split() for line in out.getvalue().splitlines()[1:]]
    rows = MP.main(["--device", "cpu", "--elems", "32768"])
    assert len(rows) == len(want) == 14
    for r, (name, bits, residual, exact) in zip(rows, want):
        assert (r["function"], r["bits"]) == (name, int(bits))
        assert f"{r['residual']:.4f}" == residual
        # Codes (bits, 1, 1024) int32 and the f32 levels of the LUT.
        assert r["residual"] * 32768 == 4096 * r["bits"] + 4 * 2 ** r["bits"]
        assert r["exact"] == 4.0 and float(exact) >= 4.0


# ---------------------------------------------------------------------------
# finetune_glue --glue on a fixture, its logs and its checkpoint.
# ---------------------------------------------------------------------------


def _fixture(path, seq=32):
    rng = np.random.RandomState(3)
    arrays = {}
    for split, n in (("train", 48), ("validation", 40)):
        ids = rng.randint(3, 1000, size=(n, seq)).astype(np.int32)
        mask = np.ones((n, seq), np.int32)
        lengths = rng.randint(seq // 2, seq + 1, size=n)
        for i, m in enumerate(lengths):
            ids[i, m:], mask[i, m:] = 1, 0
        ids[:, 0] = 0
        arrays[f"{split}_input_ids"] = ids
        arrays[f"{split}_attention_mask"] = mask
        arrays[f"{split}_labels"] = rng.randint(0, 2, n).astype(np.int32)
    np.savez(path, **arrays)
    return path


def test_finetune_glue_fixture(tmp_path, capsys):
    npz = _fixture(tmp_path / "mrpc.npz")
    logs, ckpt = tmp_path / "logs", tmp_path / "ckpt"
    args = FG.parse_args([
        "--device", "cpu", "--layers", "2", "--hidden", "128", "--steps",
        "2", "--eval-every", "1", "--glue", str(npz), "--log-dir",
        str(logs), "--checkpoint-dir", str(ckpt), "--num-bits", "3",
        "--proj-dim-ratio", "0.2"])
    run = FG.finetune(args)
    printed = capsys.readouterr().out
    assert "MRPC: 48 train / 40 validation examples" in printed
    # Two validation batches of 16: the last 8 rows are dropped, as JAX's.
    val = FG.load_tokenized_npz(npz)["validation"]
    model = run["model"]
    with torch.no_grad():
        logits = model(torch.from_numpy(val["input_ids"][:32]).long(),
                       torch.from_numpy(val["attention_mask"][:32]).long(),
                       sketch_generator=torch.Generator().manual_seed(0))
    want = float((logits.argmax(-1).numpy() == val["labels"][:32]).mean())
    rows = run["rows"]
    assert [r["step"] for r in rows] == [1, 2, 2]
    assert rows[-1]["final"] and rows[-1]["val"] == pytest.approx(want)
    assert f"final val accuracy: {want:.4f}" in printed

    run_dir = logs / "gelu3-rand20%" / "mrpc"
    assert (run_dir / "metrics.jsonl").is_file()
    jax_sr = _load("tools/summarize_runs.py")
    argv = sys.argv
    sys.argv = ["summarize_runs.py", str(logs)]
    try:
        assert jax_sr.main() == 0
    finally:
        sys.argv = argv
    want_md = capsys.readouterr().out
    assert SR.main([str(logs)])
    assert capsys.readouterr().out == want_md
    assert "| gelu3-rand20% |" in want_md

    # The checkpoint restores to the uninterrupted run's next step.
    batch = on_device(next(run["data"]), "cpu")
    next_loss = run["step"](batch, step_generator(0, 2))["loss"].item()
    model2, step2 = FG.build(args, FG.model_config(args))
    assert restore_checkpoint(ckpt / "final", model2, step2) == 2
    assert step2(batch, step_generator(0, 2))["loss"].item() == next_loss


# ---------------------------------------------------------------------------
# Each twin end to end at a few steps; the card by default.
# ---------------------------------------------------------------------------


def test_convergence_runs_below_50_steps(tmp_path):
    """F-9: the JAX script raises IndexError below 50 steps; the twin
    reports the last step's loss."""
    out = tmp_path / "parity.md"
    rows = CP.main(["--device", "cpu", "--steps", "3", "--out", str(out)])
    assert [r["config"] for r in rows] == [c[0] for c in CP.CONFIGS]
    for r in rows:
        assert r["losses"] == [] and np.isfinite(r["final_loss"])
        assert 0.0 <= r["accuracy"] <= 1.0
    assert out.read_text().count("\n| ") == 1 + len(rows)


def test_lm_runs(tmp_path):
    rows = LM.main(["--device", "cpu", "--steps", "2", "--out",
                    str(tmp_path / "lm.md")])
    assert len(rows) == 5
    assert all(np.isfinite(r["final_loss"]) and 6 < r["bits_per_byte"] < 9
               for r in rows)


@pytest.mark.parametrize("task,extra", [("doc", []),
                                        ("pair", ["--pretrain", "2"])])
def test_classification_runs(task, extra):
    rows = CL.main(["--device", "cpu", "--task", task, "--steps", "2",
                    "--batch", "8", *extra])
    assert [r["config"] for r in rows] == [c[0] for c in CL.CONFIGS]
    assert all(np.isfinite(r["final_loss"]) and r["seeds"] == 1
               for r in rows)


def test_finetune_runs_on_synthetic_data():
    rows = FG.main(["--device", "cpu", "--layers", "1", "--hidden", "64",
                    "--steps", "2", "--batch", "4", "--seq", "16"])
    assert rows[-1]["final"] and 0.0 <= rows[-1]["holdout"] <= 1.0


def test_memory_profile_times():
    rows = MP.main(["--device", "cpu", "--elems", "32768", "--time"])
    assert rows[-1]["vanilla_ms"] > 0 and rows[-1]["fewbit_ms"] > 0


@pytest.mark.parametrize("main", [CP.main, LM.main, CL.main, FG.main,
                                  MP.main, VE.main],
                         ids=["convergence", "lm", "classification",
                              "finetune", "memory_profile",
                              "variance_estimation"])
def test_the_card_by_default(main, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        main([])
    assert "pass --device cpu" in capsys.readouterr().err
