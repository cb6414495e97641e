"""The port's data and tensor parallelism (``fewbit_tpu_torch.parallel``)
against the JAX package's, on the CPU over gloo.

The pure functions (``pod_mesh_spec``, ``host_groups``, the host-major
rank grid, ``tp_param_spec``, kernel 1's gate at the tp widths) are held
against the JAX package's directly.  The rest runs in one 4-process gloo
job (``tests/_torch_parallel_worker.py``), launched once for the module;
meanwhile this process computes the references:

* dp=1 x tp=2 on ``tests/test_tp.py``'s ``tp_config(2)`` (FusedDense-
  Activation FFN, 3-bit GELU), loaded from JAX's ``init_dp_tp_state``:
  logits and loss against the port's single-device model, JAX's
  ``dp_tp_train_step`` and JAX's single-device model (rtol 1e-5); every
  gathered gradient against both packages' single-device gradients (atol
  1e-5).  JAX's own tp gradients, taken as its ``make_train_step(dp_axis=
  "dp")`` takes them, are not (F-7): the sharded kernels' are exactly
  twice the single-device ones.
* path R at tp=2 (hidden 128, FFN 256, the fused ``FewBitFFN`` with
  countsketch at 0.2): the port's tp model is a sharding of single-device
  R, sketched gradients included (the sketch generator shared), where
  JAX's tp replicates the FFN (F-8).
* GPT few-bit at tp=2: the forward equals JAX's tp forward, the gradients
  the single-device ones.
* dp=2: the twins of ``tests/test_parallel.py``'s mean of shard gradients
  (atol 1e-5) and token-weighted causal loss (rtol 1e-6, atol 2e-6),
  against JAX's ``data_parallel_step``.
* dp=2 x tp=2: a step runs, the gathered ``intermediate`` weight is (2,
  32, 64) (the twin of ``tests/test_tp.py``'s), the dp replicas agree;
  dp ranks draw different sketch signs, tp ranks the same.
* R and GPT at tp=2 with ``flash_attention=True``: the local heads through
  the flash op, against the port's single-device flash model, JAX's
  single-device R (F-8 keeps JAX's tp R from being a target) and JAX's
  tp GPT (which takes the standard attention off the TPU).
* R at tp=2 with ``max_grad_norm`` set low enough that every step clips:
  the clipped gradients and three steps' updates against the single
  device's, the norm the unsharded model's.  JAX's tp step clips by each
  rank's own norm, so its replicated leaves get different updates on the
  two ranks (F-10).
"""

import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from fewbit_tpu import parallel as jpar
from fewbit_tpu.models import GPTConfig as JaxGPTConfig
from fewbit_tpu.models import GPTForCausalLM as JaxGPT
from fewbit_tpu.models import RobertaConfig as JaxRobertaConfig
from fewbit_tpu.models import RobertaForSequenceClassification as JaxRoberta
from fewbit_tpu.ops import pallas_kernels as jax_kernels
from fewbit_tpu.parallel.distributed import host_groups as jax_host_groups
from fewbit_tpu.train import TrainConfig as JaxTrainConfig
from fewbit_tpu.train import make_train_step as jax_make_train_step
from fewbit_tpu.train import synthetic_glue, synthetic_lm
from fewbit_tpu.train.loop import causal_lm_loss as jax_lm_loss
from fewbit_tpu.train.loop import TrainState as JaxTrainState
from fewbit_tpu.train.loop import classification_loss as jax_cls_loss
from fewbit_tpu.train.loop import make_optimizer

from fewbit_tpu_torch import parallel as tpar
from fewbit_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     RobertaConfig,
                                     RobertaForSequenceClassification,
                                     flax_param_pairs, load_flax_params)
from fewbit_tpu_torch.ops import kernels as K
from fewbit_tpu_torch.train import (TrainConfig, causal_lm_loss,
                                    classification_loss, make_train_step)

try:
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

WORKER = Path(__file__).parent / "_torch_parallel_worker.py"
REPO = Path(__file__).parent.parent
WORLD = 4
WORKER_TIMEOUT = 120  # seconds, each worker

# tests/test_tp.py's tp_config, without the tp fields.
TP_CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
              intermediate_size=64, max_position_embeddings=66,
              num_labels=2, hidden_dropout=0.0, attention_dropout=0.0,
              gelu_bits=3)
# Path R at a small width: the fused few-bit FFN, every projection
# countsketched.  Unrolled JAX layers: a scanned body fuses differently
# and flips codes within 1e-6 of a border more often.
R_CFG = dict(TP_CFG, hidden_size=128, intermediate_size=256,
             proj_dim_ratio=0.2, sketch="countsketch", scan_layers=False)
GPT_CFG = dict(vocab_size=128, hidden_size=128, num_layers=2, num_heads=4,
               intermediate_size=256, max_position_embeddings=32,
               hidden_dropout=0.0, attention_dropout=0.0, gelu_bits=3,
               proj_dim_ratio=0.25, sketch="countsketch", scan_layers=False)
# tests/test_parallel.py's TINY without its sketch (the deterministic
# model of its shard-gradient test), and its token-weighted GPT.
DP_CFG = dict(TP_CFG, num_heads=2)
DP_GPT_CFG = dict(vocab_size=64, hidden_size=16, num_layers=1, num_heads=2,
                  intermediate_size=32, max_position_embeddings=16,
                  hidden_dropout=0.0, attention_dropout=0.0)
SIGNS_CFG = dict(TP_CFG, proj_dim_ratio=0.5, sketch="countsketch",
                 fused_ffn=False)
SKETCH_SEED = 7
# tp_config with attention dropout on (the hidden dropout stays 0).
DROPOUT_CFG = dict(TP_CFG, attention_dropout=0.5)
DROPOUT_SEED = 11
# R and GPT on the flash op (their attention dropout is 0 already).
R_FLASH_CFG = dict(R_CFG, flash_attention=True)
GPT_FLASH_CFG = dict(GPT_CFG, flash_attention=True)
# Clipping active on every step: the gradients' norm is far above
# max_grad_norm.  No warmup, so that steps 1 and 2 move the weights.
CLIP_TRAIN = dict(total_steps=4, learning_rate=1e-3, warmup_ratio=0.0,
                  max_grad_norm=1e-3)
CLIP_STEPS, CLIP_PROBE_SEED = 3, 13


FAMILIES = {
    "roberta": (JaxRobertaConfig, JaxRoberta, jax_cls_loss, RobertaConfig,
                RobertaForSequenceClassification, classification_loss),
    "gpt": (JaxGPTConfig, JaxGPT, jax_lm_loss, GPTConfig, GPTForCausalLM,
            causal_lm_loss)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _glue(bs, vocab=128):
    return next(synthetic_glue(bs, seq_len=16, vocab_size=vocab))


def _single_tree(tree):
    """A JAX tp tree with single-device names: ``output_bias`` and
    ``ffn_bias`` back into their projections (``tests/test_tp.py``)."""
    def layer(lp):
        lp = dict(lp)
        attn = dict(lp["attention"])
        attn["output"] = dict(attn["output"], bias=attn.pop("output_bias"))
        lp["attention"] = attn
        lp["ffn_output"] = dict(lp["ffn_output"], bias=lp.pop("ffn_bias"))
        return lp

    tree = dict(tree)
    top = "roberta" if "roberta" in tree else "transformer"
    body = dict(tree[top])
    for name in [k for k in body if k == "layers" or k.startswith("layer_")]:
        body[name] = layer(body[name])
    tree[top] = body
    return tree


def _tp_tree(tree):
    """A single-device JAX tree in the JAX tp model's layout: the
    row-parallel biases as ``output_bias`` and ``ffn_bias``."""
    def layer(lp):
        lp = dict(lp)
        attn = dict(lp["attention"])
        attn["output"] = dict(attn["output"])
        attn["output_bias"] = attn["output"].pop("bias")
        lp["attention"] = attn
        lp["ffn_output"] = dict(lp["ffn_output"])
        lp["ffn_bias"] = lp["ffn_output"].pop("bias")
        return lp

    tree = dict(tree)
    top = "roberta" if "roberta" in tree else "transformer"
    body = dict(tree[top])
    for name in [k for k in body if k == "layers" or k.startswith("layer_")]:
        body[name] = layer(body[name])
    tree[top] = body
    return tree


def _jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _init(family, cfg, batch, seed):
    """A JAX single-device model of ``cfg`` and parameters for it drawn
    with numpy from ``seed``: kernels normal with variance 1 / fan-in,
    embeddings normal at 0.5, biases at 0.1, LayerNorm scales 1 + 0.1
    normal (flax's init, run eagerly, takes seconds a model)."""
    jcls, jmodel = FAMILIES[family][:2]
    model = jmodel(jcls(**cfg))
    shapes = jax.eval_shape(lambda k: model.init(
        {"params": k}, jnp.asarray(batch["input_ids"]),
        jnp.asarray(batch["attention_mask"]), deterministic=True),
        jax.random.key(0))["params"]
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if "kernel" in name:
            return z * leaf.shape[-2] ** -0.5
        if name == "embedding":
            return z * 0.5
        return 1.0 + 0.1 * z if name == "scale" else 0.1 * z

    return model, jax.tree_util.tree_map_with_path(draw, shapes)


def _loss_grads_fn(model, loss_fn):
    """JAX's ``(params, batch) -> ((loss, logits), grads)``, jitted once
    for a model."""
    def loss(p, b):
        logits = model.apply({"params": p}, b["input_ids"],
                             b["attention_mask"], deterministic=True,
                             rngs={"sketch": jax.random.key(2)})
        return loss_fn(logits, b["labels"]), logits

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def _port_loss_grads(model, batch, loss_fn):
    """One forward and backward of a single-device port model with the
    sketch generator the workers use: (logits, loss, grads by name)."""
    b = {k: torch.from_numpy(np.asarray(v)).long() for k, v in batch.items()}
    logits = model(b["input_ids"], b["attention_mask"],
                   sketch_generator=torch.Generator().manual_seed(
                       SKETCH_SEED))
    loss = loss_fn(logits, b["labels"])
    loss.backward()
    return (logits.detach().numpy(), loss.item(),
            {n: p.grad.detach().clone() for n, p in model.named_parameters()})


def _port_single(family, cfg, tree):
    cfg_cls, model_cls = FAMILIES[family][3:5]
    model = model_cls(cfg_cls(**cfg), device="cpu")
    load_flax_params(model, tree)
    return model


def _by_name(model, tree):
    """A JAX gradient tree as the port's names."""
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(p)]: np.asarray(a)
            for p, a in flax_param_pairs(model, tree)}


def _state(model, tree):
    return JaxTrainState.create(apply_fn=model.apply, params=_jnp_tree(tree),
                                tx=make_optimizer(JaxTrainConfig(
                                    total_steps=4, learning_rate=1e-4)))


def _tp_jax(family, cfg, tree, batch):
    """JAX's dp=1 x tp=2 model holding the global weights ``tree`` (JAX's
    tp layout): its step's gradients taken as ``make_train_step(dp_axis=
    "dp")`` takes them under ``dp_tp_train_step``'s ``shard_map``, with
    the loss and logits; for RoBERTa also ``dp_tp_train_step``'s loss."""
    jcls, jmodel_cls, loss_fn = FAMILIES[family][:3]
    model = jmodel_cls(jcls(**cfg, tp_axis="tp", tp_size=2))
    mesh = jpar.make_dp_tp_mesh(1, 2)
    jb = jpar.shard_batch(_jnp(batch), mesh)
    state = _state(model, tree)
    specs = jpar.state_specs(state)

    def loss_grads(params, b, key):
        key = jax.random.fold_in(key, lax.axis_index("dp"))
        dropout_key, sketch_key = jax.random.split(key)

        def loss(p):
            logits = model.apply({"params": p}, b["input_ids"],
                                 b["attention_mask"], deterministic=False,
                                 rngs={"dropout": dropout_key,
                                       "sketch": sketch_key})
            return loss_fn(logits, b["labels"]), logits

        (value, logits), grads = jax.value_and_grad(loss, has_aux=True)(
            params)
        return lax.pmean(value, "dp"), logits, lax.pmean(grads, "dp")

    value, logits, grads = jax.jit(shard_map(
        loss_grads, mesh=mesh, in_specs=(specs.params, P("dp"), P()),
        out_specs=(P(), P("dp"), specs.params), check_vma=False))(
        state.params, jb, jax.random.key(0))
    out = {"logits": np.asarray(logits), "shard_map_loss": float(value),
           "grads": _np(grads)}
    if family == "roberta":
        step = jpar.dp_tp_train_step(jax_make_train_step(model, dp_axis="dp"),
                                     mesh, specs)
        _, metrics = step(state, jb, jax.random.key(0))
        out["step_loss"] = float(metrics["loss"])
    return out


def _dp_jax_loss(model, tree, batch, loss_fn):
    """The loss of JAX's ``data_parallel_step`` at dp=2."""
    mesh = jpar.make_mesh(2)
    step = jpar.data_parallel_step(
        jax_make_train_step(model, dp_axis="dp", loss_fn=loss_fn), mesh,
        donate_state=False)
    _, metrics = step(jpar.replicate(_state(model, tree), mesh),
                      jpar.shard_batch(_jnp(batch), mesh), jax.random.key(0))
    return float(metrics["loss"])


def _dp_reference(model, tree, batch):
    """JAX's dp loss and the mean of the two shards' gradients (JAX's,
    and the port's with each rank's folded generator)."""
    fn = _loss_grads_fn(model, jax_cls_loss)
    params = _jnp_tree(tree)
    port = _port_single("roberta", DP_CFG, tree)
    grads, port_grads = [], []
    for r in range(2):
        shard = {k: np.asarray(v)[r * 8:(r + 1) * 8] for k, v in
                 batch.items()}
        grads.append(_np(fn(params, _jnp(shard))[1]))
        folded = tpar.fold_shard_generator(torch.Generator().manual_seed(0), r)
        seeds = torch.randint(0, 2 ** 62, (2,), generator=folded)
        b = {k: torch.from_numpy(v).long() for k, v in shard.items()}
        port.zero_grad(set_to_none=True)
        logits = port(b["input_ids"], b["attention_mask"],
                      deterministic=False,
                      dropout_generator=torch.Generator().manual_seed(
                          int(seeds[0])),
                      sketch_generator=torch.Generator().manual_seed(
                          int(seeds[1])))
        classification_loss(logits, b["labels"]).backward()
        port_grads.append({n: p.grad.clone()
                           for n, p in port.named_parameters()})
    mean = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, *grads)
    return {"loss": _dp_jax_loss(model, tree, batch, jax_cls_loss),
            "jax_grads": _by_name(port, mean),
            "port_grads": {n: (port_grads[0][n] + port_grads[1][n]) / 2
                           for n in port_grads[0]}}


def _lm_reference(model, tree, batch):
    """The full batch in one JAX process (loss, gradients) and JAX's dp
    loss."""
    (loss, _), grads = _loss_grads_fn(model, jax_lm_loss)(_jnp_tree(tree),
                                                          _jnp(batch))
    port = GPTForCausalLM(GPTConfig(**DP_GPT_CFG), device="cpu")
    return {"loss": float(loss),
            "dp_loss": _dp_jax_loss(model, tree, batch, jax_lm_loss),
            "grads": _by_name(port, _np(grads))}


def _lm_batch():
    """``tests/test_parallel.py``'s batch: the second dp rank's half
    nearly without valid tokens."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 64, (16, 8))
    labels = ids.copy()
    labels[8:, 2:] = -100
    return {"input_ids": ids, "attention_mask": np.ones((16, 8), np.int64),
            "labels": labels}


def _port_clip(tree, batch):
    """The single-device R under ``CLIP_TRAIN``, as the workers' clip
    case: the clipped gradients of one probe (and the norm), then
    ``CLIP_STEPS`` steps (the norms the clip saw, the updates)."""
    model = _port_single("roberta", R_CFG, tree)
    step = make_train_step(model, TrainConfig(**CLIP_TRAIN))
    b = {k: torch.from_numpy(np.asarray(v)).long() for k, v in batch.items()}
    step.loss_and_grads(b, torch.Generator().manual_seed(CLIP_PROBE_SEED))
    norm = step.clip_grads()
    clipped = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    gen = torch.Generator().manual_seed(0)
    outs = [step(b, gen) for _ in range(CLIP_STEPS)]
    return {"norm": norm, "clipped": clipped,
            "norms": [o["grad_norm"] for o in outs],
            "losses": [o["loss"] for o in outs],
            "updates": {n: p.detach() - before[n]
                        for n, p in model.named_parameters()}}


def _jax_tp_updates(tree, batch, max_grad_norm):
    """JAX's dp=1 x tp=2 ``tp_config`` model (JAX's tp layout): two steps
    of its ``make_train_step(dp_axis="dp")`` under ``shard_map`` as
    ``dp_tp_train_step`` runs them, with ``max_grad_norm``; every leaf's
    update as each tp rank holds it, stacked on a new first axis."""
    jcls, jmodel_cls = FAMILIES["roberta"][:2]
    model = jmodel_cls(jcls(**TP_CFG, tp_axis="tp", tp_size=2))
    mesh = jpar.make_dp_tp_mesh(1, 2)
    state = JaxTrainState.create(
        apply_fn=model.apply, params=_jnp_tree(tree),
        tx=make_optimizer(JaxTrainConfig(**dict(
            CLIP_TRAIN, max_grad_norm=max_grad_norm))))
    specs = jpar.state_specs(state)
    step = jax_make_train_step(model, dp_axis="dp")

    def per_rank(state, b, key):
        before = state.params
        for i in range(2):
            state, _ = step(state, b, jax.random.fold_in(key, i))
        return jax.tree_util.tree_map(lambda a, c: (a - c)[None],
                                      state.params, before)

    updates = jax.jit(shard_map(
        per_rank, mesh=mesh, in_specs=(specs, P("dp"), P()),
        out_specs=P("tp"), check_vma=False))(
        state, jpar.shard_batch(_jnp(batch), mesh), jax.random.key(0))
    return jax.tree_util.tree_leaves_with_path(_np(updates))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Launch the 4-process job once; compute the references while it
    runs; return both."""
    work = tmp_path_factory.mktemp("parallel")
    batches = {"tp_cfg": _glue(2), "tp_r": _glue(4), "dp_r": _glue(16),
               "tp_gpt": next(synthetic_lm(4, 32, vocab_size=128)),
               "dp_gpt": _lm_batch()}
    inits = {name: _init(family, cfg, batches[name], seed) for name, family,
             cfg, seed in (("tp_cfg", "roberta", TP_CFG, 0),
                           ("tp_r", "roberta", R_CFG, 3),
                           ("tp_gpt", "gpt", GPT_CFG, 4),
                           ("dp_r", "roberta", DP_CFG, 5),
                           ("dp_gpt", "gpt", DP_GPT_CFG, 6))}
    trees = {name: tree for name, (_, tree) in inits.items()}
    # The tp cases but R read JAX's tp layout: the biases summed over tp
    # under their own names.
    trees["tp_cfg"], trees["tp_gpt"] = (_tp_tree(trees["tp_cfg"]),
                                        _tp_tree(trees["tp_gpt"]))
    cases = {name: dict(family=family, cfg=cfg, batch=batches[name],
                        params=trees[name], sketch_seed=SKETCH_SEED)
             for name, family, cfg in (
                 ("tp_cfg", "roberta", TP_CFG), ("tp_r", "roberta", R_CFG),
                 ("tp_gpt", "gpt", GPT_CFG), ("dp_r", "roberta", DP_CFG),
                 ("dp_gpt", "gpt", DP_GPT_CFG))}
    cases["tp_dropout"] = dict(cases["tp_cfg"], cfg=DROPOUT_CFG,
                               dropout_seed=DROPOUT_SEED)
    cases["tp_flash_r"] = dict(cases["tp_r"], cfg=R_FLASH_CFG)
    cases["tp_flash_gpt"] = dict(cases["tp_gpt"], cfg=GPT_FLASH_CFG)
    cases["tp_clip"] = dict(cases["tp_r"], train=CLIP_TRAIN,
                            steps=CLIP_STEPS, probe_seed=CLIP_PROBE_SEED)
    cases["dp_tp"] = dict(cfg=TP_CFG, batch=_glue(4))
    cases["signs"] = dict(cfg=SIGNS_CFG, batch=_glue(4))
    torch.save(cases, work / "inputs.pt")
    store = work / "store"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(rank), str(WORLD), str(store),
         str(work)], env=env, cwd=str(REPO), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(WORLD)]
    try:
        # The references, while the workers run: JAX's tp step, and each
        # tp case's single-device model in both packages on the same
        # weights.
        ref = {name: _tp_jax(family, cfg, trees[name], batches[name])
               for name, family, cfg in (("tp_cfg", "roberta", TP_CFG),
                                         ("tp_gpt", "gpt", GPT_CFG))}
        single = {}
        for name, family, cfg in (("tp_cfg", "roberta", TP_CFG),
                                  ("tp_r", "roberta", R_CFG),
                                  ("tp_gpt", "gpt", GPT_CFG)):
            model, tree = inits[name]
            port = _port_single(family, cfg, tree)
            (jl, jlogits), jgrads = _loss_grads_fn(model, FAMILIES[family][2])(
                _jnp_tree(tree), _jnp(batches[name]))
            logits, loss, grads = _port_loss_grads(port, batches[name],
                                                   FAMILIES[family][5])
            single[name] = {"jax_loss": float(jl),
                            "jax_logits": np.asarray(jlogits),
                            "jax_grads": _by_name(port, _np(jgrads)),
                            "logits": logits, "loss": loss, "grads": grads,
                            "sketched": _sketched(port)}
        ref["single"] = single
        for name, family, cfg, base in (
                ("tp_flash_r", "roberta", R_FLASH_CFG, "tp_r"),
                ("tp_flash_gpt", "gpt", GPT_FLASH_CFG, "tp_gpt")):
            port = _port_single(family, cfg, inits[base][1])
            logits, loss, grads = _port_loss_grads(port, batches[base],
                                                   FAMILIES[family][5])
            ref[name] = {"logits": logits, "loss": loss, "grads": grads}
        ref["tp_flash_gpt"]["jax_tp"] = _tp_jax("gpt", GPT_FLASH_CFG,
                                                trees["tp_gpt"],
                                                batches["tp_gpt"])
        ref["tp_clip"] = _port_clip(inits["tp_r"][1], batches["tp_r"])
        ref["jax_clip"] = {
            clip: _jax_tp_updates(trees["tp_cfg"], batches["tp_cfg"], clip)
            for clip in (None, CLIP_TRAIN["max_grad_norm"])}
        ref["dropout"] = dict(tree=inits["tp_cfg"][1],
                              batch=batches["tp_cfg"])
        ref["dp_r"] = _dp_reference(inits["dp_r"][0], trees["dp_r"],
                                    batches["dp_r"])
        ref["dp_gpt"] = _lm_reference(inits["dp_gpt"][0], trees["dp_gpt"],
                                      batches["dp_gpt"])
        outs = [(p.communicate(timeout=WORKER_TIMEOUT)[0], p.returncode)
                for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (out, rc) in enumerate(outs):
        assert rc == 0, f"worker {rank} failed (rc {rc}):\n{out}"
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return ref, ranks


def _sketched(model):
    """Names of the weights whose gradient goes through a sketch."""
    out = set()
    for name, m in model.named_modules():
        if getattr(m, "proj_dim_ratio", None):
            out |= {f"{name}.{leaf}" for leaf in ("weight", "up_weight",
                                                  "down_weight")
                    if hasattr(m, leaf)}
    return out


def _gathered(ranks, case, key="grads"):
    return {n: t.numpy() for n, t in tpar.gather_tp_params(
        [ranks[0][case][key], ranks[1][case][key]]).items()}


# ---------------------------------------------------------------------------
# Pure functions against JAX's.
# ---------------------------------------------------------------------------


def test_exports_match_jax():
    """The JAX package's parallel names, less those that read XLA's HLO or
    the TPU topology; ``fold_shard_key`` is ``fold_shard_generator`` and
    ``state_specs`` has no counterpart (a torch optimizer's moments follow
    their local parameters)."""
    import fewbit_tpu.parallel
    import fewbit_tpu_torch

    theirs = {n for n in dir(fewbit_tpu.parallel) if not n.startswith("_")
              and callable(getattr(fewbit_tpu.parallel, n))}
    tpu_only = {"collective_groups", "assert_pod_collective_layout",
                "assert_collective_compute_overlap", "tpu_aot_mesh"}
    renamed = {"fold_shard_key": "fold_shard_generator", "state_specs": None}
    want = {renamed.get(n, n) for n in theirs - tpu_only} - {None}
    assert want <= set(tpar.__all__)
    assert all(hasattr(tpar, n) for n in tpar.__all__)
    assert fewbit_tpu_torch.parallel is tpar


@pytest.mark.parametrize("n,tp,hosts", [(8, 2, 2), (8, 1, 4), (8, 1, None),
                                        (16, 4, 2)])
def test_pod_mesh_spec_matches_jax(n, tp, hosts):
    assert tpar.pod_mesh_spec(n, tp=tp, hosts=hosts) == jpar.pod_mesh_spec(
        n, tp=tp, hosts=hosts)


@pytest.mark.parametrize("n,tp,hosts", [(8, 2, 3), (8, 3, 2), (8, 8, 2),
                                        (8, 0, None)])
def test_pod_mesh_spec_rejects_like_jax(n, tp, hosts):
    for spec in (jpar.pod_mesh_spec, tpar.pod_mesh_spec):
        with pytest.raises(ValueError):
            spec(n, tp=tp, hosts=hosts)


@pytest.mark.parametrize("host_of", [[0] * 8, [0, 0, 1, 1], [1, 0, 1, 0, 2]])
def test_host_groups_match_jax(host_of):
    devices = [types.SimpleNamespace(id=i, process_index=h)
               for i, h in enumerate(host_of)]
    want = [[d.id for d in g] for g in jax_host_groups(devices)]
    assert tpar.host_groups(host_of) == want


@pytest.mark.parametrize("tp,hosts", [(2, 2), (1, 4), (4, None), (2, None)])
def test_pod_rank_grid_is_jax_pod_mesh(tp, hosts):
    """The host-major grid of ranks is the JAX package's pod mesh, device
    for rank: every tp row inside one (simulated) host."""
    devices = jax.devices()[:8]
    mesh = jpar.make_pod_mesh(tp=tp, hosts=hosts, devices=devices)
    want = np.vectorize(devices.index, otypes=[int])(mesh.devices)
    got = tpar.pod_rank_grid([0] * 8, tp=tp, hosts=hosts)
    np.testing.assert_array_equal(got, want)
    # Two real hosts of four ranks give the same grid as the simulated
    # partition.
    if hosts == 2:
        np.testing.assert_array_equal(
            tpar.pod_rank_grid([0] * 4 + [1] * 4, tp=tp), want)
    with pytest.raises(ValueError):
        jpar.make_pod_mesh(tp=1, hosts=4, devices=jax.devices()[:6])
    with pytest.raises(ValueError):
        tpar.pod_rank_grid([0] * 6, tp=1, hosts=4)


def test_init_distributed_single_process_noop(monkeypatch):
    for name in ("FEWBIT_COORDINATOR", "FEWBIT_NUM_PROCESSES",
                 "FEWBIT_PROCESS_ID", "MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    assert tpar.init_distributed() == jpar.init_distributed() == (0, 1)
    assert tpar.init_distributed() == (0, 1)  # idempotent
    assert not torch.distributed.is_initialized()
    mesh = tpar.make_pod_mesh()
    assert mesh.shape == {"dp": 1, "tp": 1} and mesh.dp_group is None


def _jax_tree(family, cfg, tp):
    jcls, jmodel = FAMILIES[family][:2]
    model = jmodel(jcls(**cfg, tp_axis="tp" if tp > 1 else None, tp_size=tp))
    ids = jnp.zeros((2, 16), jnp.int32)
    return jax.eval_shape(lambda k: model.init(
        {"params": k}, ids, jnp.ones_like(ids), deterministic=True),
        jax.random.key(0))["params"]


SPEC_CASES = {"roberta_fused_dense_act": ("roberta", TP_CFG),
              "roberta_fewbit_ffn": ("roberta", R_CFG),
              "roberta_unfused": ("roberta", SIGNS_CFG),
              "gpt": ("gpt", GPT_CFG)}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_tp_param_spec_matches_jax(case):
    """Every leaf of the JAX tp tree: the port's rule gives JAX's spec,
    but for the fused FFN's leaves (``ffn/*``), which JAX replicates (F-8)
    and the port splits."""
    family, cfg = SPEC_CASES[case]
    tree = _jax_tree(family, cfg, 2)
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    ffn = 0
    for path, leaf in leaves:
        want = tuple(jpar.tp_param_spec(path, leaf))
        want += (None,) * (leaf.ndim - len(want))
        got = tpar.tp_param_spec(path, leaf)
        assert len(got) == leaf.ndim
        if any(getattr(k, "key", None) == "ffn" for k in path):
            ffn += 1
            assert all(s is None for s in want)   # JAX: replicated
            assert got.count("tp") == 1           # the port: split
        else:
            assert got == want, path
    assert ffn == (3 * cfg["num_layers"] if case == "roberta_fewbit_ffn"
                   else 0)


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_shard_and_gather_tp_params(case):
    """A single-device state cut by ``shard_tp_params`` fits the tp
    model's parameters name for name and shape for shape, and
    ``gather_tp_params`` gives it back exactly."""
    family, cfg = SPEC_CASES[case]
    cfg_cls, model_cls = FAMILIES[family][3:5]
    single = model_cls(cfg_cls(**cfg), device="cpu",
                       generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in single.parameters():
            p.add_(torch.rand(p.shape, generator=torch.Generator()
                              .manual_seed(p.numel())))
    tp = model_cls(cfg_cls(**cfg, tp_axis="tp", tp_size=2), device="cpu")
    state = single.state_dict()
    shards = [tpar.shard_tp_params(state, r, 2) for r in range(2)]
    want = {n: tuple(t.shape) for n, t in tp.state_dict().items()}
    for shard in shards:
        assert {n: tuple(t.shape) for n, t in shard.items()} == want
    tp.load_state_dict(shards[1])
    back = tpar.gather_tp_params(shards)
    assert list(back) == list(state)
    for name, t in state.items():
        assert torch.equal(back[name], t), name
    # A tp slice without its group refuses to run.
    ids = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(RuntimeError, match="tp_group"):
        tp(ids)


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_kernel1_gate_at_tp_widths(tp):
    """Kernel 1 takes the tp=2 projections (768 -> 384, 384 -> 768) and,
    as in the JAX package, not the tp=4 ones (192 wide: plain path)."""
    n, k = 8192, 1638
    for kdim, m in ((768, 768 // tp), (768 // tp, 768)):
        for dt, jdt in ((torch.float32, jnp.float32),
                        (torch.bfloat16, jnp.bfloat16)):
            got = K.matmul_sketch_keff(n, kdim, m, k, dt)
            assert got == jax_kernels.matmul_sketch_keff(n, kdim, m, k, jdt)
            assert (got is None) == (tp == 4)


def test_validate_tp_config():
    for cfg_cls in (RobertaConfig, GPTConfig):
        cfg = cfg_cls(tp_axis="tp", tp_size=4)
        assert cfg.num_heads // cfg.tp_size == 3
        for kw in (dict(tp_size=2), dict(tp_axis="tp"),
                   dict(tp_axis="tp", tp_size=5), dict(tp_size=0)):
            with pytest.raises(ValueError):
                cfg_cls(**kw)


# ---------------------------------------------------------------------------
# The multi-process runs.
# ---------------------------------------------------------------------------


def test_tp_logits_and_loss_match_jax(runs):
    ref, ranks = runs
    single = ref["single"]["tp_cfg"]
    for rank in ranks[:2]:
        got = rank["tp_cfg"]
        np.testing.assert_allclose(got["logits"].numpy(), single["logits"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["logits"].numpy(),
                                   single["jax_logits"], rtol=1e-5, atol=1e-6)
        for want in (ref["tp_cfg"]["step_loss"], single["jax_loss"],
                     single["loss"]):
            np.testing.assert_allclose(got["loss"].item(), want, rtol=1e-5)


@pytest.mark.parametrize("against", ["port", "jax"])
def test_tp_gradients_match_single_device(runs, against):
    ref, ranks = runs
    single = ref["single"]["tp_cfg"]
    want = (single["jax_grads"] if against == "jax" else
            {n: g.numpy() for n, g in single["grads"].items()})
    got = _gathered(ranks, "tp_cfg")
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g, want[name], rtol=0, atol=1e-5,
                                   err_msg=name)


def test_jax_tp_gradients_are_doubled(runs):
    """F-7, the reference's fault: JAX's tp step (``make_train_step(
    dp_axis="dp")`` under ``shard_map(check_vma=False)``) has the right
    loss, but the gradients of its sharded kernels are exactly twice the
    single-device ones; the classification head's, above every psum, are
    right."""
    ref, _ = runs
    tp = ref["tp_cfg"]
    np.testing.assert_allclose(tp["shard_map_loss"],
                               ref["single"]["tp_cfg"]["jax_loss"], rtol=1e-5)
    single = ref["single"]["tp_cfg"]["jax_grads"]
    port = RobertaForSequenceClassification(RobertaConfig(**TP_CFG),
                                            device="cpu")
    jax_tp = _by_name(port, _single_tree(tp["grads"]))
    ratios = {name: np.linalg.norm(g) / np.linalg.norm(single[name])
              for name, g in jax_tp.items()}
    sharded = [n for n in ratios if n.endswith(".weight") and any(
        f".{m}." in n for m in ("query", "key", "value", "output",
                                "intermediate", "ffn_output"))]
    assert len(sharded) == 6 * TP_CFG["num_layers"]
    for name in sharded:
        assert abs(ratios[name] - 2.0) < 1e-4, (name, ratios[name])
    for name in ("head_dense.weight", "head_out.weight"):
        assert abs(ratios[name] - 1.0) < 1e-5, (name, ratios[name])


def test_tp_path_r_is_a_sharding_of_single_device_r(runs):
    """F-8: the fused FFN split over tp; logits, loss and every gradient,
    the sketched ones included (one sketch generator), equal the port's
    single-device R; the logits, the loss and every unsketched gradient
    equal JAX's single-device R."""
    ref, ranks = runs
    single = ref["single"]["tp_r"]
    jl, jlogits = single["jax_loss"], single["jax_logits"]
    for rank in ranks[:2]:
        got = rank["tp_r"]
        np.testing.assert_allclose(got["logits"].numpy(), single["logits"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["logits"].numpy(), jlogits,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["loss"].item(), jl, rtol=1e-5)
    grads = _gathered(ranks, "tp_r")
    assert {"roberta.layers.0.ffn.up_weight",
            "roberta.layers.0.ffn.down_bias"} <= set(grads)
    assert len(single["sketched"]) == 6 * R_CFG["num_layers"] + 2
    for name, g in grads.items():
        np.testing.assert_allclose(g, single["grads"][name].numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)
        if name not in single["sketched"]:
            np.testing.assert_allclose(g, single["jax_grads"][name], rtol=0,
                                       atol=1e-5, err_msg=name)


def test_tp_gpt_forward_matches_jax_tp(runs):
    """GPT few-bit at tp=2: JAX shards its FFN correctly, so its tp
    forward is a parity target; the gradients equal the single-device
    ones (the port's, and JAX's where no sketch estimates them)."""
    ref, ranks = runs
    single = ref["single"]["tp_gpt"]
    for rank in ranks[:2]:
        got = rank["tp_gpt"]
        np.testing.assert_allclose(got["logits"].numpy(),
                                   ref["tp_gpt"]["logits"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got["loss"].item(), single["jax_loss"],
                                   rtol=1e-5)
    grads = _gathered(ranks, "tp_gpt")
    assert len(single["sketched"]) == 6 * GPT_CFG["num_layers"]
    for name, g in grads.items():
        np.testing.assert_allclose(g, single["grads"][name].numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)
        if name not in single["sketched"]:
            np.testing.assert_allclose(g, single["jax_grads"][name], rtol=0,
                                       atol=1e-5, err_msg=name)


def test_dp_gradients_are_the_mean_of_shard_gradients(runs):
    """The twin of ``tests/test_parallel.py``'s shard-gradient test at
    dp=2: ``replicate`` made rank 1's (moved) weights rank 0's; each
    rank's gradient (after DDP's average) equals the mean of the two
    half-batch gradients, JAX's and the port's with the ranks' folded
    generators; the loss equals JAX's ``data_parallel_step``'s."""
    ref, ranks = runs
    want = ref["dp_r"]
    for name, t in ranks[0]["dp_r"]["replicated"].items():
        assert torch.equal(t, ranks[1]["dp_r"]["replicated"][name]), name
    for rank in ranks[:2]:
        got = rank["dp_r"]
        np.testing.assert_allclose(got["loss"].item(), want["loss"],
                                   rtol=1e-5)
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), want["jax_grads"][name],
                                       rtol=0, atol=1e-5, err_msg=name)
            np.testing.assert_allclose(g.numpy(),
                                       want["port_grads"][name].numpy(),
                                       rtol=0, atol=1e-5, err_msg=name)


def test_dp_token_weighted_causal_loss(runs):
    """The twin of ``tests/test_parallel.py``'s token-weighted loss: with
    unequal valid tokens per dp rank the loss and the gradients equal the
    full batch's in one process, and the loss JAX's dp step's."""
    ref, ranks = runs
    want = ref["dp_gpt"]
    np.testing.assert_allclose(want["dp_loss"], want["loss"], rtol=1e-6)
    for rank in ranks[:2]:
        got = rank["dp_gpt"]
        np.testing.assert_allclose(got["loss"].item(), want["loss"],
                                   rtol=1e-6)
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), want["grads"][name],
                                       rtol=0, atol=2e-6, err_msg=name)


def test_dp_tp_step_runs(runs):
    """dp=2 x tp=2: the step runs on the four ranks with one loss; the
    gathered ``intermediate`` weight is (2, 32, 64) in JAX's layout
    (layers, in, out); the dp replicas hold the same parameters."""
    _, ranks = runs
    losses = {r["dp_tp"]["loss"].item() for r in ranks}
    assert len(losses) == 1 and np.isfinite(losses.pop())
    grid = {(r["dp_rank"], r["tp_rank"]): r["dp_tp"]["state"] for r in ranks}
    gathered = tpar.gather_tp_params([grid[0, 0], grid[0, 1]])
    inter = np.stack([gathered[f"roberta.layers.{i}.intermediate.weight"]
                      .numpy().T for i in range(TP_CFG["num_layers"])])
    assert inter.shape == (2, 32, 64)
    for tp in range(2):
        for name, t in grid[0, tp].items():
            assert torch.equal(t, grid[1, tp][name]), name


def test_init_dp_tp_state_draws(runs):
    """``init_dp_tp_state`` on dp=2 x tp=2: the tp ranks hold the same
    replicated parameters and different slices of each split weight (the
    split biases zero); the dp replicas hold the same parameters; the
    gathered state has the single-device model's names and shapes."""
    _, ranks = runs
    grid = {(r["dp_rank"], r["tp_rank"]): r["dp_tp"]["init"] for r in ranks}
    split = 0
    for name, t in grid[0, 0].items():
        other = grid[0, 1][name]
        if "tp" in tpar.tp_param_spec(name, t):
            if t.ndim > 1:
                split += 1
                assert not torch.equal(t, other), name
            else:
                assert not t.any() and not other.any(), name
        else:
            assert torch.equal(t, other), name
        for tp in range(2):
            assert torch.equal(grid[0, tp][name], grid[1, tp][name]), name
    assert split == 6 * TP_CFG["num_layers"]
    single = RobertaForSequenceClassification(RobertaConfig(**TP_CFG),
                                              device="cpu")
    gathered = tpar.gather_tp_params([grid[0, 0], grid[0, 1]])
    assert {n: tuple(t.shape) for n, t in gathered.items()} == {
        n: tuple(t.shape) for n, t in single.state_dict().items()}


def test_tp_attention_dropout_shares_masks(runs, monkeypatch):
    """tp=2 with attention dropout on: each rank draws its local heads'
    mask from the generator the tp ranks share, as the JAX package's tp
    does, so head h and head h + H/2 drop alike.  The tp forward and its
    gathered gradients equal the single-device model's whose mask for
    the second half of the heads repeats the first half's (rtol / atol
    1e-5); with the single device's own mask the logits differ."""
    from fewbit_tpu_torch.models import roberta

    ref, ranks = runs
    plain = roberta.dropout

    def shared_over_tp(x, p, deterministic, generator=None):
        if deterministic or p == 0.0 or x.ndim != 4:
            return plain(x, p, deterministic, generator)
        b, h, q, k = x.shape
        keep = torch.rand((b, h // 2, q, k), generator=generator) >= p
        return x * keep.repeat(1, 2, 1, 1) * (1.0 / (1.0 - p))

    def single_run():
        model = _port_single("roberta", DROPOUT_CFG, ref["dropout"]["tree"])
        b = {k: torch.from_numpy(np.asarray(v)).long()
             for k, v in ref["dropout"]["batch"].items()}
        logits = model(b["input_ids"], b["attention_mask"],
                       deterministic=False,
                       dropout_generator=torch.Generator().manual_seed(
                           DROPOUT_SEED),
                       sketch_generator=torch.Generator().manual_seed(
                           SKETCH_SEED))
        classification_loss(logits, b["labels"]).backward()
        return logits.detach().numpy(), {
            n: p.grad.numpy() for n, p in model.named_parameters()}

    own, _ = single_run()
    monkeypatch.setattr(roberta, "dropout", shared_over_tp)
    want, grads = single_run()
    for r in ranks[:2]:
        got = r["tp_dropout"]["logits"].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        assert np.abs(got - own).max() > 1e-3
    gathered = _gathered(ranks, "tp_dropout")
    assert set(gathered) == set(grads)
    for name, g in grads.items():
        np.testing.assert_allclose(gathered[name], g, rtol=0, atol=1e-5,
                                   err_msg=name)


def test_sketch_signs_fold_by_dp_not_tp(runs):
    """Each dp rank draws its own sketch signs (the generator folded by
    the dp rank); the tp ranks of one dp rank draw the same."""
    _, ranks = runs
    signs = {(r["dp_rank"], r["tp_rank"]): r["signs"]["signs"]
             for r in ranks}
    assert len(signs[0, 0]) == 6 * SIGNS_CFG["num_layers"] + 2
    for dp in range(2):
        for a, b in zip(signs[dp, 0], signs[dp, 1]):
            assert torch.equal(a, b)
    # Each layer's projections draw 32 signs; the head's 2 (the <s> rows).
    layers = [(a, b) for a, b in zip(signs[0, 0], signs[1, 0])
              if a.numel() == 32]
    assert len(layers) == 6 * SIGNS_CFG["num_layers"]
    for a, b in layers:
        assert not torch.equal(a, b)


@pytest.mark.parametrize("family", ["roberta", "gpt"])
def test_tp_flash_matches_single_device(runs, family):
    """R and GPT at tp=2 with ``flash_attention=True``: each rank's local
    heads through the flash op.  Logits, loss and every gathered gradient
    equal the port's single-device flash model's; logits, loss and every
    unsketched gradient equal JAX's single-device model's (JAX takes the
    standard attention off the TPU: flash and standard agree but at
    padded query rows, which no logit reads); GPT's logits equal JAX's tp
    forward with the same config.  JAX's tp R is no target (F-8)."""
    ref, ranks = runs
    name, base = (("tp_flash_r", "tp_r") if family == "roberta" else
                  ("tp_flash_gpt", "tp_gpt"))
    want, single = ref[name], ref["single"][base]
    for rank in ranks[:2]:
        got = rank[name]
        for logits in (want["logits"], single["jax_logits"],
                       rank[base]["logits"].numpy()):
            np.testing.assert_allclose(got["logits"].numpy(), logits,
                                       rtol=1e-5, atol=1e-5)
        for loss in (want["loss"], single["jax_loss"]):
            np.testing.assert_allclose(got["loss"].item(), loss, rtol=1e-5)
        if family == "gpt":
            np.testing.assert_allclose(got["logits"].numpy(),
                                       want["jax_tp"]["logits"], rtol=1e-5,
                                       atol=1e-5)
    grads = _gathered(ranks, name)
    assert set(grads) == set(want["grads"])
    for g_name, g in grads.items():
        np.testing.assert_allclose(g, want["grads"][g_name].numpy(), rtol=0,
                                   atol=1e-5, err_msg=g_name)
        if g_name not in single["sketched"]:
            np.testing.assert_allclose(g, single["jax_grads"][g_name],
                                       rtol=0, atol=1e-5, err_msg=g_name)


def _rel(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def test_tp_clip_matches_single_device(runs):
    """``max_grad_norm`` at tp=2: clipping is active on every step, both
    ranks see the unsharded model's norm (the single device's), the
    gathered clipped gradients and the three steps' updates equal the
    single device's.  Each rank's own norm is below the global one, so a
    rank clipping by it alone would scale by another factor."""
    ref, ranks = runs
    want, bound = ref["tp_clip"], CLIP_TRAIN["max_grad_norm"]
    assert len(want["norms"]) == CLIP_STEPS
    for rank in ranks[:2]:
        got = rank["tp_clip"]
        assert len(got["norms"]) == CLIP_STEPS
        for a, b in zip([got["norm"], *got["norms"]],
                        [want["norm"], *want["norms"]]):
            assert b.item() > 10 * bound
            np.testing.assert_allclose(a.item(), b.item(), rtol=1e-5)
        assert got["local_norm"].item() < 0.99 * want["norm"].item()
        np.testing.assert_allclose(torch.stack(got["losses"]).numpy(),
                                   torch.stack(want["losses"]).numpy(),
                                   rtol=1e-5)
    clipped = _gathered(ranks, "tp_clip", "clipped")
    assert set(clipped) == set(want["clipped"])
    total = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                        for g in clipped.values()))
    np.testing.assert_allclose(total, bound, rtol=1e-5)
    for name, g in clipped.items():
        np.testing.assert_allclose(g, want["clipped"][name].numpy(), rtol=0,
                                   atol=1e-5 * bound, err_msg=name)
    # The replicated leaves move alike on both ranks.
    for name, u in ranks[0]["tp_clip"]["updates"].items():
        if "tp" not in tpar.tp_param_spec(name, u):
            assert torch.equal(u, ranks[1]["tp_clip"]["updates"][name]), name
    updates = _gathered(ranks, "tp_clip", "updates")
    moved = 0
    for name, u in updates.items():
        w = want["updates"][name].numpy()
        moved += bool(np.abs(w).max() > 0)
        np.testing.assert_allclose(u, w, rtol=0, atol=1e-6, err_msg=name)
    assert moved == len(updates)


def test_jax_tp_clip_diverges_replicas(runs):
    """F-10, the reference's fault: JAX's tp step clips inside
    ``shard_map``, each rank by the norm of its own gradients, so the
    ranks scale by different factors.  The head's leaves, above every
    psum, get the same update on both ranks without clipping and
    different ones with it.  The replicated leaves below a psum
    (embeddings, LayerNorms, the row-parallel biases) differ on the two
    ranks with or without clipping: under ``check_vma=False`` their
    gradients are each rank's partial sums (F-7's transposed psum, with no
    all-reduce in front of the column-parallel projections)."""
    ref, _ = runs
    head, below = {}, {}
    for clip, leaves in ref["jax_clip"].items():
        rows = [("head_" in jax.tree_util.keystr(path), _rel(u[1], u[0]))
                for path, u in leaves
                if "tp" not in jpar.tp_param_spec(path, u[0])]
        head[clip] = max(r for top, r in rows if top)
        below[clip] = min(r for top, r in rows if not top)
        assert sum(top for top, _ in rows) == 4 and len(rows) > 10
    clip = CLIP_TRAIN["max_grad_norm"]
    assert head[None] == 0.0 and head[clip] > 1e-4, head
    assert below[None] > 0.5 and below[clip] > 0.5, below
