"""The bf16 main path against the JAX package on the CPU: RoBERTa vanilla,
RoBERTa few-bit (fused FFN, countsketch: kernels 1, 2 and 3) and GPT
few-bit (kernel 6), each at seeds 0, 1 and 2 for the weights and the
batch, at the small widths of ``tests/test_torch_models.py`` and
``tests/test_torch_gpt.py`` with dropout off.

The truth is JAX's f32 run of the same weights.  The port's bf16 run is
held against it by the size of JAX's own bf16 error against the same
truth, on quantities joined over the model (one leaf alone may land by
chance far nearer f32 in one package than in the other):

* the RMS of the logits' error, at most ``RATIO`` times JAX's;
* the relative 2-norm of the error of every unsketched gradient, joined
  into one vector, at most ``RATIO`` times JAX's;
* the sketched weight gradients (each package draws its own random
  signs), joined: the relative 2-norm of the port's bf16 run against the
  port's f32 run, at most ``RATIO`` times that of JAX's bf16 run against
  JAX's f32 run (each side against its own truth);
* the loss within ``LOSS_TOL`` of JAX's f32 loss;
* every gradient finite and of JAX's shape;
* the codes of layer 0's FFN, by each package's kernel (plain version or
  Pallas in interpret mode): on JAX's bf16 input, equal but where JAX's
  pre-activation lies within ``FLIP_BAND`` of a border, on at most
  ``FLIP_FRACTION`` of them; on each package's own bf16 input, different
  only where a border lies between the two pre-activations.

Weights are drawn with numpy into ``jax.eval_shape`` trees (nonzero biases
and LayerNorm scales off 1, so that a dropped bias shows); JAX's layers are
unrolled (a scanned body fuses otherwise and flips more codes).
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as TF

import jax
import jax.numpy as jnp

import test_torch_gpt as TG
import test_torch_models as TM
from fewbit_tpu.functional.activations import \
    resolve_activation as jax_resolve_activation
from fewbit_tpu.models import GPTConfig as JaxGPTConfig
from fewbit_tpu.models import GPTForCausalLM as JaxGPT
from fewbit_tpu.models import RobertaConfig as JaxRobertaConfig
from fewbit_tpu.models import RobertaForSequenceClassification as JaxRoberta
from fewbit_tpu.ops import pallas_kernels as pk
from fewbit_tpu.train import causal_lm_loss as jax_lm_loss
from fewbit_tpu.train.loop import classification_loss as jax_cls_loss

from fewbit_tpu_torch.functional.activations import resolve_activation
from fewbit_tpu_torch.models import (GPTConfig, GPTForCausalLM,
                                     RobertaConfig,
                                     RobertaForSequenceClassification,
                                     flax_param_pairs, load_flax_params)
from fewbit_tpu_torch.models.roberta import LayerNorm
from fewbit_tpu_torch.ops import kernels as K
from fewbit_tpu_torch.ops.bitpack import unpack_codes
from fewbit_tpu_torch.train import causal_lm_loss, classification_loss

RATIO = 2.5
LOSS_TOL = 1e-2
# As chip_smoke.py holds a kernel's codes against its plain version's.
FLIP_BAND, FLIP_FRACTION = 1e-3, 1e-4
SEEDS = (0, 1, 2)

FAMILIES = {
    "roberta": dict(jax=(JaxRobertaConfig, JaxRoberta, jax_cls_loss),
                    port=(RobertaConfig, RobertaForSequenceClassification,
                          classification_loss),
                    tests=TM, ffn_input="attention_norm"),
    "gpt": dict(jax=(JaxGPTConfig, JaxGPT, jax_lm_loss),
                port=(GPTConfig, GPTForCausalLM, causal_lm_loss),
                tests=TG, ffn_input="ffn_norm"),
}
CASES = {"roberta_vanilla": ("roberta", {}),
         "roberta_fewbit": ("roberta", TM.FEWBIT),
         "gpt_fewbit": ("gpt", TG.FEWBIT)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs (the test workers share
    the cores; small ops stall on many threads)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("FEWBIT_TPU_NATIVE", "interpret")


def _config(case, side, dtype):
    family, extra = CASES[case]
    return FAMILIES[family][side][0](
        **FAMILIES[family]["tests"].SMALL, **extra, dtype=dtype,
        scan_layers=False)


@functools.lru_cache(maxsize=None)
def _jax_fn(case, dtype):
    """JAX's jitted ``(params, batch) -> ((loss, (logits, ffn_in)),
    grads)`` for a case in ``dtype``, ``ffn_in`` the input of layer 0's
    FFN."""
    family = FAMILIES[CASES[case][0]]
    model = family["jax"][1](_config(case, "jax", dtype))
    loss_fn, norm = family["jax"][2], family["ffn_input"]

    def loss(p, b):
        logits, state = model.apply(
            {"params": p}, b["input_ids"], b["attention_mask"],
            deterministic=True, rngs={"sketch": jax.random.key(2)},
            capture_intermediates=lambda m, _: m.name == norm,
            mutable=["intermediates"])
        return loss_fn(logits, b["labels"]), (logits, _captured(
            state["intermediates"], norm))

    return model, jax.jit(jax.value_and_grad(loss, has_aux=True))


def _captured(tree, name):
    """The captured output of ``layer_0/<name>`` in an intermediates
    tree."""
    for key, sub in tree.items():
        if key == "layer_0":
            return sub[name]["__call__"][0]
        if isinstance(sub, dict) and key != name:
            found = _captured(sub, name)
            if found is not None:
                return found
    return None


def _draw_params(case, seed):
    """Weights drawn with numpy from ``seed`` into JAX's tree: kernels
    normal with variance 1 / fan-in, embeddings at 0.5, biases at 0.1,
    LayerNorm scales 1 + 0.1 normal."""
    model, _ = _jax_fn(case, jnp.float32)
    b = _batch(case, seed)
    shapes = jax.eval_shape(lambda k: model.init(
        {"params": k}, b["input_ids"], b["attention_mask"],
        deterministic=True), jax.random.key(0))["params"]
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


def _batch(case, seed):
    tests = FAMILIES[CASES[case][0]]["tests"]
    return {k: jnp.asarray(v) for k, v in tests._batch(seed).items()}


@functools.lru_cache(maxsize=None)
def _jax_runs(case, seed):
    """JAX's f32 and bf16 runs of a case: loss, logits and gradients as
    numpy f32 (f64 loss), and layer 0's FFN input in bf16."""
    params = _draw_params(case, seed)
    b = _batch(case, seed)
    out = {}
    for dt in (jnp.float32, jnp.bfloat16):
        (loss, (logits, ffn_in)), grads = _jax_fn(case, dt)[1](params, b)
        out[dt] = dict(loss=float(loss),
                       logits=np.asarray(logits, np.float32),
                       grads=jax.tree_util.tree_map(
                           lambda g: np.asarray(g, np.float32), grads),
                       ffn_in=ffn_in)
    return jax.tree_util.tree_map(np.asarray, params), out


def _port_model(case, seed, dtype=torch.bfloat16):
    params, _ = _jax_runs(case, seed)
    family = FAMILIES[CASES[case][0]]
    model = family["port"][1](_config(case, "port", dtype), device="cpu")
    load_flax_params(model, params)
    return model


@functools.lru_cache(maxsize=None)
def _port_f32_grads(case, seed):
    """The port's f32 gradients of a case, as numpy, in the order of
    ``flax_param_pairs``: the truth of the port's sketched weights."""
    model = _port_model(case, seed, torch.float32)
    _port_run(case, seed, model)
    return [p.grad.numpy() for p, _ in flax_param_pairs(
        model, _jax_runs(case, seed)[1][jnp.float32]["grads"])]


def _first_layer(model):
    return (model.roberta if hasattr(model, "roberta")
            else model.transformer).layers[0]


def _port_run(case, seed, model):
    """The port's bf16 step: loss, logits (f32), and layer 0's FFN input
    (bf16), the gradients left on the parameters."""
    family = FAMILIES[CASES[case][0]]
    tb = family["tests"]._torch_batch(family["tests"]._batch(seed))
    layer = _first_layer(model)
    ffn = layer.ffn if hasattr(layer, "ffn") else layer.intermediate
    seen = []
    hook = ffn.register_forward_pre_hook(
        lambda m, args: seen.append(args[0].detach()))
    try:
        model.zero_grad(set_to_none=True)
        logits = model(tb["input_ids"], tb["attention_mask"],
                       sketch_generator=torch.Generator().manual_seed(2))
        loss = family["port"][2](logits, tb["labels"])
        loss.backward()
    finally:
        hook.remove()
    return loss.item(), logits.detach().float().numpy(), seen[0]


def _sketched(case, model):
    """The weights whose gradient goes through a sketch."""
    family, extra = CASES[case]
    if not extra.get("proj_dim_ratio"):
        return set()
    if family == "roberta":
        return TM._sketched(model)
    return {id(p) for name, p in model.named_parameters()
            if name.endswith(".weight") and any(
                k in name for k in ("query", "key", "value", "output.",
                                    "intermediate", "ffn_output"))}


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


def _rel(a, truth):
    return np.linalg.norm(a - truth) / np.linalg.norm(truth)


def _readings(case, seed, model):
    """The port's bf16 step against JAX's: the three error ratios (the
    sketched one None where nothing is sketched), the loss's distance from
    JAX's f32 loss, and layer 0's FFN input."""
    _, runs = _jax_runs(case, seed)
    f32, bf16 = runs[jnp.float32], runs[jnp.bfloat16]
    loss, logits, ffn_in = _port_run(case, seed, model)
    assert logits.shape == f32["logits"].shape
    sketched = _sketched(case, model)
    port32 = _port_f32_grads(case, seed) if sketched else None
    # (port bf16, JAX bf16, JAX f32[, port f32]) per group of leaves.
    joined = {"plain": ([], [], []), "sketched": ([], [], [], [])}
    for i, ((param, want), (_, jax16)) in enumerate(zip(
            flax_param_pairs(model, f32["grads"]),
            flax_param_pairs(model, bf16["grads"]))):
        got = param.grad.numpy()
        assert got.shape == want.shape == jax16.shape
        assert np.isfinite(got).all()
        group = "sketched" if id(param) in sketched else "plain"
        leaves = (got, jax16, want) + ((port32[i],) if sketched else ())
        for into, leaf in zip(joined[group], leaves):
            into.append(leaf.ravel())
    ours, theirs, truth = map(np.concatenate, joined["plain"])
    ratio = None
    if sketched:
        ours_s, theirs_s, jax32_s, port32_s = map(np.concatenate,
                                                   joined["sketched"])
        ratio = _rel(ours_s, port32_s) / _rel(theirs_s, jax32_s)
    # Relative errors against one truth: their ratio is that of the norms.
    return dict(
        logits=_rms(logits - f32["logits"]) / _rms(bf16["logits"]
                                                   - f32["logits"]),
        grads=np.linalg.norm(ours - truth) / np.linalg.norm(theirs - truth),
        sketched=ratio, loss=abs(loss - f32["loss"]), ffn_in=ffn_in)


def _fmt(ratio):
    return "none" if ratio is None else f"{ratio:.3f}"


def _check(r):
    assert r["logits"] <= RATIO, r
    assert r["grads"] <= RATIO, r
    assert r["sketched"] is None or r["sketched"] <= RATIO, r
    assert r["loss"] <= LOSS_TOL, r


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", list(CASES))
def test_bf16_step_matches_jax(case, seed):
    model = _port_model(case, seed)
    r = _readings(case, seed, model)
    print(f"{case} seed {seed}: logits ratio {r['logits']:.3f}, gradients "
          f"ratio {r['grads']:.3f}, sketched gradients ratio "
          f"{_fmt(r['sketched'])}, |loss - f32 loss| {r['loss']:.3g}")
    _check(r)
    if CASES[case][1]:
        _check_codes(case, seed, model, r["ffn_in"])


def _ffn_codes(model, xs, jx):
    """Layer 0's FFN codes, ``(N, M)``: the port's kernel on each bf16
    input of ``xs`` and JAX's on ``jx`` (the same weights), each with its
    pre-activation in f64; and the borders."""
    layer = _first_layer(model)
    fused = hasattr(layer, "ffn")
    mod = layer.ffn if fused else layer.intermediate
    w, b = ((mod.up_weight, mod.up_bias) if fused else
            (mod.weight, mod.bias))
    w, b = w.detach().to(torch.bfloat16), b.detach().to(torch.bfloat16)
    n, m = jx.shape[0], w.shape[0]
    spec, borders, _ = resolve_activation("gelu", bits=3)
    jspec, jborders, _ = jax_resolve_activation("gelu", bits=3)
    jw = jnp.asarray(w.float().t().numpy(), jnp.bfloat16)
    jb = jnp.asarray(b.float().numpy(), jnp.bfloat16)
    k_eff = K.countsketch_aligned_keff(n, n // 4)

    def port(x):
        if fused:
            return K.fused_dense_act_sketch(spec, x, w.t(), b, borders,
                                            torch.ones(n), k_eff)[1]
        return K.fused_dense_act(spec, x, w.t(), b, borders)[1]

    if fused:
        jpacked = pk.fused_dense_act_sketch(
            jspec, jnp.asarray(jx, jnp.bfloat16), jw, jb, jborders,
            jnp.ones((n, 1)), k_eff)[1]
    else:
        jpacked = pk.fused_dense_act(jspec, jnp.asarray(jx, jnp.bfloat16),
                                     jw, jb, jborders)[1]
    assert jpacked is not None  # JAX's kernel took the block

    def z(x):
        return (x.double().numpy() @ w.double().numpy().T
                + b.double().numpy())

    jcodes = np.asarray(pk.unpack_block_layout(jpacked, jspec.bits, (n, m)))
    jz = z(torch.from_numpy(jx).to(torch.bfloat16))
    return ([(unpack_codes(port(x), spec.bits, n).numpy(), z(x))
             for x in xs], (jcodes, jz), borders.double().numpy())


def _check_codes(case, seed, model, port_in):
    """Layer 0's FFN codes against JAX's bf16 codes.  On JAX's bf16 input,
    as ``chip_smoke.py`` holds a kernel against its plain version: equal
    but where JAX's pre-activation lies within FLIP_BAND of a border, on
    at most FLIP_FRACTION of the codes.  On each package's own bf16 input
    (the two differ by bf16 roundings upstream): a code may differ only
    where a border lies between the two pre-activations, within
    FLIP_BAND."""
    jax_in = _jax_runs(case, seed)[1][jnp.bfloat16]["ffn_in"]
    n = port_in.numel() // port_in.shape[-1]
    jx = np.asarray(jax_in, np.float32).reshape(n, -1)
    same = torch.from_numpy(jx).to(torch.bfloat16)
    [(codes, _), (own, zp)], (jcodes, zj), borders = _ffn_codes(
        model, [same, port_in.reshape(n, -1)], jx)
    flips = codes != jcodes
    near = np.abs(zj[flips][:, None] - borders[None, :]).min(1)
    assert near.size == 0 or near.max() <= FLIP_BAND, near.max()
    assert flips.sum() <= FLIP_FRACTION * flips.size, flips.sum()

    moved = own != jcodes
    lo = np.minimum(zp, zj)[moved][:, None] - FLIP_BAND
    hi = np.maximum(zp, zj)[moved][:, None] + FLIP_BAND
    between = ((borders[None, :] >= lo) & (borders[None, :] <= hi)).any(1)
    print(f"{case} seed {seed}: on JAX's input {int(flips.sum())} codes "
          f"differ; on each one's own {int(moved.sum())} of {moved.size}")
    assert between.all(), int((~between).sum())


@pytest.mark.parametrize("case", list(CASES))
def test_a_dropped_layer_norm_bias_exceeds_the_bound(case):
    """The bound can fail: the port's model with layer 0's attention
    LayerNorm bias dropped (zeroed) reads past it."""
    model = _port_model(case, 0)
    with torch.no_grad():
        _first_layer(model).attention_norm.bias.zero_()
    r = _readings(case, 0, model)
    print(f"{case} with a dropped bias: logits ratio {r['logits']:.3f}, "
          f"gradients ratio {r['grads']:.3f}, sketched gradients ratio "
          f"{_fmt(r['sketched'])}")
    with pytest.raises(AssertionError):
        _check(r)


def test_layer_norm_matches_flax_in_bf16():
    """The port's LayerNorm on a bf16 input against flax's
    ``nn.LayerNorm(dtype=bf16)`` with the same f32 scale and bias, and
    both against f64 on the same bf16 input: the output equal to flax's
    (one rounding of an f32 result); the input gradient no further from
    f64 than flax's (flax rounds its two cotangent terms to bf16 before
    adding them; the port rounds once); the parameters' gradients f32, as
    close to f64 as flax's."""
    from flax import linen as fnn

    rng = np.random.RandomState(0)
    x = rng.standard_normal((64, 128)).astype(np.float32) * 3 + 1
    g = rng.standard_normal((64, 128)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(128)).astype(np.float32)
    norm = fnn.LayerNorm(epsilon=1e-5, dtype=jnp.bfloat16)
    params = {"params": {"scale": jnp.asarray(scale),
                         "bias": jnp.asarray(bias)}}
    want, vjp = jax.vjp(lambda p, v: norm.apply(p, v), params,
                        jnp.asarray(x, jnp.bfloat16))
    dp, dx_flax = vjp(jnp.asarray(g, jnp.bfloat16))

    xb = torch.from_numpy(x).to(torch.bfloat16)
    gb = torch.from_numpy(g).to(torch.bfloat16)
    ln = LayerNorm(128, 1e-5, device="cpu")
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
    xt = xb.clone().requires_grad_()
    got = ln(xt)
    got.backward(gb)
    assert got.dtype == xt.grad.dtype == torch.bfloat16
    assert ln.weight.grad.dtype == ln.bias.grad.dtype == torch.float32

    ref = [t.double().requires_grad_() for t in (
        xb, torch.from_numpy(scale), torch.from_numpy(bias))]
    TF.layer_norm(ref[0], (128,), ref[1], ref[2], 1e-5).backward(
        gb.double())

    def err(a, t):
        a = np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                       np.float64)
        t = t.grad.numpy()
        return np.linalg.norm(a - t) / np.linalg.norm(t)

    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want, np.float32))
    assert err(xt.grad, ref[0]) <= err(dx_flax, ref[0])
    for p, name, r in ((ln.weight, "scale", ref[1]),
                       (ln.bias, "bias", ref[2])):
        assert err(p.grad, r) <= max(2 * err(dp["params"][name], r), 1e-6)
