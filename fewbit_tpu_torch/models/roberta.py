"""RoBERTa-base with the few-bit training path, as
``fewbit_tpu/models/roberta.py`` (post-LN layers, a Python loop over the
layers whatever ``scan_layers`` says).

Tensor parallelism (Megatron, :mod:`fewbit_tpu_torch.parallel.tp`): with
``tp_size > 1`` (and ``tp_axis`` naming the axis, as in the JAX config)
the model is one rank's slice, built with the ``tp_group`` it all-reduces
over.  Each rank holds ``num_heads // tp_size`` heads and
``intermediate_size // tp_size`` FFN features: ``query``, ``key``,
``value`` and ``intermediate`` (or the fused FFN's up projection) are
column-parallel behind :func:`~fewbit_tpu_torch.parallel.tp.copy_to_tp`;
``output`` and ``ffn_output`` (or the fused FFN's down projection) are
row-parallel without a bias, followed by
:func:`~fewbit_tpu_torch.parallel.tp.reduce_from_tp` and the bias added
once (``output_bias``, ``ffn_bias``, the JAX names).  Unlike the JAX model
the fused ``FewBitFFN`` is split too, so every tp configuration is a
sharding of the single-device model (F-8 in ``ROADMAP.md``).

``flash_attention`` chooses the attention op per call
(:func:`fewbit_tpu_torch.models.flash.use_flash`): the non-causal flash op
with segment ids from the attention mask, or the standard softmax with the
mask bias.  The two differ only at padded query rows (flash attends pad to
pad, the standard path pad to the real keys); real rows, logits, the loss
and the gradients agree.  ``flash_blocks`` is accepted for parity with the
JAX config and not read: the CUDA kernels choose their own tiles.

Two config switches inject the memory-efficient path, as in the JAX model:

* ``proj_dim_ratio`` -- every projection becomes a ``RandomizedDense``
  whose backward keeps a sketch of its input;
* ``gelu_bits`` -- the FFN's GELU keeps packed ``bits / 8``-byte codes.
  With ``fused_ffn``, ``proj_dim_ratio`` and ``sketch="countsketch"`` the
  FFN is one ``FewBitFFN`` block (sketched weight gradients for both
  projections); with ``fused_ffn`` otherwise, the up projection and GELU
  are one ``FusedDenseActivation`` named ``intermediate``; without
  ``fused_ffn``, ``intermediate`` -> few-bit ``gelu`` -> ``ffn_output``.

The models build on the card unless the caller asks otherwise: ``device``
None is ``"cuda"``, and without a card the constructor raises and names
``device="cpu"``.

``dtype`` is the activation precision; parameters stay f32.  Randomness
comes from two explicit generators per forward, ``dropout_generator`` and
``sketch_generator``, the counterparts of flax's ``'dropout'`` and
``'sketch'`` RNG collections.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as TF
from torch import nn

from fewbit_tpu_torch.functional.activations import gelu as fewbit_gelu
from fewbit_tpu_torch.models.flash import use_flash, validate_flash_config
from fewbit_tpu_torch.modules.ffn import FewBitFFN
from fewbit_tpu_torch.modules.fused import FusedDenseActivation
from fewbit_tpu_torch.modules.linear import Dense, RandomizedDense
from fewbit_tpu_torch.ops.flash_attention import SegmentIds, flash_attention
from fewbit_tpu_torch.parallel.tp import (copy_to_tp, reduce_from_tp,
                                          tp_param_spec)

__all__ = ("RobertaConfig", "RobertaModel",
           "RobertaForSequenceClassification", "load_flax_params",
           "flax_param_pairs", "encoder_pairs", "dropout")


def model_device(device) -> torch.device:
    """The device a model builds on: ``device``, or the card when it is
    None.  Without a card None raises: a model on the CPU is asked for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the models build on the card unless asked "
            "otherwise; pass device=\"cpu\" to build one on the CPU")
    return torch.device("cuda")


def validate_tp_config(cfg) -> None:
    """The model configs' check of the tensor-parallel fields, as the JAX
    configs' widths imply them: ``tp_axis`` is set exactly when
    ``tp_size > 1``, and ``num_heads`` and ``intermediate_size`` (the
    global sizes) divide by ``tp_size``."""
    if cfg.tp_size < 1:
        raise ValueError(f"tp_size={cfg.tp_size} must be positive")
    if (cfg.tp_axis is not None) != (cfg.tp_size > 1):
        raise ValueError(f"tp_axis={cfg.tp_axis!r} with tp_size="
                         f"{cfg.tp_size}: a tp axis is named exactly when "
                         f"tp_size > 1")
    for name in ("num_heads", "intermediate_size"):
        if getattr(cfg, name) % cfg.tp_size:
            raise ValueError(f"{name}={getattr(cfg, name)} does not split "
                             f"over tp_size={cfg.tp_size}")


def tp_group_of(cfg, tp_group):
    """The group a model of ``cfg`` all-reduces over: None at tp_size 1,
    else ``tp_group``, which must then hold ``tp_size`` ranks (None
    builds the slice without one: its forward raises)."""
    if cfg.tp_size == 1:
        return None
    if tp_group is not None and dist.get_world_size(tp_group) != cfg.tp_size:
        raise ValueError(f"a tp group of {dist.get_world_size(tp_group)} "
                         f"ranks for tp_size={cfg.tp_size}")
    return tp_group


def check_tp_group(cfg, tp_group) -> None:
    """A tp slice's forward runs only on its group."""
    if cfg.tp_size > 1 and tp_group is None:
        raise RuntimeError(
            f"a tp_size={cfg.tp_size} model was built without its "
            f"tp_group; build it with one (fewbit_tpu_torch.parallel: "
            f"make_dp_tp_mesh, init_dp_tp_state)")


@dataclasses.dataclass(frozen=True)
class RobertaConfig:
    vocab_size: int = 50265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1
    num_labels: int = 2
    dtype: Any = torch.float32
    # Few-bit switches.
    gelu_bits: Optional[int] = None        # None = exact gelu backward
    proj_dim_ratio: Optional[float] = None  # None = exact Dense backward
    sketch: str = "gaussian"
    fused_ffn: bool = True
    flash_attention: Any = False  # False | True | "auto"
    # (block_q, block_kv) of the TPU kernel: accepted, not read.
    flash_blocks: Optional[Tuple[int, int]] = None

    # The port loops over the layers in Python either way: accepted, no
    # effect (load_flax_params reads stacked and per-layer trees alike).
    scan_layers: bool = True
    # Megatron tensor parallelism: the model is one rank's slice of
    # ``tp_size`` (``num_heads`` and ``intermediate_size`` stay global).
    tp_axis: Optional[str] = None
    tp_size: int = 1

    def __post_init__(self):
        validate_flash_config(self)
        validate_tp_config(self)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def fewbit_ffn(self) -> bool:
        return bool(self.gelu_bits and self.fused_ffn and self.proj_dim_ratio
                    and self.sketch == "countsketch")


def dropout(x: torch.Tensor, p: float, deterministic: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout with the keep mask drawn from ``generator``; the
    backward keeps the boolean mask (1 byte per element)."""
    if deterministic or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * keep * (1.0 / (1.0 - p))


class _LayerNorm(torch.autograd.Function):
    """flax's ``nn.LayerNorm(dtype=...)``: the statistics and the affine in
    f32 with the f32 parameters, one rounding of the output; the backward
    in f32 (dx rounded once, the parameters' gradients f32).  It saves
    ``x`` in its own dtype, not an f32 copy.  In f32 it is exactly
    ``F.layer_norm`` (the same aten calls, saving the same tensors)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        shape = x.shape[-1:]
        out, mean, rstd = torch.native_layer_norm(x.float(), shape, weight,
                                                  bias, eps)
        ctx.save_for_backward(x, mean, rstd, weight, bias)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, mean, rstd, weight, bias = ctx.saved_tensors
        dx, dw, db = torch.ops.aten.native_layer_norm_backward(
            g.float(), x.float(), x.shape[-1:], mean, rstd, weight, bias,
            list(ctx.needs_input_grad[:3]))
        return (dx.to(x.dtype) if dx is not None else None), dw, db, None


class LayerNorm(nn.Module):
    """LayerNorm whose output follows the compute dtype (f32 parameters),
    computed as flax's is (:class:`_LayerNorm`): rounding the parameters to
    bf16 first moved the gradients of a bf16 model up to 7 times further
    from f32 than JAX's own bf16 run (``tests/test_torch_bf16.py``)."""

    def __init__(self, features: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x):
        return _LayerNorm.apply(x, self.weight, self.bias, self.eps)


def _dense(cfg, fin: int, fout: int, device, gen, bias: bool = True):
    """A projection of a model config with the few-bit switches: sketched
    with ``proj_dim_ratio``, exact otherwise."""
    if cfg.proj_dim_ratio:
        return RandomizedDense(fin, fout, bias=bias,
                               proj_dim_ratio=cfg.proj_dim_ratio,
                               matmul=cfg.sketch, dtype=cfg.dtype,
                               device=device, generator=gen)
    return Dense(fin, fout, cfg.dtype, bias=bias, device=device,
                 generator=gen)


def _fused_dense_gelu(cfg, fin: int, fout: int, device, gen):
    """``gelu(x @ w + b)`` with ``cfg.gelu_bits``-bit residuals, its weight
    gradient sketched with ``proj_dim_ratio``."""
    return FusedDenseActivation(fin, fout, activation="gelu",
                                bits=cfg.gelu_bits, dtype=cfg.dtype,
                                proj_dim_ratio=cfg.proj_dim_ratio,
                                matmul=cfg.sketch, device=device,
                                generator=gen)


def _flash_context(q, k, v, attention_mask, causal: bool, scale: float):
    """Attention of ``(b, s, h, d)`` projections through the flash op, as
    the JAX models call it: the ``transpose(1, 2)`` views in the library's
    layout (no copy on the card), segment ids from the attention mask, the
    context back as ``(b, s, h * d)``."""
    b, s, heads, d = q.shape
    seg = None
    if attention_mask is not None:
        ids = attention_mask.to(torch.int32)
        seg = SegmentIds(ids, ids)
    ctx = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), segment_ids=seg, causal=causal,
                          sm_scale=scale)
    return ctx.transpose(1, 2).reshape(b, s, heads * d)


def _gelu(cfg, x: torch.Tensor) -> torch.Tensor:
    """The FFN activation: few-bit with ``cfg.gelu_bits``, exact otherwise."""
    if cfg.gelu_bits:
        return fewbit_gelu(x, bits=cfg.gelu_bits)
    return TF.gelu(x, approximate="none")


class RobertaEmbeddings(nn.Module):

    def __init__(self, cfg: RobertaConfig, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, h, device=device)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                h, device=device)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, h,
                                                  device=device)
        for emb in (self.word_embeddings, self.position_embeddings,
                    self.token_type_embeddings):
            with torch.no_grad():
                emb.weight.normal_(0.0, h ** -0.5, generator=generator)
        self.layer_norm = LayerNorm(h, cfg.layer_norm_eps, device=device)

    def forward(self, input_ids, token_type_ids, deterministic: bool,
                generator=None):
        cfg = self.cfg
        # RoBERTa position quirk: positions count from pad_token_id + 1 and
        # padding tokens keep position pad_token_id.
        mask = (input_ids != cfg.pad_token_id).to(torch.int64)
        position_ids = torch.cumsum(mask, dim=-1) * mask + cfg.pad_token_id
        dt = cfg.dtype
        x = (self.word_embeddings(input_ids).to(dt)
             + self.position_embeddings(position_ids).to(dt)
             + self.token_type_embeddings(token_type_ids).to(dt))
        x = self.layer_norm(x)
        return dropout(x, cfg.hidden_dropout, deterministic, generator)


class RobertaSelfAttention(nn.Module):

    def __init__(self, cfg: RobertaConfig, device=None, generator=None,
                 tp_group=None):
        super().__init__()
        self.cfg = cfg
        self.tp_group = tp_group_of(cfg, tp_group)
        h = cfg.hidden_size
        width = h // cfg.tp_size  # the local heads' features
        self.query = _dense(cfg, h, width, device, generator)
        self.key = _dense(cfg, h, width, device, generator)
        self.value = _dense(cfg, h, width, device, generator)
        self.output = _dense(cfg, width, h, device, generator,
                             bias=cfg.tp_size == 1)
        # Row-parallel: the bias is added once, after the all-reduce.
        self.output_bias = (nn.Parameter(torch.zeros(h, device=device))
                            if cfg.tp_size > 1 else None)

    def forward(self, x, attention_mask, deterministic: bool,
                dropout_generator=None, sketch_generator=None):
        cfg = self.cfg
        b, s, h = x.shape
        heads = cfg.num_heads // cfg.tp_size

        def split(t):
            return t.reshape(b, s, heads, cfg.head_dim)

        x = copy_to_tp(x, self.tp_group)
        q = split(self.query(x, sketch_generator))
        k = split(self.key(x, sketch_generator))
        v = split(self.value(x, sketch_generator))
        scale = cfg.head_dim ** -0.5
        if use_flash(cfg.flash_attention, s, cfg.attention_dropout, x.device,
                     deterministic, cfg.head_dim):
            ctx = _flash_context(q, k, v, attention_mask, False, scale)
        else:
            logits = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
            if attention_mask is not None:
                neg = torch.tensor(torch.finfo(torch.float32).min,
                                   device=x.device).to(logits.dtype)
                bias = torch.where(attention_mask[:, None, None, :] > 0,
                                   torch.zeros_like(neg), neg)
                logits = logits + bias
            probs = torch.softmax(logits, dim=-1)
            probs = dropout(probs, cfg.attention_dropout, deterministic,
                            dropout_generator)
            ctx = torch.einsum("bhqk,bkhd->bqhd", probs,
                               v).reshape(b, s, heads * cfg.head_dim)
        out = _row_parallel(self.output(ctx, sketch_generator),
                            self.tp_group, self.output_bias)
        return dropout(out, cfg.hidden_dropout, deterministic,
                       dropout_generator)


def _row_parallel(out, tp_group, bias):
    """A row-parallel projection's partial product summed over the tp
    group, then its bias; ``out`` itself at tp_size 1."""
    if bias is None:
        return out
    return reduce_from_tp(out, tp_group) + bias.to(out.dtype)


class RobertaLayer(nn.Module):

    def __init__(self, cfg: RobertaConfig, device=None, generator=None,
                 tp_group=None):
        super().__init__()
        self.cfg = cfg
        self.tp_group = tp_group_of(cfg, tp_group)
        h, inner = cfg.hidden_size, cfg.intermediate_size // cfg.tp_size
        single = cfg.tp_size == 1
        self.attention = RobertaSelfAttention(cfg, device, generator,
                                              tp_group)
        self.attention_norm = LayerNorm(h, cfg.layer_norm_eps, device=device)
        if cfg.fewbit_ffn:
            self.ffn = FewBitFFN(h, inner, h, activation="gelu",
                                 bits=cfg.gelu_bits, dtype=cfg.dtype,
                                 proj_dim_ratio=cfg.proj_dim_ratio,
                                 use_down_bias=single, device=device,
                                 generator=generator)
        else:
            self.fused_act = bool(cfg.gelu_bits and cfg.fused_ffn)
            self.intermediate = (
                _fused_dense_gelu(cfg, h, inner, device, generator)
                if self.fused_act else
                _dense(cfg, h, inner, device, generator))
            self.ffn_output = _dense(cfg, inner, h, device, generator,
                                     bias=single)
        self.ffn_bias = (None if single else
                         nn.Parameter(torch.zeros(h, device=device)))
        self.output_norm = LayerNorm(h, cfg.layer_norm_eps, device=device)

    def forward(self, x, attention_mask, deterministic: bool,
                dropout_generator=None, sketch_generator=None):
        cfg = self.cfg
        attn = self.attention(x, attention_mask, deterministic,
                              dropout_generator, sketch_generator)
        x = self.attention_norm(x + attn)
        x_tp = copy_to_tp(x, self.tp_group)
        if cfg.fewbit_ffn:
            out = self.ffn(x_tp, sketch_generator)
        else:
            inner = self.intermediate(x_tp, sketch_generator)
            if not self.fused_act:
                inner = _gelu(cfg, inner)
            out = self.ffn_output(inner, sketch_generator)
        out = _row_parallel(out, self.tp_group, self.ffn_bias)
        out = dropout(out, cfg.hidden_dropout, deterministic,
                      dropout_generator)
        return self.output_norm(x + out)


class RobertaModel(nn.Module):

    def __init__(self, cfg: RobertaConfig, device=None, generator=None,
                 tp_group=None):
        """``device`` None: the card (:func:`model_device`); ``tp_group``:
        the group a tp slice all-reduces over."""
        super().__init__()
        device = model_device(device)
        self.cfg = cfg
        self.tp_group = tp_group_of(cfg, tp_group)
        self.embeddings = RobertaEmbeddings(cfg, device, generator)
        self.layers = nn.ModuleList(
            RobertaLayer(cfg, device, generator, tp_group)
            for _ in range(cfg.num_layers))

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                deterministic: bool = True, dropout_generator=None,
                sketch_generator=None):
        check_tp_group(self.cfg, self.tp_group)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = self.embeddings(input_ids, token_type_ids, deterministic,
                            dropout_generator)
        for layer in self.layers:
            x = layer(x, attention_mask, deterministic, dropout_generator,
                      sketch_generator)
        return x


class RobertaForSequenceClassification(nn.Module):

    def __init__(self, cfg: RobertaConfig, device=None,
                 generator: Optional[torch.Generator] = None,
                 tp_group=None):
        """``device`` None: the card (:func:`model_device`); ``tp_group``:
        the group a tp slice all-reduces over (the head is replicated)."""
        super().__init__()
        device = model_device(device)
        self.cfg = cfg
        h = cfg.hidden_size
        self.roberta = RobertaModel(cfg, device, generator, tp_group)
        self.head_dense = _dense(cfg, h, h, device, generator)
        self.head_out = _dense(cfg, h, cfg.num_labels, device, generator)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                deterministic: bool = True, dropout_generator=None,
                sketch_generator=None):
        cfg = self.cfg
        hidden = self.roberta(input_ids, attention_mask, token_type_ids,
                              deterministic, dropout_generator,
                              sketch_generator)
        # RoBERTa classification head on the <s> token.
        x = hidden[:, 0, :]
        x = dropout(x, cfg.hidden_dropout, deterministic, dropout_generator)
        x = torch.tanh(self.head_dense(x, sketch_generator))
        x = dropout(x, cfg.hidden_dropout, deterministic, dropout_generator)
        return self.head_out(x, sketch_generator)

    def flax_param_pairs(self, p, tp=(0, 1)):
        return _roberta_pairs(self, p, tp)


# ---------------------------------------------------------------------------
# Transplanting the JAX model's parameters.
# ---------------------------------------------------------------------------


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _tp_slice(arr, module: str, leaf: str, tp):
    """A JAX tree's global array, cut to tp rank ``tp[0]``'s slice of
    ``tp[1]`` by :func:`~fewbit_tpu_torch.parallel.tp.tp_param_spec` of
    ``module/leaf``."""
    arr = np.asarray(arr)
    rank, size = tp
    spec = tp_param_spec((module, leaf), arr)
    if size == 1 or "tp" not in spec:
        return arr
    return np.split(arr, size, axis=spec.index("tp"))[rank]


def _dense_pairs(mod: nn.Module, p, name: str, tp=(0, 1)):
    # flax kernels are (in, out)
    yield mod.weight, _tp_slice(p["kernel"], name, "kernel", tp).T
    if mod.bias is not None:
        yield mod.bias, _tp_slice(p["bias"], name, "bias", tp)


def _row_bias(tree, name: str, tp_name: str):
    """A row-parallel projection's bias: under its tp name in a JAX tp
    tree, the projection's own in a single-device one."""
    return tree[tp_name] if tp_name in tree else tree[name]["bias"]


def _norm_pairs(mod: LayerNorm, p):
    yield mod.weight, p["scale"]
    yield mod.bias, p["bias"]


def flax_param_pairs(model: nn.Module, tree, tp_rank: int = 0,
                     tp_size: Optional[int] = None):
    """``(parameter, array)`` for every parameter of ``model`` (RoBERTa or
    GPT), the array taken from a tree shaped like the JAX model's
    parameters (nested dicts, with or without the outer ``'params'``) and
    put in the port's orientation.  Layers scanned by the JAX model are
    stacked on axis 0 under ``layers``.  Works on any such tree: parameters
    or gradients.

    For a tp slice (``tp_size`` None: the model's), the tree holds global
    arrays (a single-device tree, or a JAX tp state's, whose row-parallel
    biases are ``output_bias`` and ``ffn_bias``): each leaf that
    :func:`~fewbit_tpu_torch.parallel.tp.tp_param_spec` splits is cut to
    rank ``tp_rank``'s slice."""
    if tp_size is None:
        tp_size = getattr(getattr(model, "cfg", None), "tp_size", 1)
    return model.flax_param_pairs(tree.get("params", tree),
                                  (tp_rank, tp_size))


def _roberta_pairs(model: RobertaForSequenceClassification, p, tp):
    yield from encoder_pairs(model.roberta, p["roberta"], tp)
    yield from _dense_pairs(model.head_dense, p["head_dense"], "head_dense")
    yield from _dense_pairs(model.head_out, p["head_out"], "head_out")


def encoder_pairs(encoder: RobertaModel, r, tp=(0, 1)):
    """``(parameter, array)`` for every parameter of a
    :class:`RobertaModel` from the JAX ``RobertaModel``'s subtree ``r``
    (the ``roberta`` of a model holding one), cut to tp rank ``tp[0]`` of
    ``tp[1]``."""
    emb = r["embeddings"]
    e = encoder.embeddings
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        yield getattr(e, name).weight, emb[name]["embedding"]
    yield from _norm_pairs(e.layer_norm, emb["layer_norm"])
    for i, layer in enumerate(encoder.layers):
        lp = _index(r["layers"], i) if "layers" in r else r[f"layer_{i}"]
        a = lp["attention"]
        for name in ("query", "key", "value", "output"):
            yield from _dense_pairs(getattr(layer.attention, name), a[name],
                                    name, tp)
        if layer.attention.output_bias is not None:
            yield layer.attention.output_bias, _row_bias(a, "output",
                                                         "output_bias")
        yield from _norm_pairs(layer.attention_norm, lp["attention_norm"])
        yield from _norm_pairs(layer.output_norm, lp["output_norm"])
        if encoder.cfg.fewbit_ffn:
            f = lp["ffn"]
            ffn = layer.ffn
            yield ffn.up_weight, _tp_slice(f["up_kernel"], "ffn",
                                           "up_kernel", tp).T
            yield ffn.down_weight, _tp_slice(f["down_kernel"], "ffn",
                                             "down_kernel", tp).T
            if ffn.up_bias is not None:
                yield ffn.up_bias, _tp_slice(f["up_bias"], "ffn", "up_bias",
                                             tp)
            if ffn.down_bias is not None:
                yield ffn.down_bias, f["down_bias"]
            if layer.ffn_bias is not None:
                yield layer.ffn_bias, (lp["ffn_bias"] if "ffn_bias" in lp
                                       else f["down_bias"])
        else:
            yield from _dense_pairs(layer.intermediate, lp["intermediate"],
                                    "intermediate", tp)
            yield from _dense_pairs(layer.ffn_output, lp["ffn_output"],
                                    "ffn_output", tp)
            if layer.ffn_bias is not None:
                yield layer.ffn_bias, _row_bias(lp, "ffn_output",
                                                "ffn_bias")


def load_flax_params(model: nn.Module, params, tp_rank: int = 0,
                     tp_size: Optional[int] = None) -> None:
    """Fill every parameter of ``model`` from the JAX package's parameter
    tree, given as nested dicts of numpy arrays (a tp slice: its rank's
    slice of the tree's global arrays, :func:`flax_param_pairs`)."""
    filled = set()
    for param, arr in flax_param_pairs(model, params, tp_rank, tp_size):
        arr = np.array(arr, dtype=np.float32)  # a writable copy
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"shape {arr.shape} does not fit "
                             f"{tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(torch.from_numpy(arr))
        filled.add(id(param))
    missing = [n for n, q in model.named_parameters() if id(q) not in filled]
    if missing:
        raise ValueError(f"parameters not in the tree: {missing}")
