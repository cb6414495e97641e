"""GPT-2-style decoder-only causal LM with the few-bit training path, as
``fewbit_tpu/models/gpt.py``: pre-LN blocks, learned positions, a
weight-tied LM head, standard causal attention, a Python loop over the
layers.

The config switches are those of the RoBERTa model:

* ``gelu_bits`` -- the FFN's up projection and GELU are one
  ``FusedDenseActivation`` named ``intermediate`` (kernel 6 forward, kernel
  5 backward): the backward keeps ``bits / 8``-byte codes, never the
  pre-activation;
* ``proj_dim_ratio`` -- every projection (and the up projection's weight
  gradient) keeps a sketch of its input along the batch x seq axis, of the
  kind ``sketch`` names (``"countsketch"`` by default, as in the JAX
  config, which takes kernel 1; any kind of ``MATMUL_KINDS``).

``flash_attention`` chooses the attention op per call
(:func:`fewbit_tpu_torch.models.flash.use_flash`): the causal flash op of
:mod:`fewbit_tpu_torch.ops.flash_attention`, with segment ids from the
attention mask, or the standard masked softmax.  ``flash_blocks`` is
accepted for parity with the JAX config and not read: the CUDA kernels
choose their own tiles.

The model builds on the card unless the caller asks otherwise (``device``
None is ``"cuda"``; without a card it raises and names ``device="cpu"``).

``scan_layers`` is accepted and has no effect (the layers are a Python
loop).  With ``tp_size > 1`` the model is one rank's Megatron slice, built
with its ``tp_group``, by the rules of the RoBERTa model
(:mod:`fewbit_tpu_torch.models.roberta`): ``query``, ``key``, ``value``
and ``intermediate`` column-parallel, ``output`` and ``ffn_output``
row-parallel with ``output_bias`` and ``ffn_bias`` added after the
all-reduce; the embeddings, the norms and the tied head are replicated.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as TF
from torch import nn

from fewbit_tpu_torch.models.flash import use_flash, validate_flash_config
from fewbit_tpu_torch.models.roberta import (LayerNorm, _dense, _dense_pairs,
                                             _flash_context,
                                             _fused_dense_gelu, _index,
                                             _norm_pairs, _row_bias,
                                             _row_parallel, check_tp_group,
                                             dropout, model_device,
                                             tp_group_of, validate_tp_config)
from fewbit_tpu_torch.parallel.tp import copy_to_tp

__all__ = ("GPTConfig", "GPTModel", "GPTForCausalLM")


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-5
    dtype: Any = torch.float32
    # Few-bit switches (same semantics as RobertaConfig).
    gelu_bits: Optional[int] = None
    proj_dim_ratio: Optional[float] = None
    sketch: str = "countsketch"
    flash_attention: Any = False  # False | True | "auto"
    # (block_q, block_kv) of the TPU kernel: accepted, not read.
    flash_blocks: Optional[Tuple[int, int]] = None
    tie_lm_head: bool = True

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


class GPTSelfAttention(nn.Module):

    def __init__(self, cfg: GPTConfig, device=None, generator=None,
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
            ctx = _flash_context(q, k, v, attention_mask, True, scale)
        else:
            logits = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
            keep = torch.ones(s, s, dtype=torch.bool,
                              device=x.device).tril()[None, None]
            if attention_mask is not None:
                keep = keep & (attention_mask[:, None, None, :] > 0)
            neg = torch.tensor(torch.finfo(torch.float32).min,
                               device=x.device)
            logits = logits + torch.where(keep, torch.zeros_like(neg),
                                          neg).to(logits.dtype)
            probs = torch.softmax(logits, dim=-1)
            probs = dropout(probs, cfg.attention_dropout, deterministic,
                            dropout_generator)
            ctx = torch.einsum("bhqk,bkhd->bqhd", probs,
                               v).reshape(b, s, heads * cfg.head_dim)
        out = _row_parallel(self.output(ctx, sketch_generator),
                            self.tp_group, self.output_bias)
        return dropout(out, cfg.hidden_dropout, deterministic,
                       dropout_generator)


class GPTBlock(nn.Module):
    """Pre-LN transformer decoder block."""

    def __init__(self, cfg: GPTConfig, device=None, generator=None,
                 tp_group=None):
        super().__init__()
        self.cfg = cfg
        self.tp_group = tp_group_of(cfg, tp_group)
        h, inner = cfg.hidden_size, cfg.intermediate_size // cfg.tp_size
        self.attention_norm = LayerNorm(h, cfg.layer_norm_eps, device=device)
        self.attention = GPTSelfAttention(cfg, device, generator, tp_group)
        self.ffn_norm = LayerNorm(h, cfg.layer_norm_eps, device=device)
        self.intermediate = (
            _fused_dense_gelu(cfg, h, inner, device, generator)
            if cfg.gelu_bits else _dense(cfg, h, inner, device, generator))
        self.ffn_output = _dense(cfg, inner, h, device, generator,
                                 bias=cfg.tp_size == 1)
        self.ffn_bias = (nn.Parameter(torch.zeros(h, device=device))
                         if cfg.tp_size > 1 else None)

    def forward(self, x, attention_mask, deterministic: bool,
                dropout_generator=None, sketch_generator=None):
        cfg = self.cfg
        x = x + self.attention(self.attention_norm(x), attention_mask,
                               deterministic, dropout_generator,
                               sketch_generator)
        y = copy_to_tp(self.ffn_norm(x), self.tp_group)
        inner = self.intermediate(y, sketch_generator)
        if not cfg.gelu_bits:
            inner = TF.gelu(inner, approximate="none")
        out = _row_parallel(self.ffn_output(inner, sketch_generator),
                            self.tp_group, self.ffn_bias)
        return x + dropout(out, cfg.hidden_dropout, deterministic,
                           dropout_generator)


class GPTModel(nn.Module):
    """Decoder backbone; with ``logits=True`` the LM head is applied inside
    (tied: the token embedding matrix, transposed)."""

    def __init__(self, cfg: GPTConfig, device=None, generator=None,
                 tp_group=None):
        """``device`` None: the card (:func:`~fewbit_tpu_torch.models.
        roberta.model_device`); ``tp_group``: the group a tp slice
        all-reduces over."""
        super().__init__()
        device = model_device(device)
        self.cfg = cfg
        self.tp_group = tp_group_of(cfg, tp_group)
        h = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, h, device=device)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                h, device=device)
        for emb in (self.word_embeddings, self.position_embeddings):
            with torch.no_grad():
                emb.weight.normal_(0.0, h ** -0.5, generator=generator)
        self.layers = nn.ModuleList(GPTBlock(cfg, device, generator,
                                             tp_group)
                                    for _ in range(cfg.num_layers))
        self.final_norm = LayerNorm(h, cfg.layer_norm_eps, device=device)
        self.lm_head = (None if cfg.tie_lm_head else
                        _dense(cfg, h, cfg.vocab_size, device, generator,
                               bias=False))

    def forward(self, input_ids, attention_mask=None,
                deterministic: bool = True, dropout_generator=None,
                sketch_generator=None, logits: bool = False):
        cfg = self.cfg
        check_tp_group(cfg, self.tp_group)
        s = input_ids.shape[-1]
        if s > cfg.max_position_embeddings:
            # An embedding lookup past the table would fail on the CPU and
            # read out of bounds on the card.
            raise ValueError(
                f"sequence length {s} exceeds max_position_embeddings="
                f"{cfg.max_position_embeddings}")
        dt = cfg.dtype
        positions = torch.arange(s, device=input_ids.device)
        x = (self.word_embeddings(input_ids).to(dt)
             + self.position_embeddings(positions).to(dt)[None])
        x = dropout(x, cfg.hidden_dropout, deterministic, dropout_generator)
        for layer in self.layers:
            x = layer(x, attention_mask, deterministic, dropout_generator,
                      sketch_generator)
        x = self.final_norm(x)
        if not logits:
            return x
        if self.lm_head is None:
            return torch.matmul(x, self.word_embeddings.weight.to(dt).t())
        return self.lm_head(x, sketch_generator)


class GPTForCausalLM(nn.Module):

    def __init__(self, cfg: GPTConfig, device=None,
                 generator: Optional[torch.Generator] = None,
                 tp_group=None):
        """``device`` None: the card; ``tp_group``: the group a tp slice
        all-reduces over (:class:`GPTModel`)."""
        super().__init__()
        self.cfg = cfg
        self.transformer = GPTModel(cfg, device, generator, tp_group)

    def forward(self, input_ids, attention_mask=None,
                deterministic: bool = True, dropout_generator=None,
                sketch_generator=None):
        return self.transformer(input_ids, attention_mask, deterministic,
                                dropout_generator, sketch_generator,
                                logits=True)

    def flax_param_pairs(self, p, tp=(0, 1)):
        """``(parameter, array)`` pairs from the JAX model's tree
        ``transformer/{word_embeddings, position_embeddings, layers |
        layer_i, final_norm, lm_head?}``, cut to tp rank ``tp[0]`` of
        ``tp[1]`` (see
        :func:`fewbit_tpu_torch.models.roberta.flax_param_pairs`)."""
        t = p["transformer"]
        m = self.transformer
        for name in ("word_embeddings", "position_embeddings"):
            yield getattr(m, name).weight, t[name]["embedding"]
        for i, layer in enumerate(m.layers):
            lp = _index(t["layers"], i) if "layers" in t else t[f"layer_{i}"]
            a = lp["attention"]
            for name in ("query", "key", "value", "output"):
                yield from _dense_pairs(getattr(layer.attention, name),
                                        a[name], name, tp)
            if layer.attention.output_bias is not None:
                yield layer.attention.output_bias, _row_bias(
                    a, "output", "output_bias")
            yield from _norm_pairs(layer.attention_norm, lp["attention_norm"])
            yield from _norm_pairs(layer.ffn_norm, lp["ffn_norm"])
            yield from _dense_pairs(layer.intermediate, lp["intermediate"],
                                    "intermediate", tp)
            yield from _dense_pairs(layer.ffn_output, lp["ffn_output"],
                                    "ffn_output", tp)
            if layer.ffn_bias is not None:
                yield layer.ffn_bias, _row_bias(lp, "ffn_output", "ffn_bias")
        yield from _norm_pairs(m.final_norm, t["final_norm"])
        if m.lm_head is not None:
            yield from _dense_pairs(m.lm_head, t["lm_head"], "lm_head")
