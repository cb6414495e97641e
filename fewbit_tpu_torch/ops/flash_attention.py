"""Flash attention: the counterpart of JAX's Pallas TPU library kernel
(``jax/experimental/pallas/ops/tpu/flash_attention.py``), which the JAX
models call for ``flash_attention``.

``flash_attention(q, k, v, segment_ids, causal, sm_scale)`` takes the
library's ``(batch, heads, seq, head_dim)`` layout and computes
``softmax(mask(sm_scale * q k^T)) v``: the logits are scaled after the
product, and ``DEFAULT_MASK_VALUE`` (-0.7 of the f32 maximum, finite, as
the library) is added where the mask is false.  The mask is the causal
mask and/or equal segment ids of query and key.

The ``autograd.Function`` keeps q, k, v, o and one f32 log-sum-exp per row
``(b, h, s)`` and never an ``(s, s)`` tensor.  Its backward computes
``di = sum(dO * O)`` in plain torch, as the library does in jnp, and then
the dK/dV and dQ kernels, which recompute ``P = exp(S - lse)``.

On a CUDA tensor the forward and the two backward steps are the
tensor-core kernels of ``csrc/flash_forward.cu`` and
``csrc/flash_backward.cu`` (wrappers in :mod:`fewbit_tpu_torch.ops.
kernels`), which read q, k, v and dO through TMA: bases and strides are
multiples of 16 bytes.  They take the head dimensions JAX's TPU kernels
take (``FLASH_HEAD_DIMS``): every d from 1 to 128, and every multiple of
128 above it on the wide kernels: the forward
(``csrc/flash_forward_wide.cu``) splits o into chunks of 128 columns, two
a block, and keeps the block's query rows resident where they fit, so
that at d = 256 one block a row tile computes S once; the backward
(``csrc/flash_backward_wide.cuh``) gives a
block 64 rows and a group of chunks of its outputs, whose two
warpgroups split the products by operand and pass P (and dS) between
them, so that at d = 256 every product is computed once.  On the CPU
their plain versions below, which take any d.  The plain versions
follow ``mha_reference_no_custom_vjp`` and ``mha_reference_bwd`` of the
library, in f32 on the widened operands.  They form the whole ``(s, s)``
matrix: only the kernels keep attention linear in memory.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = ("DEFAULT_MASK_VALUE", "SegmentIds", "flash_attention",
           "flash_forward_plain", "flash_backward_plain",
           "flash_backward_dkv_plain", "flash_backward_dq_plain")

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


class SegmentIds(NamedTuple):
    """Segment ids of the query and key sequences, each ``(batch, seq)``:
    a query attends only to keys of its own id."""
    q: torch.Tensor
    kv: torch.Tensor


def _scores(q, k, seg_q, seg_kv, causal: bool, sm_scale: float):
    """The masked, scaled f32 logits ``(b, h, sq, sk)``."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    if sm_scale != 1.0:
        s = s * sm_scale
    mask = None
    if seg_q is not None:
        mask = (seg_q[:, :, None] == seg_kv[:, None, :])[:, None]
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        c = (torch.arange(sk, device=q.device)[None, :]
             <= torch.arange(sq, device=q.device)[:, None])[None, None]
        mask = c if mask is None else mask & c
    if mask is not None:
        s = s + torch.where(mask, 0.0, DEFAULT_MASK_VALUE)
    return s


def flash_forward_plain(q, k, v, seg_q=None, seg_kv=None,
                        causal: bool = False, sm_scale: float = 1.0):
    """``(o, lse)``: the attention output in q's dtype and the f32
    log-sum-exp of each row's logits, ``(b, h, sq)``."""
    s = _scores(q, k, seg_q, seg_kv, causal, sm_scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p / l, v.float())
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _probs_and_dscores(q, k, v, seg_q, seg_kv, lse, do, di, causal,
                       sm_scale):
    """``P = exp(S - lse)`` and ``dS = P (dO v^T - di) sm_scale``."""
    p = torch.exp(_scores(q, k, seg_q, seg_kv, causal, sm_scale)
                  - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    return p, (dp - di[..., None]) * p * sm_scale


def flash_backward_dkv_plain(q, k, v, seg_q, seg_kv, lse, do, di,
                             causal: bool = False, sm_scale: float = 1.0):
    """``(dk, dv)`` in the dtypes of k and v."""
    p, ds = _probs_and_dscores(q, k, v, seg_q, seg_kv, lse, do, di, causal,
                               sm_scale)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_backward_dq_plain(q, k, v, seg_q, seg_kv, lse, do, di,
                            causal: bool = False, sm_scale: float = 1.0):
    """``dq`` in q's dtype."""
    _, ds = _probs_and_dscores(q, k, v, seg_q, seg_kv, lse, do, di, causal,
                               sm_scale)
    return torch.einsum("bhqk,bhkd->bhqd", ds, k.float()).to(q.dtype)


def flash_backward_plain(q, k, v, seg_q, seg_kv, o, lse, do,
                         causal: bool = False, sm_scale: float = 1.0):
    """``(dq, dk, dv)`` from the forward's o and lse, ``di`` computed as
    the library computes it."""
    args = (q, k, v, seg_q, seg_kv, lse, do,
            (o.float() * do.float()).sum(-1), causal, sm_scale)
    return (flash_backward_dq_plain(*args), *flash_backward_dkv_plain(*args))


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_kv, causal, sm_scale):
        from fewbit_tpu_torch.ops import kernels as K

        o, lse = K.flash_forward(q, k, v, seg_q, seg_kv, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse, seg_q, seg_kv)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        from fewbit_tpu_torch.ops import kernels as K

        q, k, v, o, lse, seg_q, seg_kv = ctx.saved_tensors
        # Autograd may hand over an expanded or oddly strided gradient: the
        # kernels read unit stride along d, and through TMA only strides
        # and bases that are multiples of 16 bytes.
        per16 = 16 // do.element_size()
        if (do.stride(-1) != 1 or do.data_ptr() % 16
                or any(n > 1 and (st <= 0 or st % per16)
                       for n, st in zip(do.shape[:3], do.stride()[:3]))):
            do = do.contiguous()
        di = (o.float() * do.float()).sum(-1)
        args = (q, k, v, seg_q, seg_kv, lse, do, di, ctx.causal,
                ctx.sm_scale)
        dk, dv = K.flash_backward_dkv(*args)
        dq = K.flash_backward_dq(*args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    segment_ids: Optional[SegmentIds] = None,
                    causal: bool = False,
                    sm_scale: float = 1.0) -> torch.Tensor:
    """Attention of ``q`` ``(b, h, sq, d)`` over ``k``, ``v``
    ``(b, h, sk, d)``, in the library's layout; any strides with a unit
    last stride (the ``transpose(1, 2)`` of a ``(b, s, h, d)`` projection
    is read in place).  On the card the output has q's strides, so its
    ``transpose(1, 2)`` is again ``(b, s, h, d)`` in memory."""
    b, h, sq, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit (b, h, s, d)")
    seg_q = seg_kv = None
    if segment_ids is not None:
        seg_q = segment_ids.q.to(device=q.device,
                                 dtype=torch.int32).contiguous()
        seg_kv = segment_ids.kv.to(device=q.device,
                                   dtype=torch.int32).contiguous()
        if seg_q.shape != (b, sq) or seg_kv.shape != (b, k.shape[2]):
            raise ValueError(f"segment ids {tuple(seg_q.shape)} and "
                             f"{tuple(seg_kv.shape)} do not fit q and k")
    return _FlashAttention.apply(q, k, v, seg_q, seg_kv, bool(causal),
                                 float(sm_scale))
