"""Tensor parallelism (dp x tp) after Megatron, as
``fewbit_tpu/parallel/tp.py``.

The attention heads and the FFN's inner width are split over the ranks of
a tp group: the up projections (``query``, ``key``, ``value``,
``intermediate``, and the fused FFN's ``up_weight``/``up_bias``) are
column-parallel, each rank computing its slice of the output features;
the down projections (``output``, ``ffn_output``, the fused FFN's
``down_weight``) are row-parallel, each rank multiplying its slice of the
input features, and one all-reduce sums the partial products before the
bias is added once (``output_bias``, ``ffn_bias``).  Everything else is
replicated.  The few-bit codes and the sketches of a sharded projection
are made from the local slice, so they shard with it.

Two autograd functions carry the all-reduces:

* :func:`copy_to_tp` -- identity forward, all-reduce backward: in front
  of every column-parallel projection, it sums the input gradient of the
  ranks' slices;
* :func:`reduce_from_tp` -- all-reduce forward, identity backward: after
  every row-parallel projection.

With them every gradient equals the single-device model's on the
gathered weights.  (The JAX package's psum, differentiated under
``shard_map(check_vma=False)``, is transposed into another psum and
doubles the gradients of the sharded parameters at tp=2: F-7 in
``ROADMAP.md``.)

The JAX module's ``state_specs`` has no counterpart: a torch optimizer's
moments are tensors shaped like the local parameters they follow, so they
shard with them.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from fewbit_tpu_torch.modules._rng import lecun_normal_
from fewbit_tpu_torch.parallel.mesh import (Mesh, data_parallel_step,
                                            fold_shard_generator,
                                            mesh_from_grid)

__all__ = ("make_dp_tp_mesh", "tp_param_spec", "shard_tp_params",
           "gather_tp_params", "copy_to_tp", "reduce_from_tp",
           "init_dp_tp_state", "dp_tp_train_step")

# The rules by the owning module's name and the leaf's: the axis that is
# split over tp, counted from the end; every other leaf is replicated.
# ``kernel`` is a flax kernel (in, out); ``weight`` a torch one (out, in).
_COLUMN_MODULES = ("query", "key", "value", "intermediate")
_ROW_MODULES = ("output", "ffn_output")
_COLUMN = {"kernel": -1, "bias": -1, "weight": -2}
_ROW = {"kernel": -2, "weight": -1}
# The fused few-bit FFN (flax ``FewBitFFN`` and the port's): up
# column-parallel, down row-parallel, its down bias added after the sum.
_FFN = {"up_kernel": -1, "up_bias": -1, "down_kernel": -2,
        "up_weight": -2, "down_weight": -1}
# A single-device parameter name's end -> its tp model's: the row-parallel
# biases, added once after the all-reduce.
_BIAS_RENAMES = (("attention.output.bias", "attention.output_bias"),
                 ("ffn_output.bias", "ffn_bias"), ("ffn.down_bias",
                                                   "ffn_bias"))


def make_dp_tp_mesh(dp: int, tp: int) -> Mesh:
    """The row-major ``(dp, tp)`` mesh over ranks ``0 .. dp * tp - 1``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if dp * tp > world:
        raise ValueError(f"dp*tp={dp * tp} exceeds {world} ranks")
    return mesh_from_grid(np.arange(dp * tp).reshape(dp, tp))


def _names(path) -> list:
    if isinstance(path, str):
        return path.replace("/", ".").split(".")
    return [str(getattr(k, "key", getattr(k, "name", k))) for k in path]


def _tp_axis(path, ndim: int) -> Optional[int]:
    """The split axis (from 0) of a leaf of ``ndim`` axes, or None."""
    names = _names(path)
    module = names[-2] if len(names) >= 2 else ""
    rules = (_COLUMN if module in _COLUMN_MODULES else
             _ROW if module in _ROW_MODULES else
             _FFN if module == "ffn" else {})
    axis = rules.get(names[-1])
    return None if axis is None else ndim + axis


def tp_param_spec(path, leaf) -> tuple:
    """The split of one parameter over tp, one entry per axis (``"tp"``
    on the split axis, None elsewhere), as the JAX function's
    ``PartitionSpec``.  ``path`` is a port parameter name
    (``roberta.layers.0.attention.query.weight``), a ``/``-joined path or
    a JAX tree path; ``leaf`` has a ``shape`` or is one."""
    ndim = len(getattr(leaf, "shape", leaf))
    spec = [None] * ndim
    axis = _tp_axis(path, ndim)
    if axis is not None:
        spec[axis] = "tp"
    return tuple(spec)


def _renamed(name: str, names, to_tp: bool) -> str:
    """``name`` under the other model's name by ``_BIAS_RENAMES``: the tp
    model's (``to_tp``) or the single-device model's.  A tp name with two
    single-device ones (``ffn_bias``) takes the one whose module is among
    ``names``, the other parameter names of ``name``'s model."""
    for single, tp in _BIAS_RENAMES:
        old, new = (single, tp) if to_tp else (tp, single)
        if name == old or name.endswith("." + old):
            renamed = name[:-len(old)] + new
            module = renamed.rsplit(".", 1)[0] + "."
            if to_tp or any(n.startswith(module) for n in names):
                return renamed
    return name


def shard_tp_params(state: dict, tp_rank: int, tp_size: int) -> dict:
    """Rank ``tp_rank``'s state of a tp model from a single-device model's
    ``state`` (parameter names of the port): each split leaf cut into
    ``tp_size`` equal parts along its axis, the row-parallel biases under
    their tp names."""
    out = {}
    for name, value in state.items():
        axis = _tp_axis(name, value.ndim)
        if axis is not None:
            value = value.chunk(tp_size, dim=axis)[tp_rank]
        out[_renamed(name, state, to_tp=True)] = value
    return out


def gather_tp_params(states: Sequence[dict]) -> dict:
    """The single-device view of a tp model: the states (or gradients, by
    parameter name) of its ranks in tp order, each split leaf
    concatenated along its axis, the replicated ones taken from rank 0,
    the row-parallel biases under their single-device names."""
    first = states[0]
    out = {}
    for name, value in first.items():
        axis = _tp_axis(name, value.ndim)
        if axis is not None:
            value = torch.cat([s[name] for s in states], dim=axis)
        out[_renamed(name, first, to_tp=False)] = value
    return out


class _CopyToTP(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the backward all-reduces the gradient over
    ``group`` (the sum of the input gradients of the ranks' column
    slices).  Identity when ``group`` is None."""
    return x if group is None else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) over ``group`` forward; identity backward (each
    rank's partial product takes the whole output gradient).  Identity
    when ``group`` is None."""
    return x if group is None else _ReduceFromTP.apply(x, group)


def init_dp_tp_state(model_cls: Callable, cfg, mesh: Mesh, seed: int = 0,
                     device=None) -> torch.nn.Module:
    """This rank's tp model ``model_cls(cfg, device, generator,
    tp_group)``, built from the generator every rank shares (so the tp
    ranks agree on the replicated parameters bit for bit), its split
    weights then drawn again from that generator folded by the tp rank
    (independent slices of one random global weight).  ``device`` None is
    the card."""
    from fewbit_tpu_torch.models.roberta import model_device

    dev = model_device(device)
    if cfg.tp_size != mesh.tp_size:
        raise ValueError(f"cfg.tp_size={cfg.tp_size} on a mesh of "
                         f"tp={mesh.tp_size}")
    model = model_cls(cfg, dev, torch.Generator(device=dev).manual_seed(
        seed), tp_group=mesh.tp_group)
    folded = fold_shard_generator(
        torch.Generator(device=dev).manual_seed(seed), mesh.tp_rank)
    for name, p in model.named_parameters():
        # The modules' own init: a split weight (out, in) lecun-normal
        # over its input features; a split bias stays zero.
        if _tp_axis(name, p.ndim) is not None and p.ndim > 1:
            lecun_normal_(p, p.shape[-1], folded)
    return model


def dp_tp_train_step(model: torch.nn.Module, train_cfg, mesh: Mesh,
                     loss_fn: Optional[Callable] = None) -> Callable:
    """The training step of a tp model (built with ``mesh.tp_group``) on
    the dp x tp mesh: ``model`` in ``DistributedDataParallel`` over the dp
    group (:func:`~fewbit_tpu_torch.parallel.mesh.data_parallel_step`) and
    :func:`~fewbit_tpu_torch.train.make_train_step` with
    ``dp_group=mesh.dp_group``.  ``loss_fn`` None is the classification
    loss."""
    from fewbit_tpu_torch.train.loop import (classification_loss,
                                             make_train_step)

    return make_train_step(data_parallel_step(model, mesh), train_cfg,
                           loss_fn=loss_fn or classification_loss,
                           dp_group=mesh.dp_group)
