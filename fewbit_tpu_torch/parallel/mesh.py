"""Data parallelism over ``torch.distributed``, as
``fewbit_tpu/parallel/mesh.py``.

A :class:`Mesh` is a ``(dp, tp)`` grid of global ranks and this rank's two
process groups on it: its column (the ranks that hold the same
parameters and split the batch, ``dp_group``) and its row (the ranks that
split each layer, ``tp_group``).  The batch is split along dp
(:func:`shard_batch`), the parameters start equal on every dp rank
(:func:`replicate`, or the broadcast ``DistributedDataParallel`` makes),
and the gradients are averaged over dp in the backward
(:func:`data_parallel_step`), the ``pmean`` of the JAX step.

The few-bit codes and sketches are made in each rank's forward from its
own batch slice, so they never move.  Each dp rank draws its own sketch
signs and dropout masks (:func:`fold_shard_generator`), as the JAX step
folds the dp index into its key; tp ranks share theirs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ("Mesh", "mesh_from_grid", "make_mesh", "shard_batch",
           "replicate", "fold_shard_generator", "data_parallel_step")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A ``(dp, tp)`` grid of global ranks and this rank's place on it.

    ``dp_group`` and ``tp_group`` are this rank's column and row (None
    without a process group, or for a rank outside the grid)."""
    ranks: np.ndarray
    rank: int
    dp_group: Optional[object] = None
    tp_group: Optional[object] = None

    @property
    def shape(self) -> dict:
        dp, tp = self.ranks.shape
        return {"dp": dp, "tp": tp}

    @property
    def dp_size(self) -> int:
        return self.ranks.shape[0]

    @property
    def tp_size(self) -> int:
        return self.ranks.shape[1]

    def _place(self):
        where = np.argwhere(self.ranks == self.rank)
        if not len(where):
            raise ValueError(f"rank {self.rank} is not on this mesh")
        return tuple(int(i) for i in where[0])

    @property
    def member(self) -> bool:
        return bool((self.ranks == self.rank).any())

    @property
    def dp_rank(self) -> int:
        return self._place()[0]

    @property
    def tp_rank(self) -> int:
        return self._place()[1]


def mesh_from_grid(ranks) -> Mesh:
    """A :class:`Mesh` over ``ranks`` (a ``(dp, tp)`` array of global
    ranks), with a process group for each row and each column.  Every
    rank of the job must call it, in the same order as the others (each
    ``new_group`` is collective); a rank outside the grid gets a mesh
    without groups."""
    ranks = np.asarray(ranks, dtype=np.int64)
    if ranks.ndim != 2 or len(np.unique(ranks)) != ranks.size:
        raise ValueError(f"a mesh is a (dp, tp) grid of distinct ranks, "
                         f"not {ranks.tolist()}")
    if not dist.is_initialized():
        if ranks.size != 1:
            raise ValueError(f"a mesh of {ranks.size} ranks needs "
                             f"torch.distributed (init_distributed)")
        return Mesh(ranks, 0)
    rank = dist.get_rank()
    if ranks.max() >= dist.get_world_size():
        raise ValueError(f"the grid {ranks.tolist()} names ranks past the "
                         f"world of {dist.get_world_size()}")
    dp_group = tp_group = None
    for row in ranks:
        group = dist.new_group(row.tolist())
        if rank in row:
            tp_group = group
    for col in ranks.T:
        group = dist.new_group(col.tolist())
        if rank in col:
            dp_group = group
    return Mesh(ranks, rank, dp_group, tp_group)


def make_mesh(dp: Optional[int] = None) -> Mesh:
    """The data-parallel ``(dp, 1)`` mesh over ranks ``0 .. dp - 1`` (all
    ranks by default)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    dp = dp or world
    if dp > world:
        raise ValueError(f"requested dp={dp} but only {world} ranks")
    return mesh_from_grid(np.arange(dp).reshape(dp, 1))


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's slice of a global batch: each tensor cut along its
    first axis into ``dp`` equal parts, part ``dp_rank`` (rank-major, as
    ``P("dp")`` splits it)."""
    out = {}
    for key, value in batch.items():
        if value.shape[0] % mesh.dp_size:
            raise ValueError(f"{key}: batch of {value.shape[0]} does not "
                             f"split over dp={mesh.dp_size}")
        out[key] = value.chunk(mesh.dp_size)[mesh.dp_rank]
    return out


def replicate(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Make ``model``'s parameters and buffers those of dp rank 0 of this
    rank's column (a broadcast over ``dp_group``); returns ``model``."""
    if mesh.dp_group is None or mesh.dp_size == 1:
        return model
    src = int(mesh.ranks[0, mesh.tp_rank])
    with torch.no_grad():
        for t in [*model.parameters(), *model.buffers()]:
            dist.broadcast(t, src=src, group=mesh.dp_group)
    return model


# An odd 64-bit constant (the golden ratio's): distinct ranks give
# distinct seeds for any draw.
_FOLD = 0x9E3779B97F4A7C15


def fold_shard_generator(generator: torch.Generator,
                         rank: int) -> torch.Generator:
    """A generator of shard ``rank``'s own: one 62-bit draw ``s`` of
    ``generator`` (made alike on every shard, so their generators stay in
    step), and a generator on its device seeded with ``(s + (rank + 1) *
    0x9E3779B97F4A7C15) mod 2**64``.  The counterpart of
    ``jax.random.fold_in(key, rank)``."""
    s = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                          device=generator.device))
    folded = torch.Generator(device=generator.device)
    folded.manual_seed((s + (rank + 1) * _FOLD) % 2 ** 64)
    return folded


def data_parallel_step(model: torch.nn.Module,
                       mesh: Mesh) -> torch.nn.Module:
    """``model`` in ``DistributedDataParallel`` over this rank's dp group:
    its parameters broadcast from dp rank 0 at construction, its
    gradients averaged over dp in the backward (the JAX step's ``pmean``).
    Train it with :func:`fewbit_tpu_torch.train.make_train_step` given
    ``dp_group=mesh.dp_group``."""
    from torch.nn.parallel import DistributedDataParallel

    if mesh.dp_group is None:
        raise ValueError("data_parallel_step needs a mesh with a dp group "
                         "(torch.distributed, init_distributed)")
    return DistributedDataParallel(model, process_group=mesh.dp_group)
