"""Multi-process bootstrap and the host-major (dp, tp) grid of ranks, as
``fewbit_tpu/parallel/distributed.py``.

Every process runs the same program and drives one device (one rank).
:func:`init_distributed` wires the processes together with
``torch.distributed``; :func:`make_pod_mesh` then lays the ranks out as a
``(dp, tp)`` grid, **host-major**: the ranks of one host are reshaped to
``(dp_per_host, tp)`` and hosts stack along dp, so a tp group (an
all-reduce per layer) never leaves a host and only the dp gradient
all-reduce crosses hosts.

Launch with torchrun::

    torchrun --nnodes 2 --nproc-per-node 8 --rdzv-endpoint host0:29500 \
        train.py

or with the JAX package's variables, one process per device::

    FEWBIT_COORDINATOR=host0:29500 FEWBIT_NUM_PROCESSES=16 \
    FEWBIT_PROCESS_ID=<rank> python train.py

and in ``train.py``::

    from fewbit_tpu_torch.parallel import init_distributed, make_pod_mesh
    init_distributed()          # a no-op when no variable is set
    mesh = make_pod_mesh(tp=2)  # dp spans the hosts, tp stays inside one

The JAX module's checks of compiled collectives (``collective_groups``,
the ``assert_*`` functions) and ``tpu_aot_mesh`` read XLA's HLO and the
TPU topology and have no counterpart here.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ("init_distributed", "pod_mesh_spec", "host_groups",
           "pod_rank_grid", "make_pod_mesh")

_ENV_COORD = ("FEWBIT_COORDINATOR",)
_ENV_NPROC = ("FEWBIT_NUM_PROCESSES", "WORLD_SIZE")
_ENV_PID = ("FEWBIT_PROCESS_ID", "RANK")


def _env_first(names: Sequence[str]) -> Optional[str]:
    for name in names:
        value = os.environ.get(name)
        if value:
            return value
    return None


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device=None,
                     backend: Optional[str] = None,
                     init_method: Optional[str] = None) -> Tuple[int, int]:
    """Join this process to the job; returns ``(rank, world_size)``.

    * explicit arguments win;
    * otherwise ``FEWBIT_COORDINATOR`` (``host:port``),
      ``FEWBIT_NUM_PROCESSES`` and ``FEWBIT_PROCESS_ID``, or torchrun's
      ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``;
    * with none of them this is a no-op returning ``(0, 1)``.

    The backend is NCCL when ``device`` is a CUDA device (None is the
    card) and gloo on the CPU; ``backend`` overrides it.  With NCCL the
    process takes the card ``LOCAL_RANK`` (else ``rank % device_count``).
    Called again, it returns the process group's rank and size.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    coordinator_address = coordinator_address or _env_first(_ENV_COORD)
    if num_processes is None:
        raw = _env_first(_ENV_NPROC)
        num_processes = int(raw) if raw else None
    if process_id is None:
        raw = _env_first(_ENV_PID)
        process_id = int(raw) if raw else None
    if init_method is None:
        if coordinator_address is not None:
            init_method = f"tcp://{coordinator_address}"
        elif os.environ.get("MASTER_ADDR"):
            init_method = "env://"
    if init_method is None and num_processes in (None, 1):
        return 0, 1  # one process: nothing to wire up
    if num_processes is None or process_id is None:
        raise ValueError(
            f"init_distributed: {init_method!r} needs the number of "
            f"processes and this process's id (FEWBIT_NUM_PROCESSES / "
            f"WORLD_SIZE and FEWBIT_PROCESS_ID / RANK)")
    if backend is None:
        from fewbit_tpu_torch.models.roberta import model_device

        backend = "nccl" if model_device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None else
                              process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    return dist.get_rank(), dist.get_world_size()


def pod_mesh_spec(n_devices: int, tp: int = 1,
                  hosts: Optional[int] = None) -> Tuple[int, int, int]:
    """Factorise ``n_devices`` ranks into ``(hosts, dp_per_host, tp)``.

    ``hosts * dp_per_host * tp == n_devices``, and ``tp`` divides the
    ranks of one host: a tp group never crosses hosts.
    """
    hosts = hosts or 1
    if hosts <= 0 or tp <= 0:
        raise ValueError("hosts and tp must be positive")
    if n_devices % hosts:
        raise ValueError(
            f"{n_devices} devices do not split evenly over {hosts} hosts")
    per_host = n_devices // hosts
    if per_host % tp:
        raise ValueError(
            f"tp={tp} does not divide the {per_host} devices of one host; "
            "tensor parallelism must stay inside a host")
    return hosts, per_host // tp, tp


def host_groups(host_of: Sequence[int]) -> list:
    """Ranks grouped by their host, in host order: ``host_of[r]`` is the
    host of rank ``r``."""
    by_host = {}
    for rank, host in enumerate(host_of):
        by_host.setdefault(host, []).append(rank)
    return [by_host[k] for k in sorted(by_host)]


def pod_rank_grid(host_of: Sequence[int], tp: int = 1,
                  hosts: Optional[int] = None) -> np.ndarray:
    """The host-major ``(dp, tp)`` grid of ranks.  ``hosts`` defaults to
    the number of distinct hosts in ``host_of``; a multiple of it splits
    each host's ranks evenly (a simulated finer partition, as the JAX
    package's tests use)."""
    groups = host_groups(host_of)
    if hosts is None:
        hosts = len(groups)
    elif hosts % len(groups) == 0 and len(groups) < hosts:
        split = hosts // len(groups)
        regrouped = []
        for g in groups:
            if len(g) % split:
                raise ValueError(
                    f"cannot split a host of {len(g)} devices into {split}")
            step = len(g) // split
            regrouped += [g[i * step:(i + 1) * step] for i in range(split)]
        groups = regrouped
    elif hosts != len(groups):
        raise ValueError(
            f"hosts={hosts} incompatible with {len(groups)} owning hosts")
    n = sum(len(g) for g in groups)
    _, dp_local, tp = pod_mesh_spec(n, tp=tp, hosts=hosts)
    return np.concatenate([np.asarray(g).reshape(dp_local, tp)
                           for g in groups], axis=0)


def _host_of(world: int) -> list:
    """Each rank's host: torchrun numbers the ranks host by host, so with
    ``LOCAL_WORLD_SIZE`` ranks a host, rank ``r`` is on host ``r //
    LOCAL_WORLD_SIZE``; without it every rank is on one host."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return [r // local for r in range(world)]


def make_pod_mesh(tp: int = 1, hosts: Optional[int] = None,
                  host_of: Optional[Sequence[int]] = None):
    """The host-major ``(dp, tp)`` :class:`~fewbit_tpu_torch.parallel.mesh.
    Mesh` over every rank of the job, with this rank's groups.  Every rank
    must call it (it creates process groups)."""
    from fewbit_tpu_torch.parallel.mesh import mesh_from_grid

    world = dist.get_world_size() if dist.is_initialized() else 1
    if host_of is None:
        host_of = _host_of(world)
    return mesh_from_grid(pod_rank_grid(host_of, tp=tp, hosts=hosts))
