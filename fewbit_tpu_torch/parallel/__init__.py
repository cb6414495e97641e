"""Data and tensor parallelism over ``torch.distributed``, as
``fewbit_tpu/parallel`` (without its TPU-only names)."""

from fewbit_tpu_torch.parallel.distributed import (  # noqa: F401
    host_groups, init_distributed, make_pod_mesh, pod_mesh_spec,
    pod_rank_grid)
from fewbit_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, data_parallel_step, fold_shard_generator, make_mesh,
    mesh_from_grid, replicate, shard_batch)
from fewbit_tpu_torch.parallel.tp import (  # noqa: F401
    copy_to_tp, dp_tp_train_step, gather_tp_params, init_dp_tp_state,
    make_dp_tp_mesh, reduce_from_tp, shard_tp_params, tp_param_spec)

__all__ = ("host_groups", "init_distributed", "make_pod_mesh",
           "pod_mesh_spec", "pod_rank_grid", "Mesh", "data_parallel_step",
           "fold_shard_generator", "make_mesh", "mesh_from_grid",
           "replicate", "shard_batch", "copy_to_tp", "dp_tp_train_step",
           "gather_tp_params", "init_dp_tp_state", "make_dp_tp_mesh",
           "reduce_from_tp", "shard_tp_params", "tp_param_spec")
