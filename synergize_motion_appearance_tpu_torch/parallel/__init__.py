"""Multi-process training and multi-device inference (counterpart of the
JAX package's parallel/)."""
from .mesh import (
    DistInfo,
    all_reduce_mean,
    all_reduce_,
    barrier,
    broadcast_module,
    broadcast_tensors,
    create_mesh,
    gather_batch,
    get_dist_info,
    in_process_group,
    init_distributed,
    is_master,
    reset_collectives,
    shard_batch,
    slurm_rendezvous,
)

__all__ = ["DistInfo", "all_reduce_", "all_reduce_mean", "barrier",
           "broadcast_module", "broadcast_tensors", "create_mesh", "gather_batch",
           "get_dist_info", "in_process_group", "init_distributed",
           "is_master", "reset_collectives", "shard_batch",
           "slurm_rendezvous"]
