from .launch import launch, rank_devices, run_in_group, run_ranks
from .mesh import (
    Mesh,
    activate,
    active_mesh,
    all_reduce_sum,
    create_mesh,
    initialize_multihost,
    parse_mesh_shape,
    process_info,
    rank_rows,
    shard_batch,
    state_sharding,
)

__all__ = [
    "Mesh",
    "activate",
    "active_mesh",
    "all_reduce_sum",
    "create_mesh",
    "initialize_multihost",
    "launch",
    "parse_mesh_shape",
    "process_info",
    "rank_devices",
    "rank_rows",
    "run_in_group",
    "run_ranks",
    "shard_batch",
    "state_sharding",
]
