"""Multi-shard map fusion and export, distributed bundle adjustment and
multi-process wiring (counterpart of `ra_slam_tpu.parallel`), on the
shard meshes of `parallel.mesh`."""

from ra_slam_tpu_torch.parallel.dist_ba import (
    distributed_bundle_adjustment,
    solve_window_distributed,
)
from ra_slam_tpu_torch.parallel.distributed import (
    global_mesh,
    initialize_distributed,
    process_info,
    replicate_global,
)
from ra_slam_tpu_torch.parallel.mesh import LocalMesh, ProcessGroupMesh
from ra_slam_tpu_torch.parallel.sharded_map import (
    create_sharded_map,
    local_config,
    make_gather_shards,
    make_sharded_integrate_step,
    map_partition_specs,
)

__all__ = [
    "LocalMesh",
    "ProcessGroupMesh",
    "create_sharded_map",
    "distributed_bundle_adjustment",
    "global_mesh",
    "initialize_distributed",
    "local_config",
    "make_gather_shards",
    "make_sharded_integrate_step",
    "map_partition_specs",
    "process_info",
    "replicate_global",
    "solve_window_distributed",
]
