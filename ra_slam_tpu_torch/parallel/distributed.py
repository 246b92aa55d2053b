"""Multi-process wiring (counterpart of `ra_slam_tpu/parallel/distributed.py`).

`initialize_distributed` joins this process to a `torch.distributed`
group from the same three environment variables as the JAX package
(`RA_SLAM_COORDINATOR`, `RA_SLAM_NUM_PROCESSES`, `RA_SLAM_PROCESS_ID`);
`global_mesh` is then one shard per process (`ProcessGroupMesh`), or,
in a single process, `LocalMesh` shards on one device. The backend
follows the device: NCCL for a GPU (one GPU per process,
`cuda:<RA_SLAM_LOCAL_RANK or process id>`), gloo for the CPU. A GPU
process group with more processes than GPUs raises: NCCL cannot put two
ranks on one GPU, and nothing falls back to another backend.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ra_slam_tpu_torch.parallel.mesh import LocalMesh, ProcessGroupMesh


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
    timeout_s: float = 600.0,
) -> None:
    """Join this process to the process group (a no-op for one process).

    Arguments default to `RA_SLAM_COORDINATOR` (host:port, default
    localhost:9910), `RA_SLAM_NUM_PROCESSES` and `RA_SLAM_PROCESS_ID`.
    `device` picks the backend: NCCL on a CUDA device, gloo on the CPU."""
    coordinator_address = coordinator_address or os.environ.get("RA_SLAM_COORDINATOR", "localhost:9910")
    num_processes = int(num_processes if num_processes is not None
                        else os.environ.get("RA_SLAM_NUM_PROCESSES", "1"))
    process_id = int(process_id if process_id is not None else os.environ.get("RA_SLAM_PROCESS_ID", "0"))
    if num_processes <= 1:
        return
    import torch.distributed as dist

    device = torch.device(device)
    if device.type == "cuda":
        local = int(os.environ.get("RA_SLAM_LOCAL_RANK", process_id))
        n_gpu = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local >= n_gpu:
            raise RuntimeError(
                f"NCCL process {process_id} (local rank {local}) needs its own GPU; this machine has "
                f"{n_gpu}: run fewer processes, or shards of one process on one GPU (LocalMesh)"
            )
        torch.cuda.set_device(local)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s),
    )


def _group_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def global_mesh(axis: str = "map", devices: Optional[Sequence] = None):
    """A 1-D mesh over every process (one shard each) when a process
    group of more than one process is up; otherwise `LocalMesh` shards,
    one per entry of `devices` (all the same device; default one shard
    on `cuda`)."""
    if _group_size() > 1:
        return ProcessGroupMesh(axis)
    devs = [torch.device(d) for d in (devices if devices is not None else ["cuda"])]
    if len(set(devs)) != 1:
        raise ValueError(f"the shards of one process share one device, got {devs}")
    return LocalMesh(len(devs), devs[0], axis)


def replicate_global(mesh, x: np.ndarray) -> torch.Tensor:
    """`x` on the mesh's device (every process passes identical values,
    e.g. the current camera frame)."""
    return torch.as_tensor(np.asarray(x), device=mesh.device)


def process_info() -> dict:
    """This process's place in the group. A process drives one device
    (all its shards sit on it), so the group spans one per process."""
    import torch.distributed as dist

    up = dist.is_available() and dist.is_initialized()
    count = dist.get_world_size() if up else 1
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": count,
        "local_devices": 1,
        "global_devices": count,
    }
