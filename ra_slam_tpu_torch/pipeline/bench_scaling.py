"""Sharded fusion scaling benchmark (counterpart of
`ra_slam_tpu/pipeline/bench_scaling.py`).

Measures TSDF-fused frames/s of the sharded integrate step
(`alloc_stride=2`, no allocation failure allowed) on the synthetic VGA
orbit and, in one process over several shards, the same on one shard:
the scaling efficiency fps_n / (n * fps_1).

n `LocalMesh` shards on one device (default cuda):
    python -m ra_slam_tpu_torch.pipeline.bench_scaling --devices 4

N processes of one shard each (gloo with --device cpu; NCCL with
--device cuda needs N GPUs, and fewer raise):
    python -m ra_slam_tpu_torch.pipeline.bench_scaling --spawn 2 --device cpu

A process of a multi-host run: export RA_SLAM_COORDINATOR,
RA_SLAM_NUM_PROCESSES and RA_SLAM_PROCESS_ID and run without --spawn.

On one GPU the shards share the device, so the efficiency there measures
what partitioning costs (n smaller pools, n passes over each frame), not
a speedup; the JSON line says which.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

from ra_slam_tpu_torch.core.device import resolve_device


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _bench_mesh(mesh, cfg, frames, cam, poses) -> float:
    from ra_slam_tpu_torch.parallel.sharded_map import create_sharded_map, make_sharded_integrate_step

    step = make_sharded_integrate_step(mesh, cfg, alloc_stride=2)
    shards, stats = step(create_sharded_map(cfg, mesh), *frames[0], cam, poses[0])  # warm-up
    int(stats["num_active"])
    del shards

    shards = create_sharded_map(cfg, mesh)
    _sync(mesh.device)
    t0 = time.perf_counter()
    for fr, pose in zip(frames, poses):
        shards, stats = step(shards, *fr, cam, pose)
    int(stats["num_active"])
    _sync(mesh.device)
    dt = time.perf_counter() - t0
    assert int(stats["alloc_failures"]) == 0, f"{int(stats['alloc_failures'])} allocation failures"
    return len(frames) / dt


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--devices", type=int, default=1, help="LocalMesh shards in this process")
    p.add_argument("--spawn", type=int, default=0, help="spawn N local processes of one shard each")
    p.add_argument("--device", default="cuda", help="torch device of the shards (cuda or cpu)")
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--coordinator", default=None, help="host:port of the process group (default: a free port)")
    # map scale (defaults: the small map; 0.01/17/19 is the headline scale)
    p.add_argument("--voxel-size", type=float, default=0.02)
    p.add_argument("--log2-blocks", type=int, default=15)
    p.add_argument("--log2-hash", type=int, default=17)
    p.add_argument("--no-baseline", action="store_true", help="skip the one-shard baseline row")
    return p


def _spawn(args) -> dict:
    import torch

    if args.device.startswith("cuda"):
        n_gpu = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_gpu < args.spawn:
            raise RuntimeError(f"--spawn {args.spawn} over NCCL needs {args.spawn} GPUs; this machine has {n_gpu}")
    coordinator = args.coordinator or f"localhost:{free_port()}"
    cmd = [sys.executable, "-m", "ra_slam_tpu_torch.pipeline.bench_scaling", "--devices", "1",
           "--device", args.device, "--frames", str(args.frames), "--voxel-size", str(args.voxel_size),
           "--log2-blocks", str(args.log2_blocks), "--log2-hash", str(args.log2_hash), "--no-baseline"]
    procs = []
    for pid in range(args.spawn):
        env = dict(os.environ, RA_SLAM_COORDINATOR=coordinator, RA_SLAM_NUM_PROCESSES=str(args.spawn),
                   RA_SLAM_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, text=True))
    try:
        outs = [q.communicate(timeout=1800)[0] for q in procs]
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.wait()
    rcs = [q.returncode for q in procs]
    assert all(r == 0 for r in rcs), f"worker exit codes {rcs}"
    line = next(ln for ln in outs[0].splitlines() if ln.startswith("{"))
    print(line)
    return {"spawned": args.spawn, **json.loads(line)}


def run(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.spawn > 1:
        return _spawn(args)

    import numpy as np
    import torch

    from ra_slam_tpu_torch.core.config import TsdfConfig
    from ra_slam_tpu_torch.core.se3 import SE3
    from ra_slam_tpu_torch.io.synthetic import SyntheticBoxDataset, SyntheticCameraSpec
    from ra_slam_tpu_torch.parallel.distributed import global_mesh, initialize_distributed, process_info
    from ra_slam_tpu_torch.parallel.mesh import LocalMesh

    device = resolve_device(args.device)
    initialize_distributed(device=device)
    mesh = global_mesh(devices=[device] * args.devices)
    device = mesh.device

    spec = SyntheticCameraSpec(fx=320.0, fy=320.0, cx=319.5, cy=239.5, width=640, height=480)
    ds = SyntheticBoxDataset(num_frames=args.frames, cam=spec, half_extents=(3.0, 2.0, 3.0), radius=1.0)
    cfg = TsdfConfig(
        voxel_size=args.voxel_size, truncation=6 * args.voxel_size, max_depth=6.0,
        log2_num_blocks=args.log2_blocks, log2_hash_size=args.log2_hash,
        max_visible_blocks=1 << 13, max_new_blocks=1 << 14, width=640, height=480,
    )
    raw = [ds.frame(i) for i in range(args.frames)]
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    frames = [(t(f.rgb), t(f.depth), t(f.ht), t(f.lt)) for f in raw]
    poses = [SE3.from_matrix(t(f.cam_T_world)) for f in raw]
    cam = ds.camera

    fps_n = _bench_mesh(mesh, cfg, frames, cam, poses)
    info = process_info()
    out = {
        "metric": "sharded_fused_frames_per_sec",
        "value": round(fps_n, 2),
        "n_devices": mesh.size,
        "device": str(device),
        **info,
    }
    if info["process_count"] == 1 and mesh.size > 1 and not args.no_baseline:
        fps_1 = _bench_mesh(LocalMesh(1, device), cfg, frames, cam, poses)
        out["fps_1dev"] = round(fps_1, 2)
        out["scaling_efficiency"] = round(fps_n / (mesh.size * fps_1), 3)
        out["note"] = (f"{mesh.size} shards on one {device.type} device: the efficiency is the cost of "
                       "partitioning the map, not a multi-device speedup")
    if info["process_index"] == 0:
        print(json.dumps(out))
    if info["process_count"] > 1:
        torch.distributed.destroy_process_group()
    return out


if __name__ == "__main__":
    run()
