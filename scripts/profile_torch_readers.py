"""Where the time of the PyTorch port's map readers goes, on one NVIDIA
GPU: raycast (`RaSlamSystem.render`) and meshing (`extract_mesh`) of the
main path's map (60 frames of the VGA synthetic orbit fused at the
offline_eval defaults: 1 cm voxels, 2^17 blocks).

    python3 scripts/profile_torch_readers.py

Prints, each line ending with the card's nvidia-smi name and power limit:
  - render: wall time per call (host clock, each call closed by a device
    sync) over the 60 orbit poses; then 10 renders under torch.profiler:
    the device's busy share of the wall and device time by kernel;
  - mesh: wall time of 3 extractions, then one under torch.profiler;
  - for each, the bytes its inputs and outputs need at least, over the
    card's 3.35 TB/s, beside the measured device time.
"""

import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ra_slam_tpu_torch.core.se3 import SE3  # noqa: E402
from ra_slam_tpu_torch.map.meshing import extract_mesh  # noqa: E402
from ra_slam_tpu_torch.pipeline import offline_eval  # noqa: E402
from ra_slam_tpu_torch.pipeline.system import RaSlamSystem  # noqa: E402

N_FRAMES = 60
HBM_BYTES_PER_S = 3.35e12
TOP = 15


def _busy_us(events) -> float:
    """Length of the union of the events' device intervals."""
    busy, cur = 0.0, None
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in events):
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    return busy + (cur[1] - cur[0] if cur else 0.0)


def _profile(label, fn, calls, card):
    """Device busy share and device time by kernel name of `calls` calls."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = _busy_us(dev)
    print(f"{label}, {calls} calls under the profiler: wall {wall_us / calls / 1e3:.3f} ms/call, "
          f"device busy {busy / calls / 1e3:.3f} ms/call = {busy / wall_us:.3f} of wall, "
          f"{len(dev) / calls:.0f} device events/call; {card}")
    names = {}
    for e in dev:
        f = names.setdefault(e.name[:90], [0.0, 0])
        f[0] += e.time_range.elapsed_us()
        f[1] += 1
    total = sum(us for us, _ in names.values())
    for name, (us, n) in sorted(names.items(), key=lambda kv: -kv[1][0])[:TOP]:
        print(f"  {us / calls / 1e3:8.4f} ms/call {100 * us / total:5.1f}%  x{n // calls:4d}  {name}")
    return busy / calls / 1e3


def main():
    if not torch.cuda.is_available():
        sys.exit("profile_torch_readers: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    args = offline_eval.build_parser().parse_args(["--synthetic"])
    ds = offline_eval.load_dataset(args)
    cfg = offline_eval.system_config(ds.camera, args)
    s = RaSlamSystem(cfg, "cuda", enable_tracking=False)
    for i in range(N_FRAMES):
        fr = ds.frame(i)
        s.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, ht=fr.ht, lt=fr.lt,
                          pose=SE3.from_matrix(torch.as_tensor(fr.cam_T_world)))
    s.synchronize()
    tsdf = cfg.tsdf
    n_active = int(s.map.active.sum())
    print(f"map: {N_FRAMES} frames fused, {n_active} active blocks; {card}")

    # --- raycast ---------------------------------------------------------------
    poses = [SE3.from_matrix(torch.as_tensor(
        np.linalg.inv(ds.world_T_cam(i).astype(np.float64)).astype(np.float32))) for i in range(N_FRAMES)]
    for p in poses[:3]:
        s.render(p)
    times = []
    for p in poses:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = s.render(p)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"render: {len(poses)} VGA poses, wall per call median {np.median(times):.3f} ms "
          f"(min {min(times):.3f}, max {max(times):.3f}), {len(poses) / sum(times) * 1e3:.2f} renders/s; {card}")
    dev_ms = _profile("render", lambda: s.render(poses[0]), 10, card)
    # least bytes: the block keys and the active mask (cull), tsdf and
    # weight rows of the visible blocks, rgb and prob rows of the shell
    # blocks, the images written (depth, rgba, normal, hit)
    from ra_slam_tpu_torch.map.voxel_map import visible_blocks

    p0 = SE3(poses[0].R.cuda(), poses[0].t.cuda())
    _, vis_mask, _ = visible_blocks(s.map, s.tsdf_cam, p0, tsdf)
    n_vis = int(vis_mask.sum())
    n_shell = min(n_vis, tsdf.max_visible_blocks // 2)
    n_pix = s.tsdf_cam.width * s.tsdf_cam.height
    nbytes = s.map.num_blocks * 5 + n_vis * 512 * 8 + n_shell * 512 * 16 + n_pix * (4 + 16 + 12 + 1)
    print(f"render least bytes ({n_vis} visible blocks, <= {n_shell} shell blocks): "
          f"{nbytes / 1e6:.1f} MB = {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s, "
          f"against {dev_ms:.3f} ms of device time per call; {card}")

    # --- meshing ---------------------------------------------------------------
    extract_mesh(s.map, tsdf)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v, idx, p = extract_mesh(s.map, tsdf)
        times.append(time.perf_counter() - t0)
    print(f"mesh: {len(idx)} triangles, {len(v)} vertices, wall {', '.join(f'{t:.3f}' for t in times)} s; {card}")
    dev_ms = _profile("mesh", lambda: extract_mesh(s.map, tsdf), 1, card)
    # least bytes: tsdf, weight and prob rows of the active blocks, the
    # hash table, the int32 indices and the vertex and prob arrays out
    nbytes = n_active * 512 * 12 + s.map.table.key.numel() * 8 + idx.nbytes + v.nbytes + p.nbytes
    print(f"mesh least bytes: {nbytes / 1e6:.1f} MB = {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms at "
          f"3.35 TB/s, against {dev_ms:.3f} ms of device time; {card}")


if __name__ == "__main__":
    main()
