"""Offline reconstruction entry point (counterpart of
`ra_slam_tpu/pipeline/offline_eval.py`).

Replays a dataset (`--sens` a ScanNet `.sens` file, `--folder` a logged
folder, `--synthetic` the box-room orbit), segments each frame that has
no maps (`--model` a flax msgpack checkpoint; without one, fake
all-ones maps), and fuses it into the semantic TSDF on `--device`: at
its ground-truth pose, or with `--use-slam` at the pose the SLAM system
tracks (frames it loses are not fused; the SLAM world is the first
camera's frame). With `--download`
it dumps the semantic voxels as `tsdf.bin` (packed (x, y, z, tsdf, prob)
float32 rows, the reference's metric input) and the mesh as
`mesh_vertices.bin`, `mesh_indices.bin` and `mesh_vertices_prob.bin`;
`--eval-gt` scores `tsdf.bin` against a labeled ScanNet mesh, and
`--render-every N` writes a raycast `render_{i:05d}.png` of every N-th
frame into the same directory. Prints one JSON line with the JAX CLI's
result keys, ATE/RPE of the tracked trajectory included.

    python -m ra_slam_tpu_torch.pipeline.offline_eval --synthetic \\
        --max-frames 60 --download out/ [--use-slam] [--render-every 10] \\
        [--eval-gt scene_vh_clean_2.labels.ply]
    python -m ra_slam_tpu_torch.pipeline.offline_eval --folder capture/ \\
        --model seg.msgpack --download out/

`--native-io` reads a `--sens` file through `SensReader.prefetch`: two
Python threads decode up to eight frames ahead of the device (the JAX
package's C++ decoder and prefetcher).
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--sens", help=".sens sequence path")
    src.add_argument("--folder", help="logged folder dataset path")
    src.add_argument("--synthetic", action="store_true",
                     help="synthetic box-room orbit")
    p.add_argument("--model", default=None,
                   help="segmentation checkpoint, flax msgpack (absent -> fake all-ones maps)")
    p.add_argument("--use-slam", action="store_true",
                   help="track with the SLAM system instead of the ground-truth poses")
    p.add_argument("--download", default=None,
                   help="output dir for tsdf.bin + mesh dumps")
    p.add_argument("--eval-gt", default=None,
                   help="ScanNet *_vh_clean_2.labels.ply for IoU scoring (with --download)")
    p.add_argument("--max-frames", type=int, default=0, help="0 = all")
    p.add_argument("--voxel-size", type=float, default=0.01)
    p.add_argument("--truncation", type=float, default=0.06)
    p.add_argument("--max-depth", type=float, default=6.0)
    p.add_argument("--log2-blocks", type=int, default=17)
    p.add_argument("--render-every", type=int, default=0,
                   help="dump a raycast PNG every N frames into --download")
    p.add_argument("--trajectory-out", default=None,
                   help="save the (SLAM) trajectory in id + 3x4 format")
    p.add_argument("--native-io", action="store_true",
                   help="decode --sens frames ahead in two threads (SensReader.prefetch)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the map (cuda runs the CUDA fuse kernel)")
    return p


def load_dataset(args):
    if args.sens:
        from ra_slam_tpu_torch.io.sens import SensReader

        return SensReader(args.sens)
    if args.folder:
        from ra_slam_tpu_torch.io.folder import FolderReader

        return FolderReader(args.folder)
    from ra_slam_tpu_torch.io.synthetic import SyntheticBoxDataset, SyntheticCameraSpec

    spec = SyntheticCameraSpec(
        fx=320.0, fy=320.0, cx=319.5, cy=239.5, width=640, height=480
    )
    return SyntheticBoxDataset(
        num_frames=120, cam=spec, half_extents=(3.0, 2.0, 3.0), radius=1.0
    )


def system_config(cam, args):
    """The map configuration of a run: the CLI's voxel size, truncation,
    depth cap and pool size, 4x as many hash slots as pool blocks, and
    16384 visible / 32768 new blocks per frame."""
    from ra_slam_tpu_torch.core.config import CameraConfig, SystemConfig, TsdfConfig

    return SystemConfig(
        camera=CameraConfig(
            fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
            width=cam.width, height=cam.height,
        ),
        tsdf=TsdfConfig(
            voxel_size=args.voxel_size,
            truncation=args.truncation,
            max_depth=args.max_depth,
            log2_num_blocks=args.log2_blocks,
            log2_hash_size=args.log2_blocks + 2,
            max_visible_blocks=1 << 14,
            max_new_blocks=1 << 15,
            width=cam.width,
            height=cam.height,
        ),
    )


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    from ra_slam_tpu_torch.core.se3 import SE3
    from ra_slam_tpu_torch.pipeline.system import RaSlamSystem

    ds = load_dataset(args)
    n = len(ds) if args.max_frames == 0 else min(args.max_frames, len(ds))
    cfg = system_config(ds.camera, args)
    sys_ = RaSlamSystem(cfg, args.device, segmentation_model=args.model,
                        enable_tracking=args.use_slam)

    if args.sens and args.native_io:  # decoding overlaps the device's work
        frames = ds.prefetch(num_threads=2, capacity=8)
    else:
        frames = (ds.frame(i) for i in range(n))

    t_int = t_track = 0.0
    gt_traj = []  # (frame_id, 3x4) ground-truth rows for ATE
    t0 = time.perf_counter()
    for i, fr in enumerate(itertools.islice(frames, n)):
        if fr.cam_T_world is not None:
            gt_traj.append((fr.frame_id, np.asarray(fr.cam_T_world)[:3, :4]))
        if args.use_slam:
            ts = time.perf_counter()
            info = sys_.feed_tracking_frame(fr.rgb, fr.depth, fr.timestamp)
            t_track += time.perf_counter() - ts
            if not info.tracked:
                continue
            pose = info.pose
        else:
            if fr.cam_T_world is None:
                raise ValueError(f"frame {i} has no ground-truth pose")
            pose = SE3.from_matrix(torch.as_tensor(fr.cam_T_world))
        ts = time.perf_counter()
        ht, lt = (fr.ht, fr.lt) if fr.ht is not None else (None, None)
        sys_.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, pose=pose, ht=ht, lt=lt)
        t_int += time.perf_counter() - ts

        if args.render_every and args.download and i % args.render_every == 0:
            from ra_slam_tpu_torch.io.png import write_png

            os.makedirs(args.download, exist_ok=True)
            rgba = sys_.render(pose)["rgba"].cpu().numpy().astype(np.uint8)
            write_png(os.path.join(args.download, f"render_{i:05d}.png"), rgba)
    frames.close()  # stops the prefetch threads
    sys_.synchronize()
    wall = time.perf_counter() - t0

    result = {
        "frames": sys_.num_integrated,
        "fps": round(sys_.num_integrated / max(wall, 1e-9), 2),
        "wall_s": round(wall, 2),
        "track_s": round(t_track, 2),
        "integrate_s": round(t_int, 2),
        **sys_.last_stats,
    }
    if args.download:
        os.makedirs(args.download, exist_ok=True)
        tsdf_path = os.path.join(args.download, "tsdf.bin")
        result["tsdf_rows"] = sys_.download_all(tsdf_path)
        nv, nt = sys_.download_all_mesh(
            os.path.join(args.download, "mesh_vertices.bin"),
            os.path.join(args.download, "mesh_indices.bin"),
            os.path.join(args.download, "mesh_vertices_prob.bin"),
        )
        result["mesh_vertices"], result["mesh_triangles"] = nv, nt

        if args.eval_gt:
            from ra_slam_tpu_torch.eval.scannet_eval import ScannetEval

            result["eval"] = ScannetEval(tsdf_path, args.eval_gt).summary()

    if args.use_slam:
        est_traj = sys_.slam.trajectory()
        result["tracked_frames"] = len(est_traj)
        result["loop_closures"] = sys_.slam.num_loop_closures
        if args.trajectory_out:
            from ra_slam_tpu_torch.io.folder import save_trajectory

            save_trajectory(args.trajectory_out, est_traj)
        if len(gt_traj) >= 3 and len(est_traj) >= 3:
            from ra_slam_tpu_torch.eval.ate import ate_rmse, rpe_rmse

            try:
                result["ate"] = ate_rmse(est_traj, gt_traj)
                result["rpe"] = rpe_rmse(est_traj, gt_traj, delta=1)
            except ValueError as e:
                result["ate_error"] = str(e)

    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
