"""Offline reconstruction entry point, known-pose path (counterpart of
`ra_slam_tpu/pipeline/offline_eval.py`).

Replays a dataset with its ground-truth poses, segments each frame (fake
mode), fuses it into the semantic TSDF on `--device`, and optionally
dumps the semantic voxels as `tsdf.bin` (packed (x, y, z, tsdf, prob)
float32 rows, the reference's metric input). Prints one JSON line with
the JAX CLI's result keys; the mesh keys wait for the meshing port.

    python -m ra_slam_tpu_torch.pipeline.offline_eval --synthetic \\
        --max-frames 60 --download out/

The `.sens` and folder readers are not ported yet (they need cv2 and
yaml); those flags raise.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--sens", help=".sens sequence path (not ported yet)")
    src.add_argument("--folder", help="logged folder dataset path (not ported yet)")
    src.add_argument("--synthetic", action="store_true",
                     help="synthetic box-room orbit")
    p.add_argument("--download", default=None, help="output dir for tsdf.bin")
    p.add_argument("--max-frames", type=int, default=0, help="0 = all")
    p.add_argument("--voxel-size", type=float, default=0.01)
    p.add_argument("--truncation", type=float, default=0.06)
    p.add_argument("--max-depth", type=float, default=6.0)
    p.add_argument("--log2-blocks", type=int, default=17)
    p.add_argument("--device", default="cuda",
                   help="torch device of the map (cuda runs the CUDA fuse kernel)")
    return p


def load_dataset(args):
    if args.sens or args.folder:
        raise NotImplementedError(
            "--sens/--folder: the .sens and folder readers are not ported yet; "
            "use --synthetic (or ra_slam_tpu.pipeline.offline_eval)"
        )
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
    sys_ = RaSlamSystem(cfg, args.device)

    t_int = 0.0
    t0 = time.perf_counter()
    for i in range(n):
        fr = ds.frame(i)
        if fr.cam_T_world is None:
            raise ValueError(f"frame {i} has no ground-truth pose")
        pose = SE3.from_matrix(torch.as_tensor(fr.cam_T_world))
        ts = time.perf_counter()
        sys_.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, pose=pose, ht=fr.ht, lt=fr.lt)
        t_int += time.perf_counter() - ts
    sys_.synchronize()
    wall = time.perf_counter() - t0

    result = {
        "frames": sys_.num_integrated,
        "fps": round(sys_.num_integrated / max(wall, 1e-9), 2),
        "wall_s": round(wall, 2),
        "track_s": 0.0,
        "integrate_s": round(t_int, 2),
        **sys_.last_stats,
    }
    if args.download:
        os.makedirs(args.download, exist_ok=True)
        result["tsdf_rows"] = sys_.download_all(os.path.join(args.download, "tsdf.bin"))

    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
