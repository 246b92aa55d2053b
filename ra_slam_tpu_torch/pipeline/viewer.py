"""Offline map viewer (counterpart of `ra_slam_tpu/pipeline/viewer.py`):
raycast render sequences from a fused map along virtual-camera paths,
an orbit around the map or a follow-cam pulled back from a trajectory
(the reference's interactive renderer's orbit and follow-offset
controls), written as PNG sequences without cv2.

    python -m ra_slam_tpu_torch.pipeline.viewer --checkpoint ckpt/ \\
        --orbit 24 --out renders/ [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Iterable, List, Optional

import numpy as np
import torch

from ra_slam_tpu_torch.core.camera import PinholeCamera
from ra_slam_tpu_torch.core.config import TsdfConfig
from ra_slam_tpu_torch.core.se3 import SE3
from ra_slam_tpu_torch.io.png import write_png
from ra_slam_tpu_torch.map.raycast import raycast
from ra_slam_tpu_torch.map.voxel_map import VoxelMap


def shade_normal(normal: np.ndarray, hit: np.ndarray) -> np.ndarray:
    """Normal-shaded uint8 RGB image."""
    img = ((normal * 0.5 + 0.5) * 255.0).clip(0, 255).astype(np.uint8)
    return np.where(hit[..., None], img, 0)


def orbit_poses(
    center: np.ndarray, radius: float, height: float, n: int, up=(0.0, -1.0, 0.0)
) -> List[np.ndarray]:
    """n world_T_cam orbit poses looking at `center`."""
    from ra_slam_tpu_torch.io.synthetic import look_at

    out = []
    for i in range(n):
        a = 2 * np.pi * i / n
        eye = center + np.array([radius * np.cos(a), height, radius * np.sin(a)])
        out.append(look_at(eye, center, up))
    return out


def follow_poses(
    trajectory: Iterable[np.ndarray],  # cam_T_world 4x4 per frame
    offset: np.ndarray = np.array([0.0, -0.3, -1.0]),
) -> List[np.ndarray]:
    """Virtual follow-cam: each cam_T_world pose pulled back by `offset`
    in the camera frame; returns world_T_cam (what `render_path`
    takes)."""
    off = SE3(torch.eye(3), torch.as_tensor(np.asarray(offset, np.float32)))
    out = []
    for m in trajectory:
        virt = off @ SE3.from_matrix(torch.as_tensor(np.asarray(m, np.float32)))
        out.append(virt.inverse().as_matrix().numpy())
    return out


class MapViewer:
    """Renders RGB and normal-shaded views of a VoxelMap on its device."""

    def __init__(self, m: VoxelMap, cfg: TsdfConfig, cam: Optional[PinholeCamera] = None):
        self.m = m
        self.cfg = cfg
        self.cam = cam or PinholeCamera.create(
            cfg.width * 0.8, cfg.width * 0.8,
            (cfg.width - 1) / 2.0, (cfg.height - 1) / 2.0,
            cfg.width, cfg.height,
        )

    def render(self, cam_T_world: SE3) -> dict:
        pose = SE3(cam_T_world.R.to(self.m.device, torch.float32),
                   cam_T_world.t.to(self.m.device, torch.float32))
        out = {k: v.cpu().numpy() for k, v in raycast(self.m, self.cam, pose, self.cfg).items()}
        return {
            "rgba": out["rgba"].astype(np.uint8),
            "normal": shade_normal(out["normal"], out["hit"]),
            "depth": out["depth"],
            "hit": out["hit"],
        }

    def render_path(self, world_T_cam_list: Iterable[np.ndarray], out_dir: str,
                    save_normal: bool = True) -> int:
        """Render each world_T_cam pose into `rgb_{i:05d}.png` (RGBA) and,
        with `save_normal`, `normal_{i:05d}.png`; returns the count."""
        os.makedirs(out_dir, exist_ok=True)
        n = 0
        for i, w_T_c in enumerate(world_T_cam_list):
            c_T_w = np.linalg.inv(np.asarray(w_T_c, np.float64)).astype(np.float32)
            out = self.render(SE3.from_matrix(torch.as_tensor(c_T_w)))
            write_png(os.path.join(out_dir, f"rgb_{i:05d}.png"), out["rgba"])
            if save_normal:
                write_png(os.path.join(out_dir, f"normal_{i:05d}.png"), out["normal"])
            n += 1
        return n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", required=True,
                   help="system checkpoint dir (utils/checkpoint.py; the JAX package's loads too)")
    p.add_argument("--out", required=True)
    p.add_argument("--orbit", type=int, default=0, help="N orbit views")
    p.add_argument("--trajectory", default=None,
                   help="trajectory.txt to follow (with --follow-offset)")
    p.add_argument("--follow-offset", type=float, nargs=3, default=[0.0, -0.3, -1.0])
    p.add_argument("--voxel-size", type=float, default=0.01)
    p.add_argument("--truncation", type=float, default=0.06)
    p.add_argument("--max-depth", type=float, default=6.0)
    p.add_argument("--log2-blocks", type=int, default=17)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--device", default="cuda", help="torch device of the map")
    args = p.parse_args(argv)

    from ra_slam_tpu_torch.map.voxel_map import create_map, gather_valid
    from ra_slam_tpu_torch.pipeline.system import resolve_device
    from ra_slam_tpu_torch.utils.checkpoint import load_pytree

    device = resolve_device(args.device)
    cfg = TsdfConfig(
        voxel_size=args.voxel_size, truncation=args.truncation,
        max_depth=args.max_depth, log2_num_blocks=args.log2_blocks,
        log2_hash_size=args.log2_blocks + 2, width=args.width, height=args.height,
    )
    m = load_pytree(os.path.join(args.checkpoint, "map.npz"), create_map(cfg, device))
    viewer = MapViewer(m, cfg)

    poses = []
    if args.orbit:
        rows = gather_valid(m, cfg)
        center = rows[:, :3].mean(0) if len(rows) else np.zeros(3)
        extent = np.ptp(rows[:, :3], axis=0).max() if len(rows) else 2.0
        poses += orbit_poses(center, 0.8 * extent, -0.3 * extent, args.orbit)
    if args.trajectory:
        from ra_slam_tpu_torch.io.folder import load_trajectory

        poses += follow_poses([m_ for _, m_ in load_trajectory(args.trajectory)],
                              np.array(args.follow_offset))

    n = viewer.render_path(poses, args.out)
    print(f"rendered {n} views into {args.out}")
    return n


if __name__ == "__main__":
    main()
