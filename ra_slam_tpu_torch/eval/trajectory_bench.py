"""End-to-end trajectory accuracy of RGB-D tracking (counterpart of
`ra_slam_tpu/eval/trajectory_bench.py`).

Tracks the seeded synthetic box-room orbit (a full 360-degree loop plus
a revisit, multiplicative depth noise) with `SlamSystem` on `--device`,
loop closing on (retrieval gap 15 keyframes, as the JAX bench) unless
`--no-loop`, exports the per-frame trajectory through the
`trajectory.txt` format, reads it back and reports ATE/RPE, keyframes,
loop closures, relocalizations, lost frames, the tracking rate and the
host syncs per frame.

    python -m ra_slam_tpu_torch.eval.trajectory_bench \\
        --width 640 --height 480 --frames 150 [--no-loop]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch


def tracking_setup(
    width: int = 320,
    height: int = 240,
    depth_noise: float = 0.005,
    seed: int = 0,
    scene_kw: Optional[dict] = None,
    device="cuda",
    loop_closure: bool = True,
    **slam_kw,
):
    """(dataset, SlamSystem) of the bench: the 120-frame orbit at
    `width` x `height` and the bench's tracking configuration, loop
    closing on or off, any `slam_kw` overriding it."""
    from ra_slam_tpu_torch.core.config import FeatureConfig, TrackingConfig
    from ra_slam_tpu_torch.io.synthetic import SyntheticBoxDataset, SyntheticCameraSpec
    from ra_slam_tpu_torch.slam.system import SlamSystem

    f = width / 2.0
    spec = SyntheticCameraSpec(
        fx=f, fy=f, cx=width / 2 - 0.5, cy=height / 2 - 0.5, width=width, height=height
    )
    ds = SyntheticBoxDataset(
        num_frames=120, cam=spec, radius=1.0, depth_noise=depth_noise, seed=seed,
        **(scene_kw or {}),
    )
    kw = dict(
        fcfg=FeatureConfig(max_num_keypoints=600, num_levels=4),
        # pixel thresholds are angular: calibrated at 320 wide, scaled
        tcfg=TrackingConfig(min_inliers=15, match_radius=30.0).scaled(width / 320.0),
        ba_window=6, ba_max_points=2048, ba_iterations=5,
        loop_every_kf=1, loop_min_inliers=20,
        loop_min_gap=15 if loop_closure else 10**6,
        loop_max_rmse=3.0 * (width / 320.0),
        reloc_max_rmse=3.0 * (width / 320.0),
        device=device,
    )
    return ds, SlamSystem(ds.camera, **{**kw, **slam_kw})


def run_trajectory_eval(
    n_frames: int = 150,
    width: int = 320,
    height: int = 240,
    depth_noise: float = 0.005,
    loop_closure: bool = True,
    trajectory_out: Optional[str] = None,
    seed: int = 0,
    progress: bool = False,
    scene_kw: Optional[dict] = None,
    device="cuda",
    return_system: bool = False,
    **slam_kw,
):
    """Track the replay sequence; return the metrics dict of the JAX
    bench (ate_rmse_m, rpe_trans_rmse_m, matched_frames, keyframes,
    loop_closures, relocalizations, lost_frames, slam_fps, ...) plus
    `host_syncs_per_frame`; with `return_system`, (metrics, the
    SlamSystem after the run)."""
    from ra_slam_tpu_torch.core.se3 import SE3
    from ra_slam_tpu_torch.eval.ate import ate_rmse, rpe_rmse
    from ra_slam_tpu_torch.io.folder import load_trajectory, save_trajectory
    from ra_slam_tpu_torch.slam import system as slam_system

    ds, slam = tracking_setup(width, height, depth_noise, seed, scene_kw, device, loop_closure, **slam_kw)
    dev = slam.device

    gt, infos = [], []
    syncs0 = slam_system.SYNCS
    t0 = time.perf_counter()
    t_first = None  # after frame 0: separates warm-up from steady state
    for i in range(n_frames):
        fr = ds.frame(i)
        hint = SE3.from_matrix(torch.as_tensor(fr.cam_T_world)) if i == 0 else None
        infos.append(slam.feed_rgbd_frame(fr.rgb, fr.depth, fr.timestamp, frame_id=i, pose_hint=hint))
        gt.append((i, np.asarray(fr.cam_T_world)[:3, :4]))
        if i == 0:
            infos[0].block()
            t_first = time.perf_counter()
        if progress and i % 25 == 24:
            print(f"  frame {i + 1}/{n_frames} ({time.perf_counter() - t0:.0f}s)", flush=True)
    infos[-1].block()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_end = time.perf_counter()
    syncs = slam_system.SYNCS - syncs0
    lost = sum(0 if inf.tracked else 1 for inf in infos)

    # replay-loop fidelity: export through trajectory.txt and read it back
    est = slam.trajectory()
    if trajectory_out is None:
        fd, path = tempfile.mkstemp(suffix="_trajectory.txt")
        os.close(fd)
    else:
        path = trajectory_out
    save_trajectory(path, est)
    est = load_trajectory(path)
    if trajectory_out is None:
        os.unlink(path)

    m = ate_rmse(est, gt)
    r = rpe_rmse(est, gt, delta=1)
    out = {
        "ate_rmse_m": round(float(m["ate_rmse"]), 4),
        "rpe_trans_rmse_m": round(float(r["rpe_trans_rmse"]), 4),
        "matched_frames": int(m["matched_frames"]),
        "total_frames": n_frames,
        "keyframes": int(slam.state.track.kf_counter),
        "loop_closures": slam.num_loop_closures,
        "relocalizations": slam.num_relocalizations,
        "lost_frames": lost,
        "slam_fps": round(n_frames / (t_end - t0), 2),
        "steady_state_fps": round((n_frames - 1) / max(t_end - t_first, 1e-9), 2),
        "compile_s": round(t_first - t0, 1),
        "host_syncs_per_frame": round(syncs / n_frames, 3),
        "depth_noise": depth_noise,
        "loop_closure": loop_closure,
        "device": str(dev),
    }
    return (out, slam) if return_system else out


def main(argv=None, return_system: bool = False):
    """The CLI; returns the metrics dict (and the system, with
    `return_system`)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--frames", type=int, default=150)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--depth-noise", type=float, default=0.005)
    p.add_argument("--no-loop", action="store_true")
    p.add_argument("--trajectory-out", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json-out", default=None, help="also write the metrics JSON to this path")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda runs the CUDA Hamming kernel)")
    args = p.parse_args(argv)
    out = run_trajectory_eval(
        n_frames=args.frames, width=args.width, height=args.height,
        depth_noise=args.depth_noise, loop_closure=not args.no_loop,
        trajectory_out=args.trajectory_out, seed=args.seed, progress=True,
        device=args.device, return_system=return_system,
    )
    metrics = out[0] if return_system else out
    print(json.dumps(metrics))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(metrics, f, indent=1)
    return out


if __name__ == "__main__":
    main()
