"""Live robot pipeline: a stereo tracking thread and an RGB-D mapping
thread (counterpart of `ra_slam_tpu/pipeline/live.py`).

Two free-running camera loops bridged only by the timestamped pose
buffer: one thread feeds the rectified stereo camera into SLAM
(`RaSlamSystem.feed_stereo_frame`: the Hamming kernel on every frame),
the other feeds the RGB-D camera through segmentation into the TSDF map
at the timestamp-interpolated tracked poses (`feed_rgbd_frame`: the fuse
kernel on every frame), and the main thread writes raycast previews
(`live_{i:05d}.png`, RGBA through `io/png.py`) and handles shutdown.

Both threads share one device. That is safe: the facade's `RLock`
serialises tracking, fusion and rendering on the map and the SLAM state
(`pipeline/system.py`), the pose buffer has its own lock
(`utils/pose_buffer.py`), segmentation runs outside the lock on the
mapping thread, and torch orders the two threads' launches on the
device's stream.

    python -m ra_slam_tpu_torch.pipeline.live --config zed_l515.yaml \\
        --model seg.msgpack --out previews --device cuda

`main` needs a ZED on UVC (cv2) and a RealSense (pyrealsense2); `run`
takes any objects with `get_stereo_frame()` / `get_rgbd_frame()`. The
config's `Camera` section becomes the rectified ZED (as the reference's
`GetAndSetConfig` rewrites it); the RGB-D frames are fused with the
depth camera's own intrinsics: the config's `DepthCamera` section, else
the RealSense's colour stream, which its depth is aligned to.

A config with a `DenseStereo` section is the ZED alone as the RGB-D
camera (the reference's `ZED::GetStereoAndRGBDFrame`): no RealSense is
opened, and `io/cameras.py:ZedDepthCamera` grabs the raw pairs at twice
the `Camera` section's width and rectifies them on the device. `run`
drives both threads from it: the tracking thread feeds each pair and
hands it on with its tracked pose; the mapping thread computes the
tracked pairs' dense depth on the device and fuses each left image at
its pair's own tracked pose.

    python -m ra_slam_tpu_torch.pipeline.live --config zed_sdk.yaml \\
        --model seg.msgpack --out previews --device cuda
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import queue
import threading
import time

HANDOFF_PAIRS = 4  # tracked pairs the one-camera rig queues for its mapping thread


def run(system, stereo_cam, rgbd_cam=None, out_dir=None, render_every_s=2.0, stop_after_s=None,
        stop_after_frames=None):
    """The reference's `run()` thread layout. Camera threads are daemon
    threads joined with a 30 s timeout on shutdown: the join lets
    in-flight device work finish, and a camera hung inside `get_*` is
    logged and abandoned rather than wedging the interpreter's exit. A
    camera thread's exception stops the session and is re-raised.
    Without `rgbd_cam`, `stereo_cam` gives the depth too (`depth(left,
    right)`, as `ZedDepthCamera`): each pair, once fed to tracking, waits
    in a queue of `HANDOFF_PAIRS` for the mapping thread with its
    tracking result (none is dropped). The mapping thread passes over the
    pairs that did not track, and fuses each tracked pair's left image
    and depth at that pair's own tracked pose: the tracker may be pairs
    ahead by then, lost or recovered. `tsdf_frames` counts the pairs it
    took, fused or passed over. Returns (previews, slam_frames,
    tsdf_frames)."""
    stop = threading.Event()
    counts = {"slam": 0, "tsdf": 0}
    errors: list = []

    def stop_if_done():
        if errors or (
            stop_after_frames is not None
            and counts["slam"] >= stop_after_frames
            and counts["tsdf"] >= stop_after_frames
        ):
            stop.set()

    def loop(name, get, feed):
        try:
            while not stop.is_set():
                frame = get()
                if stop.is_set():
                    break
                feed(*frame)
                counts[name] += 1
                if stop_after_frames is not None and counts[name] >= stop_after_frames:
                    break
        except Exception as e:  # a camera or device fault ends the session
            errors.append((name, e))
        finally:
            stop_if_done()

    if rgbd_cam is not None:
        feed_stereo, get_rgbd = system.feed_stereo_frame, rgbd_cam.get_rgbd_frame
        feed_rgbd = system.feed_rgbd_frame
    else:  # one camera: the tracked pairs, their depth and their own poses
        pairs: queue.Queue = queue.Queue(maxsize=HANDOFF_PAIRS)

        def feed_stereo(left, right, ts):
            info = system.feed_stereo_frame(left, right, ts)  # read on the mapping thread
            while not stop.is_set():
                try:
                    pairs.put((left, right, ts, info), timeout=0.05)
                    return
                except queue.Full:
                    pass

        def get_rgbd():
            while not stop.is_set():
                try:
                    return pairs.get(timeout=0.05)
                except queue.Empty:
                    pass
            return None  # stopped: `loop` leaves before feeding

        def feed_rgbd(left, right, ts, info):
            if info.tracked:
                system.feed_rgbd_frame(left, stereo_cam.depth(left, right), ts, pose=info.pose)

    threads = [
        threading.Thread(target=loop, name="t_slam", args=("slam", stereo_cam.get_stereo_frame, feed_stereo)),
        threading.Thread(target=loop, name="t_tsdf", args=("tsdf", get_rgbd, feed_rgbd)),
    ]
    for t in threads:
        t.daemon = True
        t.start()

    def render_preview(i):
        pose = system.slam.pose_buffer.latest() if system.slam else None
        if pose is None or not out_dir:
            return False
        import numpy as np

        from ra_slam_tpu_torch.io.png import write_png

        rgba = system.render(pose)["rgba"].cpu().numpy().astype(np.uint8)
        os.makedirs(out_dir, exist_ok=True)
        write_png(os.path.join(out_dir, f"live_{i:05d}.png"), rgba)
        return True

    t0 = time.monotonic()
    last_render = t0
    i = 0
    try:
        while not stop.is_set() and any(t.is_alive() for t in threads):
            time.sleep(0.05)
            now = time.monotonic()
            if now - last_render >= render_every_s:
                last_render = now
                i += int(render_preview(i))
            if stop_after_s and now - t0 > stop_after_s:
                break
    except KeyboardInterrupt:
        pass
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30.0)
            if t.is_alive():
                logging.getLogger(__name__).error(
                    "camera thread %s did not stop within 30 s (camera hung in capture?); abandoning it", t.name)
    if i == 0:  # the session ended before the first render tick
        i += int(render_preview(0))
    if errors:
        name, e = errors[0]
        raise RuntimeError(f"camera thread '{name}' failed: {e}") from e
    return i, counts["slam"], counts["tsdf"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True, help="system YAML (reference schema)")
    p.add_argument("--calib", default=None,
                   help="stereo calibration YAML (Calibration.* keys); defaults to --config")
    p.add_argument("--model", default=None, help="segmentation checkpoint (flax msgpack)")
    p.add_argument("--out", default=None, help="render preview dir")
    p.add_argument("--zed-device", type=int, default=0)
    p.add_argument("--duration", type=float, default=None, help="seconds")
    p.add_argument("--device", default="cuda", help="torch device of tracking, segmentation and the map")
    args = p.parse_args(argv)

    from ra_slam_tpu_torch.core.config import load_yaml_config
    from ra_slam_tpu_torch.core.rectify import StereoRectifier, rewrite_camera_config
    from ra_slam_tpu_torch.io.cameras import RealSenseCamera, ZedDepthCamera, ZedNativeCamera
    from ra_slam_tpu_torch.pipeline.system import RaSlamSystem

    cfg = load_yaml_config(args.config)
    rectifier = StereoRectifier.from_yaml(args.calib or args.config, device=args.device)
    if cfg.dense_stereo is not None:  # the ZED alone: its pairs and its own depth
        w, h = rectifier.img_size
        zed = ZedDepthCamera(rectifier, rectifier.focal_x_baseline, device_id=args.zed_device, width=2 * w,
                             height=h, fps=int(cfg.camera.fps), max_disparity=cfg.dense_stereo.max_disparity,
                             max_depth=cfg.dense_stereo.max_depth, device=args.device)
        try:
            system = RaSlamSystem(rewrite_camera_config(cfg, rectifier), args.device, segmentation_model=args.model)
            n, n_slam, n_tsdf = run(system, zed, None, out_dir=args.out, stop_after_s=args.duration)
            print(f"live session done: {system.num_integrated} frames fused "
                  f"({n_slam} pairs fed / {n_tsdf} mapped), {n} previews")
        finally:
            zed.close()
        return
    stereo = ZedNativeCamera(rectifier, device_id=args.zed_device)
    try:
        rgbd = RealSenseCamera()
    except BaseException:
        stereo.close()
        raise
    try:
        cfg = dataclasses.replace(rewrite_camera_config(cfg, rectifier),
                                  depth_camera=cfg.depth_camera or rgbd.camera)
        system = RaSlamSystem(cfg, args.device, segmentation_model=args.model)
        n, n_slam, n_tsdf = run(system, stereo, rgbd, out_dir=args.out, stop_after_s=args.duration)
        print(f"live session done: {system.num_integrated} frames fused "
              f"({n_slam} pairs fed / {n_tsdf} mapped), {n} previews")
    finally:
        stereo.close()
        rgbd.close()


if __name__ == "__main__":
    main()
