"""Raw capture and factory-calibration tooling for stereo / RGB-D rigs
(counterpart of `ra_slam_tpu/io/capture.py`).

Grab raw side-by-side ZED stereo pairs over UVC (no ZED SDK) or L515
RGB-D frames for offline calibration, and parse the ZED factory
calibration `.conf` into the `Calibration.*` YAML keys that
`core/rectify.py:StereoRectifier.from_yaml` reads. `RESOLUTIONS`,
`parse_zed_conf` and `calib_to_yaml` are plain Python with the JAX
package's output text. The capture commands need hardware: `capture_zed`
imports cv2 (a UVC camera and a window), `capture_l515` pyrealsense2,
each only when called, and raise a clear error without it. Their PNGs
go through `io/png.py` (BGR camera frames flipped to RGB in numpy).

    python -m ra_slam_tpu_torch.io.capture zed  -r 720p -o out/ [-c 0]
    python -m ra_slam_tpu_torch.io.capture l515 -o out/
    python -m ra_slam_tpu_torch.io.capture calib SN12345.conf -r 720p
"""

from __future__ import annotations

import argparse
import configparser
import os
from typing import Dict, Tuple

import numpy as np

from ra_slam_tpu_torch.io.png import write_png

# ZED UVC side-by-side resolutions (per-eye width, height)
RESOLUTIONS: Dict[str, Tuple[int, int]] = {
    "2k": (2208, 1242),
    "1080p": (1920, 1080),
    "720p": (1280, 720),
    "vga": (672, 376),
}

# calibration-section suffix per resolution in the ZED factory .conf
_CALIB_SECTION = {"2k": "2K", "1080p": "FHD", "720p": "HD", "vga": "VGA"}


def parse_zed_conf(path: str, resolution: str) -> dict:
    """ZED factory calibration .conf -> the `Calibration.*` dict (fx, fy,
    cx, cy, k1..k3, p1, p2 per eye, the baseline in meters and the stereo
    rotation vector)."""
    cp = configparser.ConfigParser()
    with open(path) as f:
        cp.read_string(f.read())
    suf = _CALIB_SECTION[resolution]

    def cam(side: str) -> dict:
        s = cp[f"{side}_CAM_{suf}"]
        return {
            "fx": s.getfloat("fx"), "fy": s.getfloat("fy"), "cx": s.getfloat("cx"), "cy": s.getfloat("cy"),
            "k1": s.getfloat("k1", 0.0), "k2": s.getfloat("k2", 0.0), "k3": s.getfloat("k3", 0.0),
            "p1": s.getfloat("p1", 0.0), "p2": s.getfloat("p2", 0.0),
        }

    st = cp["STEREO"]
    return {
        "left": cam("LEFT"),
        "right": cam("RIGHT"),
        "baseline": st.getfloat("Baseline") / 1000.0,  # mm -> m
        "rotation": [st.getfloat(f"RX_{suf}", 0.0), st.getfloat(f"CV_{suf}", 0.0), st.getfloat(f"RZ_{suf}", 0.0)],
    }


def calib_to_yaml(calib: dict, width: int, height: int) -> str:
    """The parsed calibration as the reference-format YAML block
    (`Camera.cols/rows`, `Calibration.*`)."""
    lines = [f"Camera.cols: {width}", f"Camera.rows: {height}"]
    for side in ("left", "right"):
        c = calib[side]
        lines += [
            f"Calibration.{side}.fx: {c['fx']}",
            f"Calibration.{side}.fy: {c['fy']}",
            f"Calibration.{side}.cx: {c['cx']}",
            f"Calibration.{side}.cy: {c['cy']}",
            f"Calibration.{side}.distortion: [{c['k1']}, {c['k2']}, {c['p1']}, {c['p2']}, {c['k3']}]",
        ]
    lines += [
        f"Calibration.baseline: {calib['baseline']}",
        f"Calibration.rotation: {list(calib['rotation'])}",
    ]
    return "\n".join(lines) + "\n"


def capture_zed(output: str, resolution: str = "720p", camera: int = 0, gain: float | None = None,
                brightness: float | None = None, max_frames: int = 0) -> int:
    """Interactive raw side-by-side capture (UVC): SPACE saves a pair
    into output/left, output/right; q quits. Returns the pairs saved."""
    from ra_slam_tpu_torch.io.cameras import require_sdk

    cv2 = require_sdk("cv2", "ZED capture (a UVC camera and a preview window)")
    w, h = RESOLUTIONS[resolution]
    cap = cv2.VideoCapture(camera)
    if not cap.isOpened():
        raise RuntimeError(f"cannot open video device {camera}")
    cap.set(cv2.CAP_PROP_FRAME_WIDTH, w * 2)
    cap.set(cv2.CAP_PROP_FRAME_HEIGHT, h)
    cap.set(cv2.CAP_PROP_FPS, 60)
    if gain is not None:
        cap.set(cv2.CAP_PROP_GAIN, gain)
    if brightness is not None:
        cap.set(cv2.CAP_PROP_BRIGHTNESS, brightness)
    left_dir, right_dir = os.path.join(output, "left"), os.path.join(output, "right")
    os.makedirs(left_dir, exist_ok=True)
    os.makedirs(right_dir, exist_ok=True)
    n = 0
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            cv2.imshow("zed raw capture (SPACE=save, q=quit)", frame)
            key = cv2.waitKey(1) & 0xFF
            if key == ord("q"):
                break
            if key == ord(" "):
                rgb = np.ascontiguousarray(frame[..., ::-1])  # BGR -> RGB
                write_png(os.path.join(left_dir, f"{n:06d}.png"), rgb[:, :w])
                write_png(os.path.join(right_dir, f"{n:06d}.png"), rgb[:, w:])
                n += 1
                if max_frames and n >= max_frames:
                    break
    finally:
        cap.release()
    return n


def capture_l515(output: str, max_frames: int = 0) -> int:
    """Raw L515 RGB-D capture through pyrealsense2 into a logged-folder
    layout (`{i}_rgb.png`, `{i}_depth.png` in mm)."""
    from ra_slam_tpu_torch.io.cameras import RealSenseCamera

    cam = RealSenseCamera()
    os.makedirs(output, exist_ok=True)
    n = 0
    try:
        while True:
            rgb, depth, _ = cam.get_rgbd_frame()
            write_png(os.path.join(output, f"{n}_rgb.png"), np.ascontiguousarray(rgb, np.uint8))
            write_png(os.path.join(output, f"{n}_depth.png"), (np.asarray(depth) * 1000.0).astype(np.uint16))
            n += 1
            if max_frames and n >= max_frames:
                break
    finally:
        cam.close()
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    pz = sub.add_parser("zed", help="raw UVC stereo capture")
    pz.add_argument("-r", "--resolution", choices=RESOLUTIONS, default="720p")
    pz.add_argument("-o", "--output", required=True)
    pz.add_argument("-c", "--camera", type=int, default=0)
    pz.add_argument("-g", "--gain", type=float, default=None)
    pz.add_argument("-b", "--brightness", type=float, default=None)
    pz.add_argument("-n", "--max-frames", type=int, default=0)

    pl = sub.add_parser("l515", help="raw RGB-D capture")
    pl.add_argument("-o", "--output", required=True)
    pl.add_argument("-n", "--max-frames", type=int, default=0)

    pc = sub.add_parser("calib", help="parse ZED factory .conf to YAML")
    pc.add_argument("conf", help="SN*.conf factory calibration file")
    pc.add_argument("-r", "--resolution", choices=RESOLUTIONS, default="720p")
    pc.add_argument("-o", "--output", default=None, help="YAML out (stdout)")

    args = p.parse_args(argv)
    if args.cmd == "zed":
        n = capture_zed(args.output, args.resolution, args.camera, args.gain, args.brightness, args.max_frames)
        print(f"saved {n} stereo pairs")
    elif args.cmd == "l515":
        print(f"saved {capture_l515(args.output, args.max_frames)} rgbd frames")
    else:
        w, h = RESOLUTIONS[args.resolution]
        yaml_text = calib_to_yaml(parse_zed_conf(args.conf, args.resolution), w, h)
        if args.output:
            with open(args.output, "w") as f:
                f.write(yaml_text)
        else:
            print(yaml_text)


if __name__ == "__main__":
    main()
