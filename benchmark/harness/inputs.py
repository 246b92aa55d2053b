"""A cell's inputs, made from the seed: the recorded sequence a replay
reads (a ScanNet `.sens` file) and the segmentation net's weights.

Frames are rendered on the device in batches, copied to the host, and
encoded there (`sens_writer`). The room and the walk are the same for
every seed; the depth noise comes from a device generator seeded from
`--seed`.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from . import scene, sens_writer, weights


@dataclass
class RgbdSequence:
    path: str
    world_T_cam: np.ndarray  # [N, 4, 4] float64 ground truth
    bytes_written: int
    render_s: float  # of the generation's seconds, those spent rendering and copying to the host


def depth_camera(config: dict):
    c = config["depth_camera"]
    return c["fx"], c["fy"], c["cx"], c["cy"], c["width"], c["height"]


def color_camera(config: dict):
    """The colour camera: the depth camera's field of view at the colour
    size (the reader resizes colour onto the depth image)."""
    fx, fy, cx, cy, w, h = depth_camera(config)
    cw, ch = config["color"]["width"], config["color"]["height"]
    sx, sy = cw / w, ch / h
    return fx * sx, fy * sy, (cx + 0.5) * sx - 0.5, (cy + 0.5) * sy - 0.5, cw, ch


def make_rgbd_sequence(config: dict, traffic: dict, seed: int, device, path: str,
                       batch: int = 8) -> RgbdSequence:
    room = scene.make_room(config["room"]["half_extents"], config["room"]["clutter"])
    w = traffic["walk"]
    poses = scene.walk(traffic["session_frames"], w["radii"], w["height"])
    gen = torch.Generator(device=device)
    gen.manual_seed(scene.seed_bits(seed + 1))
    dcam, ccam = depth_camera(config), color_camera(config)
    shift = float(config["depth"]["shift"])
    noise = float(config["depth"]["noise_per_m2"])

    render_s = 0.0

    def chunks():
        nonlocal render_s
        for lo in range(0, len(poses), batch):
            t = time.perf_counter()
            wTc = torch.as_tensor(poses[lo:lo + batch], dtype=torch.float64, device=device)
            rgb, _ = scene.render(room, wTc, *ccam, depth=False)
            _, z = scene.render(room, wTc, *dcam, colour=False)
            n = torch.randn(z.shape, generator=gen, device=device, dtype=torch.float32)
            raw = scene.sensor_depth(z, n, noise, shift)
            out = list(rgb.cpu().numpy()), [r.astype(np.uint16) for r in raw.cpu().numpy()]
            render_s += time.perf_counter() - t
            yield out

    fx, fy, cx, cy, dw, dh = dcam
    cfx, cfy, ccx, ccy, cw, ch = ccam
    nbytes = sens_writer.write_sens(
        path, chunks(), poses, sens_writer.k4(cfx, cfy, ccx, ccy), sens_writer.k4(fx, fy, cx, cy),
        (cw, ch), (dw, dh), shift, config["color"]["jpeg_quality"], config["depth"]["zlib_level"],
        config["fps"], threads=min(8, os.cpu_count() or 1))
    return RgbdSequence(path, poses, nbytes, render_s)


def make_segmentation_weights(config: dict, seed: int, device, path: str):
    """The net's weights from the seed on `device`, and their checkpoint
    written to `path` for the program to load."""
    wts = weights.make_weights(config["segmentation"]["widths"], scene.seed_bits(seed + 2), device)
    with open(path, "wb") as f:
        f.write(weights.checkpoint_bytes(wts))
    return wts

