"""The robot rig's inputs, made from the seed: the ZED's raw side-by-side
pairs and the L515's colour and z16 depth, as the two cameras hand them
over, rendered on the device in batches and held on the host.

Both cameras run on one clock of `clock_hz` ticks: ZED pair i at tick
`zed_every * i`, L515 frame j at tick `l515_first + l515_every * j`; a
timestamp is its tick over `clock_hz`. The rig moves along
`scene.walk(lap_ticks, ...)`, one pose a tick: the walk is the ZED's raw
left camera. The ZED's raw views are rendered through their distortion:
a pinhole canvas at the camera's focal length that holds every raw
pixel's ray is rendered (`scene.render`), and each raw pixel samples it
bilinearly at its undistorted ray; then the seed's pixel noise. The
L515 is placed by the extrinsics from the rectified left camera (the
camera the program tracks); its colour and depth come from one render
at its intrinsics, the depth with the seed's noise, in z16 units.

The truth of the tracked camera is the rectified left camera's pose,
world_T_rect = world_T_left R1^T, with the reference's rectifying
rotation R1 (`benchmark/reference/rig.py`).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.harness import scene
from benchmark.reference import rig


@dataclass
class RigInputs:
    zed_raw: np.ndarray  # [N, h, 2 w, 3] uint8 side-by-side, distorted, unrectified
    zed_t: np.ndarray  # [N] seconds
    zed_truth: np.ndarray  # [N, 4, 4] float64 world_T_cam of the rectified left camera
    l515_rgb: np.ndarray  # [M, H, W, 3] uint8
    l515_z16: np.ndarray  # [M, H, W] uint16
    l515_t: np.ndarray  # [M] seconds
    render_s: float  # of the generation's seconds, those spent rendering and copying to the host


def calibration(config: dict):
    """(left, right, rotation, translation, (w, h)) of the ZED."""
    z = config["zed"]
    c = z["calibration"]
    return c["left"], c["right"], c["rotation"], c["translation"], (z["width"], z["height"])


def l515_T_zed(config: dict) -> np.ndarray:
    return np.asarray(config["extrinsics"]["l515_T_zed"], np.float64)


def _raw_sampler(cam: dict, size, device, iterations: int = 30):
    """(canvas intrinsics (fx, fy, cx, cy, w, h), grid [1, h, w, 2]) of a
    raw camera: the canvas holds each raw pixel's undistorted ray, the
    grid is where each raw pixel samples it (grid_sample's normalised
    coordinates, align_corners=True)."""
    w, h = size
    u, v = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    xy = rig.undistort(np.stack([u.ravel(), v.ravel()], -1), rig.k_matrix(cam), cam["distortion"], iterations)
    cu = cam["fx"] * xy[:, 0] + cam["cx"]
    cv = cam["fy"] * xy[:, 1] + cam["cy"]
    u0, v0 = math.floor(cu.min()) - 1, math.floor(cv.min()) - 1
    cw, ch = math.ceil(cu.max()) - u0 + 2, math.ceil(cv.max()) - v0 + 2
    gx = 2 * (cu - u0) / (cw - 1) - 1
    gy = 2 * (cv - v0) / (ch - 1) - 1
    grid = torch.as_tensor(np.stack([gx, gy], -1).reshape(1, h, w, 2), dtype=torch.float32, device=device)
    return (cam["fx"], cam["fy"], cam["cx"] - u0, cam["cy"] - v0, cw, ch), grid


def make_inputs(config: dict, traffic: dict, seed: int, device, batch: int = 8) -> RigInputs:
    room = scene.make_room(config["room"]["half_extents"], config["room"]["clutter"])
    w = traffic["walk"]
    walk = scene.walk(traffic["lap_ticks"], w["radii"], w["height"])
    hz = float(traffic["clock_hz"])
    zed_ticks = traffic["zed_every"] * np.arange(traffic["zed_pairs"])
    l515_ticks = traffic["l515_first"] + traffic["l515_every"] * np.arange(traffic["l515_frames"])
    left, right, rot, trans, (zw, zh) = calibration(config)
    raw_T_rect = np.eye(4)
    raw_T_rect[:3, :3] = rig.rectification(left, right, rot, trans, (zw, zh))[0].T
    right_T_left = np.eye(4)
    right_T_left[:3, :3], right_T_left[:3, 3] = rig.rodrigues(rot), trans
    left_T_right = np.linalg.inv(right_T_left)
    rect_T_l515 = np.linalg.inv(l515_T_zed(config))
    at = lambda tk: walk[np.asarray(tk) % traffic["lap_ticks"]]

    gen = torch.Generator(device=device)
    gen.manual_seed(scene.seed_bits(seed + 1))
    render_s = 0.0

    # the ZED: raw pairs side by side
    n = len(zed_ticks)
    zed_raw = np.empty((n, zh, 2 * zw, 3), np.uint8)
    views = [(_raw_sampler(cam, (zw, zh), device), T) for cam, T in ((left, np.eye(4)), (right, left_T_right))]
    sigma = float(config["zed"]["pixel_noise"])
    for lo in range(0, n, batch):
        t = time.perf_counter()
        wTl = at(zed_ticks[lo:lo + batch])
        halves = []
        for (canvas, grid), T in views:
            wTc = torch.as_tensor(wTl @ T, dtype=torch.float64, device=device)
            img, _ = scene.render(room, wTc, *canvas, depth=False)
            x = F.grid_sample(img.permute(0, 3, 1, 2).float(), grid.expand(len(wTc), -1, -1, -1),
                              mode="bilinear", padding_mode="border", align_corners=True)
            x = x + sigma * torch.randn(x.shape, generator=gen, device=device)
            halves.append(torch.round(x).clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1))
        zed_raw[lo:lo + batch] = torch.cat(halves, dim=2).cpu().numpy()
        render_s += time.perf_counter() - t

    # the L515: colour and z16 depth aligned to it
    l5 = config["l515"]
    m = len(l515_ticks)
    l515_rgb = np.empty((m, l5["height"], l5["width"], 3), np.uint8)
    l515_z16 = np.empty((m, l5["height"], l5["width"]), np.uint16)
    shift = 1.0 / float(l5["depth_scale"])
    for lo in range(0, m, batch):
        t = time.perf_counter()
        wTc = torch.as_tensor(at(l515_ticks[lo:lo + batch]) @ raw_T_rect @ rect_T_l515, dtype=torch.float64,
                              device=device)
        rgb, z = scene.render(room, wTc, l5["fx"], l5["fy"], l5["cx"], l5["cy"], l5["width"], l5["height"])
        noise = torch.randn(z.shape, generator=gen, device=device, dtype=torch.float32)
        raw = scene.sensor_depth(z, noise, float(l5["noise_per_m2"]), shift)
        l515_rgb[lo:lo + batch] = rgb.cpu().numpy()
        l515_z16[lo:lo + batch] = raw.cpu().numpy().astype(np.uint16)
        render_s += time.perf_counter() - t

    return RigInputs(zed_raw=zed_raw, zed_t=zed_ticks / hz, zed_truth=at(zed_ticks) @ raw_T_rect,
                     l515_rgb=l515_rgb, l515_z16=l515_z16, l515_t=l515_ticks / hz, render_s=render_s)
