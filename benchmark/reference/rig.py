"""The robot's rig in plain numpy and PyTorch: the ZED's rectification,
the pose hand-off from its tracked poses to the L515's frames, and an
L515 frame as the map takes it. Nothing here imports the program.

Rectification (float64 numpy, then the float32 maps): Bouguet's method
with zero disparity, as OpenCV's `stereoRectify(..., CALIB_ZERO_DISPARITY,
alpha=0)` defines it. Each camera turns half the calibration's rotation,
then both turn so that the baseline lies on x. The focal length is the
mean of the two fy. The principal point is where the undistorted,
rotated image corners centre, averaged over the two cameras. Then the
scale that keeps only valid pixels (alpha 0): the largest at which the
inner rectangle of a 9 x 9 grid over each image, undistorted and
rotated, covers the whole image (the grid is OpenCV's definition of
"valid"). Points are undistorted by OpenCV's five fixed-point
iterations. The map of a rectified pixel is its ray, turned back and
distorted (k1, k2, p1, p2, k3), in the raw camera's pixels; the raw
image is sampled there bilinearly in float32, 0 outside, rounded half to
even (`remap`). `maps_dtype=torch.bfloat16` is the control: each map
coordinate rounded to bfloat16.

The pose hand-off (float64): the tracked poses registered before a
depth frame, found around its timestamp (the first at or after it and
the one before, clamped at the ends), their rotations slerped and their
translations interpolated linearly, then composed with the extrinsics
(`l515_T_zed @ cam_T_world`). `control=True` rounds every input and the
result to bfloat16.

An L515 frame: z16 depth times the depth scale in float32 (metres, as
the camera hands it over), both images resized to the map's feed size
as `disinfect_slam.cc:37-40` does: colour by `cv2.resize(INTER_LINEAR)`,
depth by `INTER_NEAREST`. The intrinsics scale with the image
(fx sx, cx sx). The UNet (`reference/unet.py`) takes sizes that are
multiples of 32: the frame is padded with zeros below and to the right,
and the maps cropped back. TF32 is off: the UNet runs under
`unet.float32_exact`, and nothing else here multiplies matrices on the
card.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from benchmark.reference import unet

UNDISTORT_ITERATIONS = 5  # OpenCV's undistortPoints criteria


def rodrigues(r) -> np.ndarray:
    r = np.asarray(r, np.float64).reshape(3)
    th = float(np.linalg.norm(r))
    if th == 0.0:
        return np.eye(3)
    k = r / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + math.sin(th) * K + (1 - math.cos(th)) * (K @ K)


def k_matrix(cam: dict) -> np.ndarray:
    return np.array([[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]], [0, 0, 1]], np.float64)


def _coeffs(D) -> np.ndarray:
    k = np.zeros(5)
    k[:len(D)] = np.asarray(D, np.float64)[:5]
    return k


def distort(x, y, D):
    """The raw camera's normalised coordinates of undistorted (x, y)."""
    k1, k2, p1, p2, k3 = _coeffs(D)
    r2 = x * x + y * y
    radial = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
    return (x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x),
            y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y)


def undistort(pts: np.ndarray, K: np.ndarray, D, iterations: int = UNDISTORT_ITERATIONS) -> np.ndarray:
    """[N, 2] raw pixels -> [N, 2] undistorted normalised coordinates, by
    the fixed-point iteration x = (x_d - tangential(x)) / radial(x)."""
    k1, k2, p1, p2, k3 = _coeffs(D)
    xd = (pts[:, 0] - K[0, 2]) / K[0, 0]
    yd = (pts[:, 1] - K[1, 2]) / K[1, 1]
    x, y = xd.copy(), yd.copy()
    for _ in range(iterations):
        r2 = x * x + y * y
        radial = 1 + r2 * (k1 + r2 * (k2 + r2 * k3))
        x, y = ((xd - (2 * p1 * x * y + p2 * (r2 + 2 * x * x))) / radial,
                (yd - (p1 * (r2 + 2 * y * y) + 2 * p2 * x * y)) / radial)
    return np.stack([x, y], -1)


def _project(R: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """Normalised (x, y) turned by R, projected to z = 1."""
    p = np.concatenate([xy, np.ones((len(xy), 1))], 1) @ R.T
    return p[:, :2] / p[:, 2:3]


def rectification(left: dict, right: dict, rotation, translation, size: Tuple[int, int]):
    """(R1, R2, P1, P2) of a calibrated pair: each R turns the raw
    camera's coordinates into the rectified camera's, each P [3, 4]
    projects the rectified camera's (P2 with -fx * baseline in [0, 3])."""
    w, h = size
    K1, K2 = k_matrix(left), k_matrix(right)
    D1, D2 = left["distortion"], right["distortion"]
    om = np.asarray(rotation, np.float64)
    half = rodrigues(-0.5 * om)
    t = half @ np.asarray(translation, np.float64)
    e = np.array([1.0 if t[0] > 0 else -1.0, 0.0, 0.0])  # the baseline onto x
    axis = np.cross(t, e)
    n = np.linalg.norm(axis)
    turn = rodrigues(axis / n * math.acos(abs(t[0]) / np.linalg.norm(t))) if n > 0 else np.eye(3)
    R1, R2 = turn @ half.T, turn @ half
    t2 = R2 @ np.asarray(translation, np.float64)
    f = 0.5 * (K1[1, 1] + K2[1, 1])
    corners = np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]], np.float64)
    centres = [np.array([(w - 1) / 2, (h - 1) / 2]) - f * _project(R, undistort(corners, K, D)).mean(0)
               for K, D, R in ((K1, D1, R1), (K2, D2, R2))]
    c = 0.5 * (centres[0] + centres[1])
    # alpha 0: the largest scale at which each image's inner rectangle covers it
    g = 9
    gx, gy = np.meshgrid(np.arange(g) * (w - 1) / (g - 1), np.arange(g) * (h - 1) / (g - 1))
    grid = np.stack([gx.ravel(), gy.ravel()], -1)
    s = -np.inf
    for K, D, R in ((K1, D1, R1), (K2, D2, R2)):
        p = (f * _project(R, undistort(grid, K, D)) + c).reshape(g, g, 2)
        x0, x1 = p[:, 0, 0].max(), p[:, g - 1, 0].min()
        y0, y1 = p[0, :, 1].max(), p[g - 1, :, 1].min()
        s = max(s, c[0] / (c[0] - x0), c[1] / (c[1] - y0), (w - 1 - c[0]) / (x1 - c[0]), (h - 1 - c[1]) / (y1 - c[1]))
    f *= s
    P1 = np.array([[f, 0, c[0], 0], [0, f, c[1], 0], [0, 0, 1, 0]], np.float64)
    P2 = P1.copy()
    P2[0, 3] = f * t2[0]
    return R1, R2, P1, P2


def rectify_maps(cam: dict, R: np.ndarray, P: np.ndarray, size: Tuple[int, int]):
    """float32 (map_x, map_y) [h, w]: the raw pixel of each rectified pixel."""
    w, h = size
    u, v = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    ray = np.stack([(u - P[0, 2]) / P[0, 0], (v - P[1, 2]) / P[1, 1], np.ones_like(u)], -1) @ R  # R.T applied
    xd, yd = distort(ray[..., 0] / ray[..., 2], ray[..., 1] / ray[..., 2], cam["distortion"])
    return (cam["fx"] * xd + cam["cx"]).astype(np.float32), (cam["fy"] * yd + cam["cy"]).astype(np.float32)


def remap(img: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor, maps_dtype=torch.float32) -> torch.Tensor:
    """uint8 [h, w, C] of a uint8 [H, W, C] image sampled bilinearly at
    the maps (float32, on the image's device); 0 outside the image."""
    mx, my = map_x.to(maps_dtype).float(), map_y.to(maps_dtype).float()
    H, W = img.shape[:2]
    x0, y0 = torch.floor(mx), torch.floor(my)
    ax, ay = (mx - x0)[..., None], (my - y0)[..., None]
    src = img.float()

    def tap(dy, dx):
        xi, yi = (x0 + dx).long(), (y0 + dy).long()
        inside = ((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H))[..., None]
        return torch.where(inside, src[yi.clamp(0, H - 1), xi.clamp(0, W - 1)], 0.0)

    out = ((1 - ay) * ((1 - ax) * tap(0, 0) + ax * tap(0, 1))
           + ay * ((1 - ax) * tap(1, 0) + ax * tap(1, 1)))
    return torch.round(out).clamp(0, 255).to(torch.uint8)


# --- the pose hand-off

def quat(R: np.ndarray) -> np.ndarray:
    """(w, x, y, z) of a rotation matrix (Shepperd's method)."""
    tr = np.trace(R)
    if tr > 0:
        s = 2 * math.sqrt(tr + 1)
        q = [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s]
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2 * math.sqrt(1 + R[i, i] - R[j, j] - R[k, k])
        q = [0.0] * 4
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    q = np.asarray(q)
    return q / np.linalg.norm(q)


def quat_matrix(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def slerp(q0: np.ndarray, q1: np.ndarray, u: float) -> np.ndarray:
    d = float(q0 @ q1)
    if d < 0:  # the shorter way round
        q1, d = -q1, -d
    if d > 1 - 1e-12:
        q = (1 - u) * q0 + u * q1
        return q / np.linalg.norm(q)
    th = math.acos(d)
    return (math.sin((1 - u) * th) * q0 + math.sin(u * th) * q1) / math.sin(th)


def _bf16(a):
    from benchmark.reference.track import bf16

    return bf16(np.asarray(a, np.float64))


def handoff(stamps: Sequence[float], poses: Sequence[np.ndarray], t: float, l515_T_zed: np.ndarray,
            control: bool = False) -> np.ndarray:
    """[4, 4] cam_T_world of a depth frame at `t`: the tracked poses
    `poses` (cam_T_world [4, 4]) at the ascending `stamps` interpolated
    at t, then composed with the extrinsics."""
    r = (lambda a: _bf16(a)) if control else (lambda a: np.asarray(a, np.float64))
    i = int(np.searchsorted(np.asarray(stamps), t, side="left"))
    if i == 0 or i == len(stamps):
        m = r(poses[0 if i == 0 else -1])
    else:
        t0, t1 = stamps[i - 1], stamps[i]
        u = (t - t0) / (t1 - t0) if t1 > t0 else 0.0
        a, b = r(poses[i - 1]), r(poses[i])
        m = np.eye(4)
        m[:3, :3] = r(quat_matrix(slerp(quat(a[:3, :3]), quat(b[:3, :3]), u)))
        m[:3, 3] = r((1 - u) * a[:3, 3] + u * b[:3, 3])
    return r(r(l515_T_zed) @ m)


# --- an L515 frame as the map takes it

def l515_frame(rgb: np.ndarray, z16: np.ndarray, depth_scale: float, size: Tuple[int, int],
               control: bool = False):
    """(colour uint8 [h, w, 3], depth float32 metres [h, w]) at the map's
    feed size `size` = (w, h); `control`: 7-bit colour, bfloat16 depth."""
    import cv2

    depth = z16.astype(np.float32) * np.float32(depth_scale)
    colour = cv2.resize(rgb, size, interpolation=cv2.INTER_LINEAR)
    depth = cv2.resize(depth, size, interpolation=cv2.INTER_NEAREST)
    if control:
        colour = (colour & 0xFE).astype(np.uint8)
        depth = torch.from_numpy(depth).to(torch.bfloat16).float().numpy()
    return colour, depth


def scaled_intrinsics(cam: dict, size: Tuple[int, int]):
    """(fx, fy, cx, cy) of `cam` at the image size `size` = (w, h)."""
    sx, sy = size[0] / cam["width"], size[1] / cam["height"]
    return cam["fx"] * sx, cam["fy"] * sy, cam["cx"] * sx, cam["cy"] * sy


def segment(weights, rgb: torch.Tensor, levels: int, conv_dtype=None):
    """(ht, lt) [h, w] of a uint8 [h, w, 3] frame of any size: padded with
    zeros to multiples of 32 for `unet.segment`, then cropped."""
    h, w = rgb.shape[:2]
    ph, pw = -(-h // 32) * 32, -(-w // 32) * 32
    padded = torch.zeros((ph, pw, 3), dtype=torch.uint8, device=rgb.device)
    padded[:h, :w] = rgb
    ht, lt = unet.segment(weights, padded, levels, conv_dtype=conv_dtype)
    return ht[:h, :w], lt[:h, :w]
