"""Stereo rectification without OpenCV (counterpart of
`ra_slam_tpu/core/rectify.py`).

The JAX package builds its maps with cv2 and rectifies with `cv2.remap`.
Here the same functions are written out:

- `rodrigues` / `rodrigues_vector`: `cv2.Rodrigues` both ways, float64;
- `undistort_points`: `cv2.undistortPoints` (5 fixed-point iterations of
  the inverse distortion, then R and the new camera matrix), float64;
- `stereo_rectify`: `cv2.stereoRectify(..., flags=CALIB_ZERO_DISPARITY,
  alpha=0, newImageSize=img_size)`, Bouguet's method: half the rotation
  to each camera, then the rotation that lays the baseline on x; the
  focal length the mean fy, the principal points from the projected
  undistorted corners, averaged; then the scale that keeps only valid
  pixels (alpha 0), from the inner rectangle of a 9x9 grid over
  (0 .. w-1, 0 .. h-1) undistorted in float64, as OpenCV 5 does;
- `init_undistort_rectify_map`: `cv2.initUndistortRectifyMap(...,
  CV_32FC1)`, float64 then float32;
- `remap_linear`: `cv2.remap(img, mx, my, INTER_LINEAR)` on uint8 with
  the constant border 0, as OpenCV 5 computes it: the map's floor and
  float32 fraction, the two row interpolations and the column one each a
  fused multiply-add rounded once to float32 (emulated in float64, where
  the product of two float32 values is exact), rounded half to even. The
  gathers and sums run on the tensor's device, so the card and the CPU
  agree exactly.

`StereoRectifier` keeps the JAX class's interface: `from_yaml` reads the
flat `Calibration.*` keys through `utils/flat_yaml.py` (PyYAML only for
a file with nested sections), and, where a file
has `Calibration.baseline` but no `Calibration.translation`, as
`io/capture.py:calib_to_yaml` writes them, takes right_t_left =
[-baseline, 0, 0]; `rectify` takes and returns numpy arrays (computed on
the rectifier's device) or tensors (on their own device);
`rewrite_camera_config` puts the rectified intrinsics into a
`SystemConfig`. `rectify` reports to `utils/profiling.py:TRACE`: the
span `rectify.remap` (the upload and both remaps), on the numpy path the
wait `rectify.to_host` (the copy back), and the counter `rectify.calls`
(`CALLS`, pairs rectified).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from ra_slam_tpu_torch.core.camera import PinholeCamera
from ra_slam_tpu_torch.utils.profiling import TRACE

UNDISTORT_ITERATIONS = 5  # cv2.undistortPoints' default criteria (COUNT, 5)


@dataclasses.dataclass(frozen=True)
class CalibMono:
    fx: float
    fy: float
    cx: float
    cy: float
    distortion: List[float]  # k1 k2 p1 p2 [k3]


@dataclasses.dataclass(frozen=True)
class CalibStereo:
    left: CalibMono
    right: CalibMono
    rotation: List[float]  # Rodrigues vector, right_R_left
    translation: List[float]  # right_t_left (meters)


CALLS = 0  # pairs `StereoRectifier.rectify` rectified
TRACE.expose("rectify.calls", lambda: CALLS)


def _k_matrix(c: CalibMono) -> np.ndarray:
    return np.array([[c.fx, 0, c.cx], [0, c.fy, c.cy], [0, 0, 1]], np.float64)


def rodrigues(rvec) -> np.ndarray:
    """3x3 rotation of a rotation vector (`cv2.Rodrigues`)."""
    r = np.asarray(rvec, np.float64).reshape(3)
    theta = float(np.sqrt(r @ r))
    if theta < np.finfo(np.float64).eps:
        return np.eye(3)
    c, s = np.cos(theta), np.sin(theta)
    rx, ry, rz = r / theta
    rrt = np.array([[rx * rx, rx * ry, rx * rz], [rx * ry, ry * ry, ry * rz], [rx * rz, ry * rz, rz * rz]])
    r_x = np.array([[0, -rz, ry], [rz, 0, -rx], [-ry, rx, 0]])
    return c * np.eye(3) + (1.0 - c) * rrt + s * r_x


def rodrigues_vector(R) -> np.ndarray:
    """Rotation vector of a 3x3 rotation (`cv2.Rodrigues`), after the same
    SVD re-orthogonalisation."""
    U, _, Vt = np.linalg.svd(np.asarray(R, np.float64))
    R = U @ Vt
    rx, ry, rz = R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]
    s = np.sqrt((rx * rx + ry * ry + rz * rz) * 0.25)
    c = float(np.clip((R[0, 0] + R[1, 1] + R[2, 2] - 1) * 0.5, -1.0, 1.0))
    theta = np.arccos(c)
    if s >= 1e-5:
        return np.array([rx, ry, rz]) * (theta / (2 * s))
    if c > 0:
        return np.zeros(3)
    raise ValueError("a rotation of about 180 degrees is no stereo calibration")


def undistort_points(pts, K, D, R=None, P=None) -> np.ndarray:
    """`cv2.undistortPoints(pts, K, D, R=R, P=P)` in float64: [N, 2]
    pixels -> [N, 2] (normalised without P, else P's pixels)."""
    pts = np.asarray(pts, np.float64).reshape(-1, 2)
    k = np.zeros(14)
    k[: len(D)] = np.asarray(D, np.float64)
    RR = np.eye(3) if R is None else np.asarray(R, np.float64)
    if P is not None:
        RR = np.asarray(P, np.float64)[:3, :3] @ RR
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    x0 = (pts[:, 0] - cx) * (1.0 / fx)
    y0 = (pts[:, 1] - cy) * (1.0 / fy)
    x, y = x0.copy(), y0.copy()
    done = np.zeros(len(pts), bool)
    for _ in range(UNDISTORT_ITERATIONS):
        r2 = x * x + y * y
        icdist = (1 + ((k[7] * r2 + k[6]) * r2 + k[5]) * r2) / (1 + ((k[4] * r2 + k[1]) * r2 + k[0]) * r2)
        # where the distortion model inverts, cv2 stops at the normalised input
        bad = (icdist < 0) & ~done
        dx = 2 * k[2] * x * y + k[3] * (r2 + 2 * x * x) + k[8] * r2 + k[9] * r2 * r2
        dy = k[2] * (r2 + 2 * y * y) + 2 * k[3] * x * y + k[10] * r2 + k[11] * r2 * r2
        x = np.where(done, x, np.where(bad, x0, (x0 - dx) * icdist))
        y = np.where(done, y, np.where(bad, y0, (y0 - dy) * icdist))
        done |= bad
    xx = RR[0, 0] * x + RR[0, 1] * y + RR[0, 2]
    yy = RR[1, 0] * x + RR[1, 1] * y + RR[1, 2]
    ww = 1.0 / (RR[2, 0] * x + RR[2, 1] * y + RR[2, 2])
    return np.stack([xx * ww, yy * ww], -1)


def _inner_rectangle(K, D, R, P, width, height, n=9):
    """(x, y, w, h) of the largest axis-aligned rectangle inside a 9x9
    grid over the image, undistorted and rectified into P's pixels."""
    xs = np.arange(n) * (width - 1) / (n - 1.0)
    ys = np.arange(n) * (height - 1) / (n - 1.0)
    gx, gy = np.meshgrid(xs, ys)
    p = undistort_points(np.stack([gx.ravel(), gy.ravel()], -1), K, D, R, P).reshape(n, n, 2)
    ix0, ix1 = p[:, 0, 0].max(), p[:, n - 1, 0].min()
    iy0, iy1 = p[0, :, 1].max(), p[n - 1, :, 1].min()
    return ix0, iy0, ix1 - ix0, iy1 - iy0


def stereo_rectify(K1, D1, K2, D2, img_size: Tuple[int, int], R, T):
    """(R1, R2, P1, P2, Q) of `cv2.stereoRectify(K1, D1, K2, D2, img_size,
    R, T, flags=CALIB_ZERO_DISPARITY, alpha=0, newImageSize=img_size)`;
    `R` a 3x3 rotation or a rotation vector."""
    nx, ny = img_size
    K1, K2 = np.asarray(K1, np.float64), np.asarray(K2, np.float64)
    T = np.asarray(T, np.float64).reshape(3)
    R = np.asarray(R, np.float64)
    om = rodrigues_vector(R) if R.shape == (3, 3) else R.reshape(3)
    r_r = rodrigues(om * -0.5)  # each camera turns half way
    t = r_r @ T
    idx = 0 if abs(t[0]) > abs(t[1]) else 1  # horizontal stereo
    c, nt = t[idx], np.linalg.norm(t)
    if not nt > 0:
        raise ValueError("stereo translation must not be zero")
    uu = np.zeros(3)
    uu[idx] = 1 if c > 0 else -1
    ww = np.cross(t, uu)  # the rotation that lays the baseline on the axis
    nw = np.linalg.norm(ww)
    if nw > 0:
        ww = ww * (np.arccos(abs(c) / nt) / nw)
    wR = rodrigues(ww)
    R1, R2 = wR @ r_r.T, wR @ r_r
    t = R2 @ T

    ratio = (nx / nx if idx == 1 else ny / ny) / 2
    fc = (K1[idx ^ 1, idx ^ 1] + K2[idx ^ 1, idx ^ 1]) * ratio
    corners = np.array([[0, 0], [nx - 1, 0], [0, ny - 1], [nx - 1, ny - 1]], np.float64)
    cc = np.zeros((2, 2))
    for k, (K, D, Rk) in enumerate(((K1, D1, R1), (K2, D2, R2))):
        u = undistort_points(corners.astype(np.float32), K, D).astype(np.float32)
        p3 = np.concatenate([u, np.ones((4, 1), np.float32)], 1).astype(np.float64) @ Rk.T
        proj = (p3[:, :2] * (1.0 / p3[:, 2:3]) * fc).astype(np.float32).astype(np.float64)
        cc[k] = ((nx - 1) / 2 - proj[:, 0].mean(), (ny - 1) / 2 - proj[:, 1].mean())
    cc[:] = (cc[0] + cc[1]) * 0.5  # CALIB_ZERO_DISPARITY: one principal point

    P1 = np.zeros((3, 4))
    P1[0, 0] = P1[1, 1] = fc
    P1[:2, 2], P1[2, 2] = cc[0], 1.0
    P2 = P1.copy()
    P2[:2, 2] = cc[1]
    P2[idx, 3] = t[idx] * fc
    inner = [_inner_rectangle(K, D, Rk, P, nx, ny) for K, D, Rk, P in ((K1, D1, R1, P1), (K2, D2, R2, P2))]
    # alpha = 0: the largest scale at which the inner rectangles cover the image
    s = -np.inf
    for (cx0, cy0), (ix, iy, iw, ih) in zip(cc, inner):
        cx, cy = nx * cx0 / nx, ny * cy0 / ny
        s = max(s, cx / (cx0 - ix), cy / (cy0 - iy), (nx - 1 - cx) / (ix + iw - cx0), (ny - 1 - cy) / (iy + ih - cy0))
    fc *= s
    cx1, cy1, cx2, cy2 = nx * cc[0, 0] / nx, ny * cc[0, 1] / ny, nx * cc[1, 0] / nx, ny * cc[1, 1] / ny
    P1[0, 0] = P1[1, 1] = P2[0, 0] = P2[1, 1] = fc
    P1[:2, 2], P2[:2, 2] = (cx1, cy1), (cx2, cy2)
    P2[idx, 3] = s * P2[idx, 3]
    Q = np.array([
        [1, 0, 0, -cx1],
        [0, 1, 0, -cy1],
        [0, 0, 0, fc],
        [0, 0, -1.0 / t[idx], (cx1 - cx2 if idx == 0 else cy1 - cy2) / t[idx]],
    ])
    return R1, R2, P1, P2, Q


def init_undistort_rectify_map(K, D, R, P, img_size: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """`cv2.initUndistortRectifyMap(K, D, R, P, img_size, CV_32FC1)`: the
    float32 source x and y of every rectified pixel, [h, w] each."""
    w, h = img_size
    K = np.asarray(K, np.float64)
    k = np.zeros(8)
    k[: len(D)] = np.asarray(D, np.float64)[:8]
    iR = np.linalg.inv(np.asarray(P, np.float64)[:3, :3] @ np.asarray(R, np.float64))
    i = np.arange(h, dtype=np.float64)[:, None]
    j = np.arange(w, dtype=np.float64)[None, :]
    _x = i * iR[0, 1] + iR[0, 2] + j * iR[0, 0]
    _y = i * iR[1, 1] + iR[1, 2] + j * iR[1, 0]
    inv_w = 1.0 / (i * iR[2, 1] + iR[2, 2] + j * iR[2, 0])
    x, y = _x * inv_w, _y * inv_w
    x2, y2 = x * x, y * y
    r2, _2xy = x2 + y2, 2 * x * y
    k1, k2, p1, p2, k3, k4, k5, k6 = k
    kr = (1 + ((k3 * r2 + k2) * r2 + k1) * r2) / (1 + ((k6 * r2 + k5) * r2 + k4) * r2)
    xd = x * kr + p1 * _2xy + p2 * (r2 + 2 * x2)
    yd = y * kr + p1 * (r2 + 2 * y2) + p2 * _2xy
    return (K[0, 0] * xd + K[0, 2]).astype(np.float32), (K[1, 1] * yd + K[1, 2]).astype(np.float32)


@dataclasses.dataclass
class RemapPlan:
    """The source taps of a float32 map pair, on one device: flat indices
    of the four neighbours [4, N] (clamped), whether each lies inside the
    source [4, N], and the float32 fractions as float64 [N]."""

    index: torch.Tensor
    inside: torch.Tensor
    ax: torch.Tensor
    ay: torch.Tensor
    shape: Tuple[int, int]  # output (h, w)
    src: Tuple[int, int]  # source (h, w)


def remap_plan(map_x: torch.Tensor, map_y: torch.Tensor, src_hw: Tuple[int, int]) -> RemapPlan:
    """Plan `remap_linear` of a [Hs, Ws] source through float32 maps [h, w]."""
    hs, ws = src_hw
    mx, my = map_x.to(torch.float32).reshape(-1), map_y.to(torch.float32).reshape(-1)
    x0, y0 = torch.floor(mx), torch.floor(my)
    ax, ay = (mx - x0).to(torch.float64), (my - y0).to(torch.float64)
    sx, sy = x0.to(torch.int64), y0.to(torch.int64)
    index, inside = [], []
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        xx, yy = sx + dx, sy + dy
        inside.append((xx >= 0) & (xx < ws) & (yy >= 0) & (yy < hs))
        index.append(yy.clamp(0, hs - 1) * ws + xx.clamp(0, ws - 1))
    return RemapPlan(torch.stack(index), torch.stack(inside), ax, ay, tuple(map_x.shape), (hs, ws))


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).to(torch.float64)


def remap_linear(img: torch.Tensor, plan: RemapPlan) -> torch.Tensor:
    """`cv2.remap(img, map_x, map_y, INTER_LINEAR)` of a uint8 [Hs, Ws] or
    [Hs, Ws, C] image, border constant 0, on `img`'s device."""
    if img.dtype != torch.uint8 or img.ndim not in (2, 3) or tuple(img.shape[:2]) != plan.src:
        raise ValueError(f"remap_linear takes a uint8 {plan.src} image, got {img.dtype} {tuple(img.shape)}")
    flat = img.reshape(plan.src[0] * plan.src[1], -1)
    v = flat[plan.index].to(torch.float64)  # [4, N, C]
    v = torch.where(plan.inside[..., None], v, 0.0)
    ax, ay = plan.ax[:, None], plan.ay[:, None]
    # each a fused multiply-add: the float32 product is exact in float64
    top = _f32(v[0] + ax * (v[1] - v[0]))
    bot = _f32(v[2] + ax * (v[3] - v[2]))
    r = _f32(top + ay * _f32(bot - top))
    out = torch.round(r).clamp(0, 255).to(torch.uint8)
    return out.reshape(*plan.shape, *img.shape[2:])


class StereoRectifier:
    """Undistort/rectify maps of a calibrated stereo pair, the rectified
    pinhole intrinsics and fx * baseline."""

    def __init__(self, img_size: Tuple[int, int], calib: CalibStereo, device="cuda"):
        """img_size = (width, height)."""
        from ra_slam_tpu_torch.pipeline.system import resolve_device

        self.device = resolve_device(device)
        K_l, K_r = _k_matrix(calib.left), _k_matrix(calib.right)
        D_l, D_r = calib.left.distortion, calib.right.distortion
        R = rodrigues(calib.rotation)
        R_l, R_r, P_l, P_r, Q = stereo_rectify(K_l, D_l, K_r, D_r, img_size, R, calib.translation)
        self.cam_rect_matrix = P_r  # rectified 3x4 (the reference keeps P_r)
        self.reproj_mat = Q
        self.img_size = img_size
        self.maps = (init_undistort_rectify_map(K_l, D_l, R_l, P_l, img_size),
                     init_undistort_rectify_map(K_r, D_r, R_r, P_r, img_size))
        self._plans: Dict[str, Tuple[RemapPlan, RemapPlan]] = {}

    @staticmethod
    def from_yaml(path: str, device="cuda") -> "StereoRectifier":
        """The rectifier of a YAML file's `Camera.cols/rows` and
        `Calibration.*` keys: a flat file needs no PyYAML; a system config
        with nested sections (`tsdf:`) is read with it, as
        `core/config.py:load_yaml_config` reads it."""
        from ra_slam_tpu_torch.utils.flat_yaml import FlatYamlError, load_flat_yaml

        with open(path) as f:
            text = f.read()
        try:
            node = load_flat_yaml(text)
        except FlatYamlError:
            import yaml

            node = yaml.safe_load(text)

        def mono(side):
            return CalibMono(
                fx=float(node[f"Calibration.{side}.fx"]), fy=float(node[f"Calibration.{side}.fy"]),
                cx=float(node[f"Calibration.{side}.cx"]), cy=float(node[f"Calibration.{side}.cy"]),
                distortion=[float(v) for v in node[f"Calibration.{side}.distortion"]],
            )

        if "Calibration.translation" in node:
            translation = [float(v) for v in node["Calibration.translation"]]
        else:
            translation = [-float(node["Calibration.baseline"]), 0.0, 0.0]
        calib = CalibStereo(left=mono("left"), right=mono("right"),
                            rotation=[float(v) for v in node["Calibration.rotation"]], translation=translation)
        return StereoRectifier((int(node["Camera.cols"]), int(node["Camera.rows"])), calib, device)

    def plans(self, device) -> Tuple[RemapPlan, RemapPlan]:
        """The left and right remap plans on `device` (built once each)."""
        device = torch.device(device)
        key = str(device)
        if key not in self._plans:
            hw = (self.img_size[1], self.img_size[0])
            self._plans[key] = tuple(
                remap_plan(torch.as_tensor(mx, device=device), torch.as_tensor(my, device=device), hw)
                for mx, my in self.maps)
        return self._plans[key]

    def rectify(self, img_l, img_r):
        """Rectified (left, right) uint8 images: numpy in, numpy out
        (computed on the rectifier's device), or tensors on their device."""
        global CALLS
        CALLS += 1
        if isinstance(img_l, torch.Tensor):
            with TRACE.span("rectify.remap"):
                plan_l, plan_r = self.plans(img_l.device)
                return remap_linear(img_l, plan_l), remap_linear(img_r.to(img_l.device), plan_r)
        with TRACE.span("rectify.remap"):
            plan_l, plan_r = self.plans(self.device)
            t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=self.device)
            out_l, out_r = remap_linear(t(img_l), plan_l), remap_linear(t(img_r), plan_r)
        with TRACE.wait("rectify.to_host"):
            return out_l.cpu().numpy(), out_r.cpu().numpy()

    @property
    def rectified_intrinsics(self) -> np.ndarray:
        """3x4 rectified projection (reference `RectifiedIntrinsics`)."""
        return np.asarray(self.cam_rect_matrix)

    @property
    def focal_x_baseline(self) -> float:
        """fx * baseline (meters * pixels): |P_r[0, 3]| = fx * b for the
        right camera with CALIB_ZERO_DISPARITY."""
        return float(abs(self.cam_rect_matrix[0, 3]))

    def rectified_camera(self) -> PinholeCamera:
        P = self.cam_rect_matrix
        return PinholeCamera.create(float(P[0, 0]), float(P[1, 1]), float(P[0, 2]), float(P[1, 2]),
                                    self.img_size[0], self.img_size[1])


def rewrite_camera_config(cfg, rectifier: StereoRectifier):
    """A SystemConfig whose camera block holds the rectified intrinsics and
    focal_x_baseline (reference `GetAndSetConfig`)."""
    P = rectifier.cam_rect_matrix
    cam = dataclasses.replace(
        cfg.camera, fx=float(P[0, 0]), fy=float(P[1, 1]), cx=float(P[0, 2]), cy=float(P[1, 2]),
        width=rectifier.img_size[0], height=rectifier.img_size[1],
        focal_x_baseline=rectifier.focal_x_baseline,
    )
    return dataclasses.replace(cfg, camera=cam)
