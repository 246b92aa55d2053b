"""Synthetic RGB-D scenes with analytic ground truth (numpy copy of
`ra_slam_tpu/io/synthetic.py`).

A colored axis-aligned box room rendered by exact ray-box intersection,
with a parametric orbit trajectory: pixel-perfect depth and pose ground
truth with no dataset download. The code is the JAX package's, line for
line, so both packages render the same frames; only the camera type is
the port's. It is host-side numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ra_slam_tpu_torch.core.camera import PinholeCamera
from ra_slam_tpu_torch.io.dataset import Frame, RGBDDataset

# Per-face wall colors (+x, -x, +y, -y, +z, -z), and which faces are
# "high-touch" for semantic GT (the +x wall plays the role of the
# reference's high-touch class).
_FACE_COLORS = np.array(
    [
        [200, 60, 60],  # +x  (high touch)
        [60, 200, 60],  # -x
        [60, 60, 200],  # +y
        [200, 200, 60],  # -y
        [200, 60, 200],  # +z
        [60, 200, 200],  # -z
    ],
    dtype=np.float32,
)
_FACE_HT = np.array([0.95, 0.05, 0.05, 0.05, 0.05, 0.05], dtype=np.float32)


def look_at(eye: np.ndarray, target: np.ndarray, up=(0.0, -1.0, 0.0)) -> np.ndarray:
    """world_T_cam (camera-to-world) 4x4 for a camera at `eye` looking at
    `target`. Camera convention: +z forward, +x right, +y down (OpenCV)."""
    fwd = np.asarray(target, np.float64) - np.asarray(eye, np.float64)
    fwd = fwd / np.linalg.norm(fwd)
    upv = np.asarray(up, np.float64)
    right = np.cross(-upv, fwd)  # x = (-up) x z for y-down convention
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    m = np.eye(4)
    m[:3, 0] = right
    m[:3, 1] = down
    m[:3, 2] = fwd
    m[:3, 3] = eye
    return m.astype(np.float32)


def _clutter_boxes(n: int, half_extents: np.ndarray, seed: int = 1234):
    """[n] seeded axis-aligned clutter boxes (lo [n,3], hi [n,3], color
    [n,3], ht [n]) standing on the floor inside the room, kept clear of
    the orbit-camera region (|x|,|z| > 1.4)."""
    rng = np.random.default_rng(seed)
    he = np.asarray(half_extents, np.float64)
    lo, hi = [], []
    for _ in range(n):
        size = rng.uniform(0.25, 0.8, 3)
        # place against walls-ish, outside the camera orbit (radius ~1)
        ang = rng.uniform(0, 2 * np.pi)
        r = rng.uniform(1.6, 0.92 * min(he[0], he[2]))
        cx_, cz_ = r * np.cos(ang), r * np.sin(ang)
        cy_ = he[1] - size[1]  # stand on the floor (+y is down)
        lo.append([cx_ - size[0], cy_ - size[1], cz_ - size[2]])
        hi.append([cx_ + size[0], cy_ + size[1], cz_ + size[2]])
    color = rng.uniform(60, 220, (max(n, 1), 3)).astype(np.float32)
    ht = (rng.random(max(n, 1)) < 0.3).astype(np.float32) * 0.9 + 0.05
    return (
        np.asarray(lo, np.float64).reshape(-1, 3),
        np.asarray(hi, np.float64).reshape(-1, 3),
        color,
        ht.astype(np.float32),
    )


def render_box_room(
    cam: "SyntheticCameraSpec",
    world_T_cam: np.ndarray,
    half_extents: np.ndarray,
    checker: float = 0.5,
    clutter: int = 0,
    clutter_seed: int = 1234,
):
    """Exact render of the inside of an axis-aligned box centered at the
    origin, optionally with `clutter` seeded interior boxes (occlusions,
    depth discontinuities, silhouette parallax — the failure modes flat
    walls cannot exercise). Returns (rgb uint8 [H,W,3], depth float32
    [H,W] z-meters, ht float32 [H,W], lt float32 [H,W])."""
    H, W = cam.height, cam.width
    u = np.arange(W, dtype=np.float64)[None, :].repeat(H, 0)
    v = np.arange(H, dtype=np.float64)[:, None].repeat(W, 1)
    # camera-frame ray with z=1 so the intersection parameter IS the z-depth
    d_cam = np.stack(
        [(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy, np.ones_like(u)], axis=-1
    )
    R = world_T_cam[:3, :3].astype(np.float64)
    o = world_T_cam[:3, 3].astype(np.float64)
    d_world = d_cam @ R.T  # [H, W, 3]

    he = np.asarray(half_extents, np.float64)
    # slab exit parameter per axis (camera is inside the box)
    with np.errstate(divide="ignore", invalid="ignore"):
        t_pos = (he[None, None] - o) / d_world
        t_neg = (-he[None, None] - o) / d_world
    t_exit = np.where(d_world > 0, t_pos, t_neg)
    t_exit = np.where(np.abs(d_world) < 1e-12, np.inf, t_exit)
    axis = np.argmin(t_exit, axis=-1)  # which wall
    t = np.take_along_axis(t_exit, axis[..., None], axis=-1)[..., 0]
    sign_pos = np.take_along_axis(d_world, axis[..., None], axis=-1)[..., 0] > 0
    face = axis * 2 + (~sign_pos).astype(np.int64)  # (+x,-x,+y,-y,+z,-z)

    hit = o + t[..., None] * d_world
    # Per-cell pseudo-random shading in the two in-plane coordinates.
    # NOT a binary checkerboard on purpose: FAST-9/16 cannot fire on
    # checkerboard X-junctions (two bright + two dark arcs of ~8 circle
    # pixels each, never 9 contiguous), so a checker room is effectively
    # textureless to the frontend. Hashed cell intensities make every
    # cell junction an L-corner between >=3 distinct levels, which FAST
    # detects and ORB matches view-consistently.
    a1 = np.take_along_axis(hit, ((axis + 1) % 3)[..., None], -1)[..., 0]
    a2 = np.take_along_axis(hit, ((axis + 2) % 3)[..., None], -1)[..., 0]
    i1 = np.floor(a1 / checker).astype(np.int64)
    i2 = np.floor(a2 / checker).astype(np.int64)
    h = (i1 * 73856093) ^ (i2 * 19349663) ^ (face * 83492791)
    h = (h ^ (h >> 13)) * 1274126177
    shade = 0.45 + 0.55 * (((h ^ (h >> 16)) & 0xFF).astype(np.float64) / 255.0)

    rgbf = _FACE_COLORS[face] * shade[..., None]
    depth = t.astype(np.float32)
    ht = _FACE_HT[face].astype(np.float32)

    if clutter > 0:
        lo, hi, ccol, cht = _clutter_boxes(clutter, half_extents, clutter_seed)
        for b in range(clutter):
            # slab test, camera OUTSIDE the box: entry = max per-axis
            # near plane, exit = min far plane
            with np.errstate(divide="ignore", invalid="ignore"):
                t1 = (lo[b][None, None] - o) / d_world
                t2 = (hi[b][None, None] - o) / d_world
            tnear = np.minimum(t1, t2)
            tfar = np.maximum(t1, t2)
            t_in = tnear.max(axis=-1)
            t_out = tfar.min(axis=-1)
            bhit = (t_in > 1e-6) & (t_in <= t_out) & (t_in < depth)
            if not bhit.any():
                continue
            ax_in = np.argmax(tnear, axis=-1)
            p_hit = o + t_in[..., None] * d_world
            b1 = np.take_along_axis(p_hit, ((ax_in + 1) % 3)[..., None], -1)[..., 0]
            b2 = np.take_along_axis(p_hit, ((ax_in + 2) % 3)[..., None], -1)[..., 0]
            j1 = np.floor(b1 / 0.12).astype(np.int64)
            j2 = np.floor(b2 / 0.12).astype(np.int64)
            hh = (j1 * 73856093) ^ (j2 * 19349663) ^ ((b + 7) * 83492791)
            hh = (hh ^ (hh >> 13)) * 1274126177
            bshade = 0.45 + 0.55 * (((hh ^ (hh >> 16)) & 0xFF) / 255.0)
            rgbf = np.where(
                bhit[..., None], ccol[b][None, None] * bshade[..., None], rgbf
            )
            depth = np.where(bhit, t_in, depth).astype(np.float32)
            ht = np.where(bhit, cht[b], ht).astype(np.float32)

    rgb = rgbf.clip(0, 255).astype(np.uint8)
    lt = (1.0 - ht).astype(np.float32)
    return rgb, depth, ht.astype(np.float32), lt


@dataclasses.dataclass(frozen=True)
class SyntheticCameraSpec:
    fx: float = 320.0
    fy: float = 320.0
    cx: float = 319.5
    cy: float = 239.5
    width: int = 640
    height: int = 480


class SyntheticBoxDataset(RGBDDataset):
    """Orbit inside a colored box room.

    The camera circles the room center at `radius`, always looking at the
    wall it faces (outward), covering all four side walls over one loop.
    """

    def __init__(
        self,
        num_frames: int = 60,
        cam: SyntheticCameraSpec = SyntheticCameraSpec(),
        half_extents=(3.0, 2.0, 3.0),
        radius: float = 1.0,
        fps: float = 30.0,
        depth_noise: float = 0.0,
        seed: int = 0,
        clutter: int = 0,
        depth_dropout: float = 0.0,  # fraction of pixels zeroed per frame
        depth_quant: float = 0.0,  # disparity-style step: dz = q * z^2
        exposure_drift: float = 0.0,  # peak relative per-frame gain
        yaw_sweep: float = 0.0,  # rad of extra look-direction sweep
    ):
        self.num_frames = num_frames
        self.spec = cam
        self.half_extents = np.asarray(half_extents, np.float32)
        self.radius = radius
        self.fps = fps
        self.depth_noise = depth_noise
        self.seed = seed
        self.clutter = clutter
        self.depth_dropout = depth_dropout
        self.depth_quant = depth_quant
        self.exposure_drift = exposure_drift
        self.yaw_sweep = yaw_sweep
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self.num_frames

    @property
    def camera(self) -> PinholeCamera:
        s = self.spec
        return PinholeCamera.create(s.fx, s.fy, s.cx, s.cy, s.width, s.height)

    def world_T_cam(self, idx: int) -> np.ndarray:
        ang = 2.0 * np.pi * idx / self.num_frames
        eye = np.array(
            [self.radius * np.cos(ang), 0.0, self.radius * np.sin(ang)]
        )
        look = ang
        if self.yaw_sweep > 0.0:
            # rotation-dominant segment: during the third quarter of the
            # orbit the look direction additionally sweeps +-yaw_sweep
            # (pure-rotation stress; translation-only parallax vanishes)
            ph = idx / self.num_frames
            if 0.5 <= ph < 0.75:
                look = ang + self.yaw_sweep * np.sin(
                    2.0 * np.pi * (ph - 0.5) / 0.25
                )
        target = eye + np.array([np.cos(look), 0.0, np.sin(look)])
        return look_at(eye, target)

    def frame(self, idx: int) -> Frame:
        wTc = self.world_T_cam(idx)
        rgb, depth, ht, lt = render_box_room(
            self.spec, wTc, self.half_extents,
            clutter=self.clutter, clutter_seed=1234 + 7 * self.seed,
        )
        if self.depth_noise > 0:
            rng = np.random.default_rng(idx * 7919 + 13 + self.seed)
            depth = depth + rng.normal(0, self.depth_noise, depth.shape).astype(
                np.float32
            ) * depth
        if self.depth_quant > 0:
            # disparity-style quantization: step grows with z^2 (the
            # structured-light / stereo sensor model)
            dq = self.depth_quant * np.maximum(depth, 1e-3) ** 2
            depth = (np.round(depth / dq) * dq).astype(np.float32)
        if self.depth_dropout > 0:
            rng = np.random.default_rng(idx * 104729 + 31 + self.seed)
            drop = rng.random(depth.shape) < self.depth_dropout
            depth = np.where(drop, 0.0, depth).astype(np.float32)
        if self.exposure_drift > 0:
            gain = 1.0 + self.exposure_drift * np.sin(
                2.0 * np.pi * 3.0 * idx / self.num_frames
            )
            rgb = np.clip(rgb.astype(np.float32) * gain, 0, 255).astype(
                np.uint8
            )
        cTw = np.linalg.inv(wTc.astype(np.float64)).astype(np.float32)
        return Frame(
            frame_id=idx,
            timestamp=idx / self.fps,
            rgb=rgb,
            depth=depth,
            cam_T_world=cTw,
            ht=ht,
            lt=lt,
        )
