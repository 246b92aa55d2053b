"""A box room with clutter, rendered on the device, and the walks through it.

The benchmark's inputs are made here from `--seed` and nothing else. The
renderer is `ra_slam_tpu_torch/io/synthetic.py:render_box_room` (exact
ray-box intersection, hashed per-cell shading so that FAST finds corners)
rewritten in torch for the device, frames in batches: the room's walls,
then each clutter box by the slab test. The camera convention is
OpenCV's: +z forward, +x right, +y down.

The seed draws the sensor noise (and, elsewhere, the net's weights); the
room, its boxes and the walk are the same for every seed, so that every
seed asks for the same work: the clutter's texture sets how much work
tracking does, and a seed that moved it changed the work by up to a
sixth.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

# per-face colours (+x, -x, +y, -y, +z, -z)
FACE_COLORS = (
    (200, 60, 60), (60, 200, 60), (60, 60, 200),
    (200, 200, 60), (200, 60, 200), (60, 200, 200),
)


def seed_bits(seed: int) -> int:
    """A non-negative 63-bit generator seed from any whole `seed`."""
    return (int(seed) * 0x9E3779B97F4A7C15 + 0x632BE59BD9B4E019) % (1 << 63)


@dataclass(frozen=True)
class Room:
    half_extents: tuple  # (x, y, z) half sizes in metres; +y is down
    box_lo: np.ndarray  # [n, 3] clutter boxes
    box_hi: np.ndarray  # [n, 3]
    box_color: np.ndarray  # [n, 3]


LAYOUT_SEED = 1234  # the room's boxes: the same for every seed


def make_room(half_extents: Sequence[float], clutter: int) -> Room:
    """`clutter` boxes standing on the floor along the walls, clear of the
    middle of the room where the walks run; their sizes, colours and
    places are the same for every seed."""
    fixed = np.random.default_rng(LAYOUT_SEED)
    hx, hy, hz = (float(v) for v in half_extents)
    lo, hi = [], []
    for _ in range(clutter):
        size = fixed.uniform(0.12, 0.4, 3)  # half sizes
        wall, along, gap = fixed.integers(0, 4), fixed.uniform(-0.8, 0.8), fixed.uniform(0.05, 0.35)
        if wall < 2:  # the +-x walls
            cx = (1 if wall == 0 else -1) * (hx - gap - size[0])
            cz = along * (hz - size[2])
        else:
            cz = (1 if wall == 2 else -1) * (hz - gap - size[2])
            cx = along * (hx - size[0])
        cy = hy - size[1]
        lo.append([cx - size[0], cy - size[1], cz - size[2]])
        hi.append([cx + size[0], cy + size[1], cz + size[2]])
    color = fixed.uniform(60, 220, (clutter, 3))
    return Room((hx, hy, hz), np.asarray(lo, np.float64).reshape(-1, 3),
                np.asarray(hi, np.float64).reshape(-1, 3), color)


def look_at(eye: np.ndarray, fwd: np.ndarray, roll: float = 0.0) -> np.ndarray:
    """world_T_cam [4, 4] float64 of a camera at `eye` looking along `fwd`
    with world up -y, rolled by `roll` radians about its axis."""
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    c, s = math.cos(roll), math.sin(roll)
    right, down = c * right + s * down, -s * right + c * down
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, down, fwd, eye
    return m


def walk(frames: int, radii: Sequence[float], height: float) -> np.ndarray:
    """[frames, 4, 4] world_T_cam float64 of a handheld walk: an ellipse
    of `radii` (x, z) about the room's middle, once round in `frames`
    frames, looking outward, with a slow pitch and roll sway and a height
    bob. The same for every seed."""
    a, b = (float(r) for r in radii)
    ph = (0.7, 2.1, 4.0)  # phases of the bob, the pitch and the yaw sway
    out = []
    for i in range(frames):
        s = i / frames
        ang = 2 * math.pi * s
        eye = np.array([a * math.cos(ang), height + 0.04 * math.sin(2 * math.pi * 3 * s + ph[0]),
                        b * math.sin(ang)])
        pitch = 0.12 * math.sin(2 * math.pi * 2 * s + ph[1])
        yaw = ang + 0.25 * math.sin(2 * math.pi * 1.5 * s + ph[2])
        fwd = np.array([math.cos(yaw) * math.cos(pitch), math.sin(pitch), math.sin(yaw) * math.cos(pitch)])
        out.append(look_at(eye, fwd, roll=0.05 * math.sin(2 * math.pi * 2.5 * s + ph[0])))
    return np.stack(out)


def _hash_shade(a1: torch.Tensor, a2: torch.Tensor, tag: torch.Tensor, cell: float) -> torch.Tensor:
    i1 = torch.floor(a1 / cell).to(torch.int64)
    i2 = torch.floor(a2 / cell).to(torch.int64)
    h = (i1 * 73856093) ^ (i2 * 19349663) ^ (tag * 83492791)
    h = (h ^ (h >> 13)) * 1274126177
    return 0.45 + 0.55 * ((h ^ (h >> 16)) & 0xFF).to(a1.dtype) / 255.0


def render(room: Room, world_T_cam: torch.Tensor, fx: float, fy: float, cx: float, cy: float,
           width: int, height: int, colour: bool = True, depth: bool = True):
    """Render a batch of views [B, 4, 4] on their device, in float32.
    Returns (rgb uint8 [B, H, W, 3] or None, z-depth float32 [B, H, W] or
    None)."""
    dev = world_T_cam.device
    f32 = torch.float32
    world_T_cam = world_T_cam.to(f32)
    u = torch.arange(width, dtype=f32, device=dev)
    v = torch.arange(height, dtype=f32, device=dev)
    d_cam = torch.stack(torch.broadcast_tensors(
        ((u - cx) / fx)[None, :], ((v - cy) / fy)[:, None], torch.ones((1, 1), dtype=f32, device=dev)), -1)
    R = world_T_cam[:, :3, :3]
    o = world_T_cam[:, None, None, :3, 3]  # [B, 1, 1, 3]
    d = torch.einsum("bij,hwj->bhwi", R, d_cam)  # [B, H, W, 3]; t is the z-depth

    he = torch.tensor(room.half_extents, dtype=f32, device=dev)
    safe = torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
    t_exit = torch.where(d > 0, (he - o) / safe, (-he - o) / safe)
    t_exit = torch.where(d.abs() < 1e-12, torch.full_like(t_exit, float("inf")), t_exit)
    t, axis = t_exit.min(dim=-1)
    sign_pos = torch.gather(d, -1, axis[..., None])[..., 0] > 0
    face = axis * 2 + (~sign_pos).to(torch.int64)
    hit = o + t[..., None] * d
    a1 = torch.gather(hit, -1, ((axis + 1) % 3)[..., None])[..., 0]
    a2 = torch.gather(hit, -1, ((axis + 2) % 3)[..., None])[..., 0]
    shade = _hash_shade(a1, a2, face, 0.5)
    colors = torch.tensor(FACE_COLORS, dtype=f32, device=dev)
    rgbf = colors[face] * shade[..., None]

    lo = torch.as_tensor(room.box_lo, dtype=f32, device=dev)
    hi = torch.as_tensor(room.box_hi, dtype=f32, device=dev)
    bcol = torch.as_tensor(room.box_color, dtype=f32, device=dev)
    for b in range(lo.shape[0]):
        t1 = (lo[b] - o) / safe
        t2 = (hi[b] - o) / safe
        tnear, tfar = torch.minimum(t1, t2), torch.maximum(t1, t2)
        t_in, ax_in = tnear.max(dim=-1)
        t_out = tfar.min(dim=-1).values
        bhit = (t_in > 1e-6) & (t_in <= t_out) & (t_in < t)
        if colour:
            p = o + t_in[..., None] * d
            b1 = torch.gather(p, -1, ((ax_in + 1) % 3)[..., None])[..., 0]
            b2 = torch.gather(p, -1, ((ax_in + 2) % 3)[..., None])[..., 0]
            bshade = _hash_shade(b1, b2, torch.full_like(ax_in, b + 7), 0.12)
            rgbf = torch.where(bhit[..., None], bcol[b] * bshade[..., None], rgbf)
        t = torch.where(bhit, t_in, t)
    rgb = rgbf.clamp(0, 255).to(torch.uint8) if colour else None
    return rgb, (t.to(torch.float32) if depth else None)


def sensor_depth(z: torch.Tensor, gen: torch.Tensor, noise: float, shift: float) -> torch.Tensor:
    """Raw uint16 depth in 1/`shift` metres of z-depth `z` with axial noise
    `noise * z^2` (a structured-light sensor's); 0 beyond the uint16 range.
    `gen` is a standard normal draw of z's shape."""
    zn = z + noise * z * z * gen
    raw = torch.round(zn * shift)
    raw = torch.where((raw > 0) & (raw < 65535), raw, torch.zeros_like(raw))
    return raw.to(torch.int32)
