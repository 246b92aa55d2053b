"""Fixed-capacity keyframe database (counterpart of
`ra_slam_tpu/slam/keyframes.py`): poses, per-keyframe observations
(landmark id, pixel, weight, measured depth), descriptors, and the mean
±1 descriptor embedding that loop retrieval and relocalization score,
and `refresh_observations`, the repair of stored rows after a map
correction.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from ra_slam_tpu_torch.core.se3 import SE3
from ra_slam_tpu_torch.features.matching import unpack_pm1


@dataclass(frozen=True)
class Keyframes:
    R: torch.Tensor  # [K, 3, 3] cam_T_world rotation
    t: torch.Tensor  # [K, 3]
    valid: torch.Tensor  # [K] bool
    frame_id: torch.Tensor  # [K] int32 source frame
    timestamp: torch.Tensor  # [K] float32 seconds
    obs_lm: torch.Tensor  # [K, F] int32 landmark index (-1 = none)
    obs_uv: torch.Tensor  # [K, F, 2] float32 pixel
    obs_w: torch.Tensor  # [K, F] float32 weight (0 = invalid slot)
    obs_z: torch.Tensor  # [K, F] float32 measured depth (0 = none)
    desc: torch.Tensor  # [K, F, 8] int32 feature descriptors
    embed: torch.Tensor  # [K, 256] float32 mean ±1 descriptor

    @property
    def capacity(self) -> int:
        return self.R.shape[0]

    @property
    def num_features(self) -> int:
        return self.obs_lm.shape[1]

    def pose(self, k) -> SE3:
        return SE3(self.R[k], self.t[k])


def create_keyframes(capacity: int, num_features: int, device) -> Keyframes:
    K, F = capacity, num_features
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return Keyframes(
        R=torch.eye(3, **f32).expand(K, 3, 3).contiguous(),
        t=torch.zeros(K, 3, **f32),
        valid=torch.zeros(K, dtype=torch.bool, device=device),
        frame_id=torch.full((K,), -1, **i32),
        timestamp=torch.zeros(K, **f32),
        obs_lm=torch.full((K, F), -1, **i32),
        obs_uv=torch.zeros(K, F, 2, **f32),
        obs_w=torch.zeros(K, F, **f32),
        obs_z=torch.zeros(K, F, **f32),
        desc=torch.zeros(K, F, 8, **i32),
        embed=torch.zeros(K, 256, **f32),
    )


def set_row(x: torch.Tensor, slot: torch.Tensor, value) -> torch.Tensor:
    """A copy of x with row `slot` (a 0-dim device tensor) set to `value`,
    as a tensor-indexed write that does not wait for the device."""
    v = torch.as_tensor(value, dtype=x.dtype, device=x.device).expand(x.shape[1:])
    return x.index_put((slot.reshape(1).long(),), v[None])


def insert_keyframe(
    kfs: Keyframes,
    slot: torch.Tensor,  # int32 insertion slot (= kf counter)
    pose: SE3,
    frame_id: torch.Tensor,
    timestamp: torch.Tensor,
    obs_lm: torch.Tensor,  # [F] int32
    obs_uv: torch.Tensor,  # [F, 2]
    obs_w: torch.Tensor,  # [F]
    desc: torch.Tensor,  # [F, 8] int32
    obs_z: Optional[torch.Tensor] = None,  # [F] measured depth (0 = none)
) -> Keyframes:
    """A copy of `kfs` with one keyframe written at `slot`."""
    used = obs_w > 0
    wsum = torch.clamp(used.sum(), min=1)
    embed = torch.where(used[:, None], unpack_pm1(desc), 0.0).sum(dim=0) / wsum
    if obs_z is None:
        obs_z = torch.zeros_like(obs_w)
    return Keyframes(
        R=set_row(kfs.R, slot, pose.R),
        t=set_row(kfs.t, slot, pose.t),
        valid=set_row(kfs.valid, slot, True),
        frame_id=set_row(kfs.frame_id, slot, frame_id),
        timestamp=set_row(kfs.timestamp, slot, timestamp),
        obs_lm=set_row(kfs.obs_lm, slot, obs_lm),
        obs_uv=set_row(kfs.obs_uv, slot, obs_uv),
        obs_w=set_row(kfs.obs_w, slot, obs_w),
        obs_z=set_row(kfs.obs_z, slot, obs_z),
        desc=set_row(kfs.desc, slot, desc),
        embed=set_row(kfs.embed, slot, embed),
    )


def num_keyframes(kfs: Keyframes) -> torch.Tensor:
    return kfs.valid.sum(dtype=torch.int32)


def refresh_observations(kfs: Keyframes, lms, cam, gate_px: float, mode: int):
    """Repair stored observation rows that disagree with the corrected
    landmark sheet: every live row is re-projected, and a row off by
    more than `gate_px` (or behind the camera) is

      mode=1 ("drop"):    de-weighted (obs_w = 0);
      mode=2 ("refresh"): re-measured as the predicted pixel and depth
                          (a row behind the camera drops).

    Returns (kfs, n_repaired)."""
    lm = torch.clamp(kfs.obs_lm, min=0).long()
    p = torch.einsum("kij,kfj->kfi", kfs.R, lms.pos[lm]) + kfs.t[:, None, :]
    z = p[..., 2]
    ok_z = z > 1e-6
    zs = torch.where(ok_z, z, 1.0)
    u = p[..., 0] / zs * cam.fx + cam.cx
    v = p[..., 1] / zs * cam.fy + cam.cy
    err = torch.hypot(u - kfs.obs_uv[..., 0], v - kfs.obs_uv[..., 1])
    live = (kfs.obs_w > 0) & (kfs.obs_lm >= 0) & lms.valid[lm] & kfs.valid[:, None]
    stale = live & (~ok_z | (err > gate_px))
    n = stale.sum(dtype=torch.int32)
    if mode == 1:
        return dataclasses.replace(kfs, obs_w=torch.where(stale, 0.0, kfs.obs_w)), n
    had_z = kfs.obs_z > 1e-6
    return dataclasses.replace(
        kfs,
        obs_uv=torch.where(stale[..., None], torch.stack([u, v], dim=-1), kfs.obs_uv),
        obs_z=torch.where(stale & had_z & ok_z, z, kfs.obs_z),
        obs_w=torch.where(stale & ~ok_z, 0.0, kfs.obs_w),
    ), n
