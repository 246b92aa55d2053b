"""Stereo keypoint depth from rectified image pairs (counterpart of
`ra_slam_tpu/features/stereo.py`, its keypoint half).

One left patch and one right epipolar strip per keypoint in a single
batched gather, all candidate ZNCC scores as one `[F, D]` tensor, the
best integer disparity refined by a parabola, depth = fx*baseline /
disparity. `sparse_depth_image` scatters the keypoint depths into an
image so stereo frames reuse the RGB-D landmark path.

Dense stereo depth (`dense_stereo_depth`, `census_transform`) belongs to
the camera layer and is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ra_slam_tpu_torch.slam.landmarks import scatter_rows


def _gather_patches(img: torch.Tensor, vi: torch.Tensor, ui: torch.Tensor, dy, dx) -> torch.Tensor:
    """img [H, W]; vi/ui [F]; dy [P]; dx [Q] -> patches [F, P, Q]."""
    H, W = img.shape
    vv = torch.clamp(vi[:, None, None] + dy[None, :, None], 0, H - 1)
    uu = torch.clamp(ui[:, None, None] + dx[None, None, :], 0, W - 1)
    return img[vv, uu]


def stereo_keypoint_depth(
    gray_l: torch.Tensor,  # [H, W] float32 rectified left
    gray_r: torch.Tensor,  # [H, W] float32 rectified right
    uv: torch.Tensor,  # [F, 2] left keypoint pixels
    valid: torch.Tensor,  # [F] bool
    focal_x_baseline: float,  # fx * baseline (pixel * meters)
    max_disparity: int = 64,
    patch: int = 7,
    min_zncc: float = 0.6,
    min_depth: float = 0.1,
    max_depth: float = 40.0,
    min_texture: float = 2.0,  # mean |horizontal gradient| gate
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-keypoint depth by epipolar ZNCC matching.

    Returns (depth [F] float32, 0 where invalid; valid [F] bool)."""
    H, W = gray_l.shape
    F = uv.shape[0]
    P, D = patch, max_disparity
    half = P // 2
    dev = uv.device
    ar = lambda a, b: torch.arange(a, b, device=dev)

    ui = torch.round(uv[:, 0]).to(torch.int64)
    vi = torch.round(uv[:, 1]).to(torch.int64)
    dx = ar(-half, half + 1)
    left = _gather_patches(gray_l, vi, ui, dx, dx)  # [F, P, P]
    # the right strip covers disparities 0..D-1: u' = u - d
    strip = _gather_patches(gray_r, vi, ui, dx, ar(-half - (D - 1), half + 1))  # [F, P, P+D-1]

    # window d takes strip columns (D-1) + half + dx - d
    cols = (D - 1) + half + dx[None, :] - ar(0, D)[:, None]  # [D, P]
    wins = strip[:, :, cols].movedim(2, 1)  # [F, D, P, P]

    lf = left.reshape(F, 1, P * P)
    rf = wins.reshape(F, D, P * P)
    lm = lf - lf.mean(-1, keepdim=True)
    rm = rf - rf.mean(-1, keepdim=True)
    num = torch.sum(lm * rm, -1)
    den = torch.sqrt(torch.sum(lm * lm, -1) * torch.sum(rm * rm, -1) + 1e-9)
    zncc = num / den  # [F, D]

    best = torch.argmax(zncc, dim=-1)  # [F], the first maximum
    score = torch.gather(zncc, -1, best[:, None])[:, 0]
    # subpixel parabola around the best integer disparity
    y0 = torch.gather(zncc, -1, torch.clamp(best - 1, 0, D - 1)[:, None])[:, 0]
    y2 = torch.gather(zncc, -1, torch.clamp(best + 1, 0, D - 1)[:, None])[:, 0]
    denom = y0 - 2 * score + y2
    delta = torch.where(denom.abs() > 1e-9, 0.5 * (y0 - y2) / denom, 0.0)
    disp = best.to(torch.float32) + torch.clamp(delta, -0.5, 0.5)

    depth = focal_x_baseline / torch.clamp(disp, min=1e-3)
    # aperture gate: without horizontal texture every shift matches
    h_grad = torch.mean((left[:, :, 1:] - left[:, :, :-1]).abs(), dim=(1, 2))
    ok = (
        valid
        & (h_grad >= min_texture)
        & (score >= min_zncc)
        & (best > 0)
        & (best < D - 1)
        & (depth > min_depth)
        & (depth < max_depth)
        # the strip must not have been clipped at the image border
        & (ui - (best + half) >= 0)
        & (ui + half < W)
        & (vi - half >= 0)
        & (vi + half < H)
    )
    return torch.where(ok, depth, 0.0), ok


def sparse_depth_image(
    uv: torch.Tensor,  # [F, 2]
    depth: torch.Tensor,  # [F]
    valid: torch.Tensor,  # [F] bool
    height: int,
    width: int,
) -> torch.Tensor:
    """Per-keypoint depths scattered into a [H, W] image (0 elsewhere;
    where two keypoints round to one pixel the later one wins)."""
    ui = torch.clamp(torch.round(uv[:, 0]).to(torch.int64), 0, width - 1)
    vi = torch.clamp(torch.round(uv[:, 1]).to(torch.int64), 0, height - 1)
    img = torch.zeros(height * width, dtype=torch.float32, device=uv.device)
    return scatter_rows(img, vi * width + ui, depth, valid).reshape(height, width)
