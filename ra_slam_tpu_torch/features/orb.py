"""Oriented BRIEF (ORB) keypoints + descriptors (counterpart of
`ra_slam_tpu/features/orb.py`).

Pyramid FAST, intensity-centroid orientation, steered BRIEF over a fixed
seeded 256-pair pattern, per-level quotas.

The JAX package cuts each level into 48x48 tiles and resolves every
keypoint's circle and pattern samples inside its tile with one-hot
matrix products (`_patch_features`), because element gathers are slow
on a TPU. Every sample there is the blurred level at a clamped integer
pixel, so the port reads that pixel directly. The reference takes its
values rounded to bf16 (the tile goes through the matrix unit in bf16),
and the port does the same: descriptors compare bf16-rounded blurred
values, and the centroid moments sum bf16 pixels in float32.

Descriptors are [K, 8] 32-bit words carried as int32 bit patterns (the
JAX package's uint32 words viewed as int32).

On a CUDA device `detect_and_describe` replays a CUDA graph: its body
is a pure function of the image whose shapes are fixed by the image's
shape and the `FeatureConfig`, and which reads nothing back to the host,
so every call issues the same ~3000 small launches in the same order.
The first call for an (image shape, dtype, config, device) runs the body
once on a side stream (the lazy uploads and workspaces), then captures
it into a static input and static outputs; every call copies its image
in, replays, and returns clones of the outputs. The replay runs the very
kernels the eager body launches, in the same order on the same values,
so its keypoints equal the eager body's bit for bit. The counters
`orb.graph_captures` and `orb.graph_replays` (`GRAPH_CAPTURES`,
`GRAPH_REPLAYS`) say how often it engages; on the CPU the eager body
runs and neither moves.
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass, fields
from typing import Dict, Tuple

import numpy as np
import torch

from ra_slam_tpu_torch.core.camera import to_i32
from ra_slam_tpu_torch.core.config import FeatureConfig
from ra_slam_tpu_torch.features.fast import fast_corners
from ra_slam_tpu_torch.features.pyramid import build_pyramid, gaussian_blur, rgb_to_gray
from ra_slam_tpu_torch.utils.profiling import TRACE

PATCH_RADIUS = 15  # 31x31 orientation / descriptor patch
NUM_PAIRS = 256
DESC_WORDS = 8  # 256 bits packed into 8 x 32-bit words

GRAPH_CAPTURES = 0  # CUDA graphs of the body captured (one per key)
GRAPH_REPLAYS = 0  # calls served by a graph's replay
TRACE.expose("orb.graph_captures", lambda: GRAPH_CAPTURES)
TRACE.expose("orb.graph_replays", lambda: GRAPH_REPLAYS)


@dataclass(frozen=True)
class Keypoints:
    """Fixed-capacity keypoint set for one image; uv in full-resolution
    pixels, desc [K, 8] int32 bit patterns, valid masks real detections."""

    uv: torch.Tensor  # [K, 2] float32
    level: torch.Tensor  # [K] int32
    score: torch.Tensor  # [K] float32
    angle: torch.Tensor  # [K] float32 radians
    desc: torch.Tensor  # [K, 8] int32
    valid: torch.Tensor  # [K] bool

    @property
    def capacity(self) -> int:
        return self.uv.shape[0]


@functools.lru_cache()
def _pattern() -> np.ndarray:
    """[256, 4] int32 (x1, y1, x2, y2) BRIEF test pairs."""
    rng = np.random.default_rng(8571)
    sigma = PATCH_RADIUS / 1.5
    pts = rng.normal(0.0, sigma, size=(NUM_PAIRS, 4))
    return np.clip(np.round(pts), -PATCH_RADIUS + 1, PATCH_RADIUS - 1).astype(np.int32)


@functools.lru_cache()
def _centroid_offsets() -> Tuple[np.ndarray, np.ndarray]:
    """(xs, ys) int32 offsets of the radius-15 circular patch."""
    ys, xs = np.mgrid[-PATCH_RADIUS : PATCH_RADIUS + 1, -PATCH_RADIUS : PATCH_RADIUS + 1]
    inside = xs**2 + ys**2 <= PATCH_RADIUS**2
    return xs[inside].astype(np.int32), ys[inside].astype(np.int32)


@functools.lru_cache(maxsize=None)
def _device_pattern(device: torch.device) -> torch.Tensor:
    """`_pattern()` as float32 on `device`, uploaded once (a copy from the
    host may not run inside a graph's capture)."""
    return torch.from_numpy(_pattern()).to(device, torch.float32)


@functools.lru_cache(maxsize=None)
def _device_centroid_offsets(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """`_centroid_offsets()` on `device`, uploaded once."""
    return tuple(torch.from_numpy(a).to(device) for a in _centroid_offsets())


def _gather(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Clamped 2-D gather of img [H, W] at int coords (any shape)."""
    H, W = img.shape
    return img[torch.clamp(y, 0, H - 1).long(), torch.clamp(x, 0, W - 1).long()]


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[K, 256] bool -> [K, 8] int32 words, bit i of word w = pair 32w+i.
    Packed in int64, then narrowed to the int32 bit pattern."""
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = (bits.reshape(-1, DESC_WORDS, 32).to(torch.int64) << shifts).sum(dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def orientation(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle (rad) of keypoints uv [K, 2] on img."""
    xs, ys = _device_centroid_offsets(img.device)
    xi = to_i32(torch.round(uv[:, 0]))[:, None] + xs[None]
    yi = to_i32(torch.round(uv[:, 1]))[:, None] + ys[None]
    vals = _gather(img, xi, yi)  # [K, P]
    m10 = torch.sum(vals * xs[None].to(torch.float32), dim=1)
    m01 = torch.sum(vals * ys[None].to(torch.float32), dim=1)
    return torch.atan2(m01, m10)


def orb_descriptors(img_blur: torch.Tensor, uv: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Steered-BRIEF descriptors [K, 8] int32 of keypoints on one
    pre-smoothed level."""
    pat = _device_pattern(img_blur.device)
    ca = torch.cos(angle)[:, None]
    sa = torch.sin(angle)[:, None]
    px = torch.cat([pat[:, 0], pat[:, 2]])  # [512]: first then second points
    py = torch.cat([pat[:, 1], pat[:, 3]])
    rx = ca * px[None] - sa * py[None]  # [K, 512]
    ry = sa * px[None] + ca * py[None]
    x = to_i32(torch.round(uv[:, 0:1] + rx))
    y = to_i32(torch.round(uv[:, 1:2] + ry))
    vals = _gather(img_blur, x, y)
    return pack_bits(vals[:, :NUM_PAIRS] < vals[:, NUM_PAIRS:])


def _patch_features(img_blur: torch.Tensor, uv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Orientation + steered BRIEF as the JAX package's `_patch_features`
    computes them: both read the blurred level rounded to bf16."""
    blur_bf = img_blur.to(torch.bfloat16).to(torch.float32)
    angle = orientation(blur_bf, uv)
    return angle, orb_descriptors(blur_bf, uv, angle)


def level_quotas(cfg: FeatureConfig) -> list:
    """Per-level keypoint quotas: geometric (1/s)^l weighting, min 16."""
    inv = [1.0 / (cfg.scale_factor**l) for l in range(cfg.num_levels)]
    total = sum(inv)
    return [max(int(round(cfg.max_num_keypoints * w / total)), 16) for w in inv]


def keypoint_capacity(cfg: FeatureConfig) -> int:
    """The fixed Keypoints capacity: the sum of the level quotas."""
    return sum(level_quotas(cfg))


def detect_and_describe(gray: torch.Tensor, cfg: FeatureConfig) -> Keypoints:
    """ORB on one [H, W] float32 grayscale image: pyramid -> FAST ->
    orientation -> steered BRIEF, `keypoint_capacity(cfg)` slots. On a
    CUDA device a replay of the body's graph for this shape and config."""
    if gray.device.type != "cuda":
        return _detect(gray, cfg)
    return _replay(gray, cfg)


def _detect(gray: torch.Tensor, cfg: FeatureConfig) -> Keypoints:
    """The body of `detect_and_describe`, eager."""
    with TRACE.span("orb.pyramid"):
        levels = build_pyramid(gray, cfg.num_levels, cfg.scale_factor)
    with TRACE.span("orb.levels"):
        parts = []
        for lvl, (img, quota) in enumerate(zip(levels, level_quotas(cfg))):
            uv, score, valid = fast_corners(
                img, float(cfg.ini_fast_threshold), quota,
                min_threshold=float(cfg.min_fast_threshold),
                cell_size=int(cfg.cell_size),
            )
            ang, desc = _patch_features(gaussian_blur(img), uv)
            level = torch.full((quota,), lvl, dtype=torch.int32, device=gray.device)
            parts.append((uv * cfg.scale_factor**lvl, level, score, ang, desc, valid))
        return Keypoints(*(torch.cat(list(p)) for p in zip(*parts)))


@dataclass(frozen=True)
class _Graph:
    """One captured body: its graph, static input and static outputs."""

    graph: "torch.cuda.CUDAGraph"
    gray: torch.Tensor
    out: Keypoints


# graphs by (device, dtype, shape, config); the lock also orders the
# static buffers' use between threads
_GRAPHS: Dict[tuple, _Graph] = {}
_GRAPHS_LOCK = threading.Lock()


def _capture(gray: torch.Tensor, cfg: FeatureConfig) -> _Graph:
    """Warm the body on a side stream, then capture it on that stream.
    "thread_local": another thread's launches and allocations (`live.run`
    fuses on one) may go on during the capture."""
    static = torch.empty(gray.shape, dtype=gray.dtype, device=gray.device)
    static.copy_(gray)
    side = torch.cuda.Stream(gray.device)
    side.wait_stream(torch.cuda.current_stream(gray.device))
    with torch.cuda.stream(side):
        _detect(static, cfg)
    torch.cuda.current_stream(gray.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
        out = _detect(static, cfg)
    return _Graph(graph, static, out)


def _replay(gray: torch.Tensor, cfg: FeatureConfig) -> Keypoints:
    """Copy `gray` into the key's graph (captured on the first call),
    replay it on the current stream, and clone its outputs: a caller may
    keep one frame's keypoints while the next frame is detected."""
    global GRAPH_CAPTURES, GRAPH_REPLAYS
    key = (gray.device, gray.dtype, tuple(gray.shape), cfg)
    with _GRAPHS_LOCK, torch.cuda.device(gray.device):
        g = _GRAPHS.get(key)
        if g is None:
            g = _GRAPHS[key] = _capture(gray, cfg)
            GRAPH_CAPTURES += 1
        with TRACE.span("orb.replay"):
            g.gray.copy_(gray)
            g.graph.replay()
            GRAPH_REPLAYS += 1
            return Keypoints(*(getattr(g.out, f.name).clone() for f in fields(Keypoints)))


def detect_and_describe_rgb(rgb: torch.Tensor, cfg: FeatureConfig) -> Keypoints:
    """ORB on one [H, W, 3] (0..255) colour image."""
    return detect_and_describe(rgb_to_gray(rgb), cfg)
